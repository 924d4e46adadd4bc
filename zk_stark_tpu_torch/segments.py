"""Device segments of the prover and verifier, captured once and replayed.

Counterpart of the JAX package's ``pooled_jit`` segments and their cache
(``stark.py`` ``_build_seg1``, ``_build_seg2``, ``_build_verify_seg``,
``_seg_cache_get``; ``fri.py`` ``_lowdeg_kernel``): there each segment is
compiled once per configuration and then dispatched as one program,
because "every dispatch pays host<->device latency".  Here a
:class:`Segment` wraps one body (a function of tensors that launches the
port's kernels) and its static input and output tensors.  On the card its
first call runs the body once on a side stream (the warm-up fills the
cached tables and runs each kernel's one-time attribute calls), captures
the body once as a CUDA graph, and replays it; every later call copies
its inputs into the static input buffers and replays the graph, so the
body's few hundred kernel launches cost one graph launch on the host.

A body must not synchronise with the host or upload from it (a capture
refuses both); every value that changes from call to call enters through
the inputs, and everything else it reads (tables, constants) is cached
and so reused by the graph at the same address.

The outputs are the same tensors at every call: a caller consumes them
before the same segment is called again.

On a CPU device a segment is the same object with the same static
buffers, and each call runs the body eagerly on them and copies its
results into the static outputs, so the CPU tests run the input plumbing,
the output aliasing and the cache keys; only capture and replay are the
card's.  There is no fallback: on the card a capture or a replay that
fails raises, and no body runs eagerly in place of its graph.  A segment
made with ``capture=False`` runs eagerly on the card as on the CPU.

A body may issue NCCL collectives (the prover's segments under the
distributed engine, ``parallel/engine.py``): the capture records them in
the graph with the kernels.  The segment's ``warm`` (the engine's) issues
one collective on the side stream before the warm-up run, so the
communicator is set up before the capture, and the collectives the
capture recorded (``parallel/collectives.py`` :func:`capturing`) are
counted again at every replay, as the kernels' launches are.  Such a
graph must not outlive its process group: :func:`release_collective_graphs`
(called by ``parallel.multihost.shutdown``) drops every one of them
first, and a segment whose graph was dropped captures anew at its next
call.
"""

from __future__ import annotations

import gc
import time
import weakref
from typing import Callable, Sequence

import torch

from .ops import _build
from .parallel import collectives

#: replays of every segment so far
replays = 0
#: the segments whose graphs hold collectives
_with_collectives: weakref.WeakSet = weakref.WeakSet()


def _flatten(values: Sequence) -> tuple[list[torch.Tensor], tuple]:
    """Tensors and lists of tensors -> (the tensors in order, the structure:
    None for a tensor, the length of a list)."""
    flat, spec = [], []
    for v in values:
        if isinstance(v, torch.Tensor):
            flat.append(v)
            spec.append(None)
        else:
            flat.extend(v)
            spec.append(len(v))
    return flat, tuple(spec)


def _unflatten(flat: Sequence[torch.Tensor], spec: tuple) -> list:
    out, i = [], 0
    for n in spec:
        if n is None:
            out.append(flat[i])
            i += 1
        else:
            out.append(list(flat[i : i + n]))
            i += n
    return out


class Segment:
    """One body, its static inputs and outputs, and on the card its graph.

    ``body(*inputs)`` takes tensors or lists of tensors and returns a tuple
    of tensors or lists of tensors.  Calls pass inputs of the first call's
    shapes and types, on any device (each is copied into its buffer)."""

    def __init__(self, name: str, body: Callable, device, capture: bool = True,
                 warm: Callable | None = None):
        self.name = name
        self.body = body
        self.device = torch.device(device)
        self.capture = capture
        self.warm = warm
        #: the collectives one replay issues, recorded at the capture
        self.collectives = collectives.Tally()
        self.inputs: list[torch.Tensor] | None = None
        self.outputs: list | None = None
        self._in_spec = self._out_spec = None
        self.graph: torch.cuda.CUDAGraph | None = None
        #: each kernel's launches in one replay, counted at the capture
        self.launches: dict[_build.Kernel, int] = {}
        #: host ms of the capture, and the device memory it reserved (the
        #: graph's pool)
        self.capture_ms: float | None = None
        self.pool_bytes: int | None = None

    def __call__(self, *args) -> tuple:
        flat, spec = _flatten(args)
        if self.inputs is None:
            self.inputs = [torch.empty(t.shape, dtype=t.dtype, device=self.device) for t in flat]
            self._in_spec = spec
        elif spec != self._in_spec or any(
                t.shape != b.shape or t.dtype != b.dtype for t, b in zip(flat, self.inputs)):
            raise ValueError(f"segment {self.name}: inputs differ from its static buffers")
        for buf, t in zip(self.inputs, flat):
            buf.copy_(t)
        static_args = _unflatten(self.inputs, spec)
        if self.device.type != "cuda" or not self.capture:
            self._run_eager(static_args)
        else:
            if self.graph is None:
                self._capture(static_args)
            self._replay()
        return tuple(_unflatten(self.outputs, self._out_spec))

    def _run_eager(self, args) -> None:
        out, spec = _flatten(self.body(*args))
        if self.outputs is None:
            self.outputs, self._out_spec = [t.clone() for t in out], spec
        else:
            for buf, t in zip(self.outputs, out):
                buf.copy_(t)

    def _capture(self, args) -> None:
        dev = self.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            if self.warm is not None:
                self.warm(dev)
            self.body(*args)
        torch.cuda.current_stream(dev).wait_stream(side)

        torch.cuda.synchronize(dev)
        # the graph's private pool takes new segments only, so the reserved
        # memory grows by the pool
        reserved = torch.cuda.memory_reserved(dev)
        before = [k.launches for k in _build.Kernel.instances]
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        with torch.cuda.stream(side), collectives.capturing() as issued:
            graph.capture_begin()
            try:
                out = self.body(*args)
            finally:
                graph.capture_end()
        self.collectives = issued
        self.capture_ms = (time.perf_counter() - t0) * 1e3
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        # the capture recorded these launches without making them: the
        # replays count them
        self.launches = {}
        for k, n in zip(_build.Kernel.instances, before):
            if k.launches != n:
                self.launches[k] = k.launches - n
                k.launches = n
        self.outputs, self._out_spec = _flatten(out)
        self.graph = graph
        if issued.events:
            _with_collectives.add(self)

    def _replay(self) -> None:
        global replays
        self.graph.replay()
        for k, n in self.launches.items():
            k.launches += n
        collectives.replay(self.collectives)
        replays += 1


def release_collective_graphs() -> None:
    """Drop every captured graph that holds collectives (NCCL's): the
    process group of such a graph hangs on its destruction while the graph
    lives.  Each of those segments captures anew at its next call."""
    for seg in list(_with_collectives):
        seg.graph = None
        seg.launches = {}
    _with_collectives.clear()
    gc.collect()


def cache_get(cache: dict, key: tuple, build: Callable[[], Segment]) -> Segment:
    """The segment of ``key`` in ``cache``, built on its first use."""
    seg = cache.get(key)
    if seg is None:
        seg = cache[key] = build()
    return seg
