"""Stage timing and device traces.

Counterpart of the JAX package's ``utils/profiling.py``: a stage timer that
``Stark`` and ``FRI`` report their stages into (the optional ``timer``
attribute, the JAX package's stage names), and a trace of the card around
a block, on ``torch.profiler`` in place of ``jax.profiler``.
"""

from __future__ import annotations

import contextlib
import os
import pathlib
import time
from collections import defaultdict
from typing import Iterator, Optional

import torch
from torch.profiler import ProfilerActivity, profile


class StageTimer:
    """Accumulates wall time per named stage.

    Built with a CUDA ``device``, it synchronises that device before a stage
    starts and at its end, so a stage's time is the work it queued, not the
    launches alone.

    Usage::

        timer = StageTimer("cuda")
        with timer.stage("ntt"):
            ...
        print(timer.report())
    """

    def __init__(self, device=None) -> None:
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        device = None if device is None else torch.device(device)
        self._sync_device = device if device is not None and device.type == "cuda" else None

    def _sync(self) -> None:
        if self._sync_device is not None:
            torch.cuda.synchronize(self._sync_device)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        self._sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            lines.append(f"{name:<28s} {total * 1000:10.2f} ms  x{self.counts[name]}")
        return "\n".join(lines)


def stage(timer: Optional[StageTimer], name: str):
    """``timer.stage(name)``, or nothing when there is no timer."""
    return contextlib.nullcontext() if timer is None else timer.stage(name)


@contextlib.contextmanager
def device_trace(logdir: Optional[str] = None) -> Iterator[profile]:
    """Trace a block with ``torch.profiler`` (the host and, where there is a
    card, its kernels) and write it into ``logdir`` (``./torch_trace``
    unless given) as a Chrome trace, ``trace_<pid>_<ns>.json``, for
    ``chrome://tracing`` or Perfetto."""
    out = pathlib.Path(logdir or "./torch_trace")
    out.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(out / f"trace_{os.getpid()}_{time.time_ns()}.json"))
