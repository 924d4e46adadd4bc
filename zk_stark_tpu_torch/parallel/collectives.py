"""The collectives of the distributed prover, counted.

Every cross-rank exchange of :mod:`ntt_dist`, :mod:`engine` and the
prover's block-sharded code (``merkle.py``, ``fri.py``) goes through these
functions.  Each notes one event: its kind, the global ranks of its group,
and the size of the result it hands this rank, in bytes and in rows of 64
bytes (one field element, or one digest).  :data:`issued` counts the
events by (kind, ranks), so a test or ``chip_smoke.py`` can pin how many
exchanges an operation makes and over which ranks (the JAX package pins
them in the compiled HLO, ``tests/test_collectives.py``), and
:func:`record` collects the events of a block of code in a
:class:`Tally`, which sums their counts, bytes and largest result by
kind.  The kinds:

* ``all_to_all``: equal chunks to every rank (the transforms' transposes);
* ``permute``: rows moved from the ranks that hold them to the ranks that
  need them (:func:`permute`: a change of block length, a shift, the FRI
  fold's pairing; the counterpart of GSPMD's collective permute);
* ``all_gather``: every rank's tensor, in rank order, to every rank;
* ``broadcast``: group rank 0's tensor to every rank.

A segment captured as a CUDA graph (``segments.py``) records the events
its capture issued (:func:`capturing`) without counting them, and notes
them again at every replay (:func:`replay`), as kernels count their
launches.

A collective raises when its tensor's device does not suit the group's
backend: CUDA tensors need NCCL, and CPU tensors a CPU backend (gloo).
There is no copy to the other device.
"""

from __future__ import annotations

import collections
import contextlib
from typing import Sequence

import torch
import torch.distributed as dist

KINDS = ("all_to_all", "permute", "all_gather", "broadcast")
#: the bytes of a row: one field element in limbs, or one BLAKE2b digest
ROW_BYTES = 64

#: collectives issued so far, by (kind, global ranks of the group)
issued: collections.Counter = collections.Counter()

# all_gather_into_tensor was renamed all_gather_single (torch 2.13, where
# the old name warns); the same function under either name
_all_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


class Tally:
    """The events of a stretch of code: (kind, ranks, rows, bytes) each."""

    def __init__(self):
        self.events: list[tuple[str, tuple[int, ...], int, int]] = []

    def counts(self) -> dict[str, int]:
        out = dict.fromkeys(KINDS, 0)
        for kind, *_ in self.events:
            out[kind] += 1
        return out

    def received_bytes(self) -> dict[str, int]:
        out = dict.fromkeys(KINDS, 0)
        for kind, _, _, nbytes in self.events:
            out[kind] += nbytes
        return out

    def largest_rows(self) -> dict[str, int]:
        out = dict.fromkeys(KINDS, 0)
        for kind, _, rows, _ in self.events:
            out[kind] = max(out[kind], rows)
        return out


_recording: list[Tally] = []
#: the tally of a capture in progress: its events are kept, not counted
_capture: Tally | None = None


def _note(event: tuple[str, tuple[int, ...], int, int]) -> None:
    issued[event[:2]] += 1
    for t in _recording:
        t.events.append(event)


@contextlib.contextmanager
def record():
    """``with record() as t:`` collects in ``t`` (a :class:`Tally`) every
    collective issued or replayed inside the block."""
    t = Tally()
    _recording.append(t)
    try:
        yield t
    finally:
        _recording.remove(t)


@contextlib.contextmanager
def capturing():
    """``with capturing() as t:`` keeps the block's collectives in ``t``
    without counting them (a graph capture issues nothing yet); a replay of
    the graph counts them with :func:`replay`."""
    global _capture
    if _capture is not None:
        raise RuntimeError("capturing() does not nest")
    _capture = Tally()
    try:
        yield _capture
    finally:
        _capture = None


def replay(t: Tally) -> None:
    """Count the collectives of ``t`` once more (a graph replay)."""
    for event in t.events:
        _note(event)


def group_ranks(group) -> tuple[int, ...]:
    """The global ranks of ``group`` (the default group when None)."""
    return tuple(dist.get_process_group_ranks(group or dist.group.WORLD))


def require_backend(device: torch.device, backend: str) -> None:
    """Raise unless tensors on ``device`` can travel over ``backend``."""
    if (device.type == "cuda") != (backend == "nccl"):
        raise ValueError(
            f"a {device.type} tensor cannot be exchanged over the {backend} backend: "
            "CUDA tensors need an NCCL group and CPU tensors a gloo group"
        )


def _issue(kind: str, group, result: torch.Tensor, *tensors: torch.Tensor) -> None:
    backend = dist.get_backend(group)
    for t in (result,) + tensors:
        require_backend(t.device, backend)
    nbytes = result.numel() * result.element_size()
    event = (kind, group_ranks(group), -(-nbytes // ROW_BYTES), nbytes)
    if _capture is not None:
        _capture.events.append(event)
    else:
        _note(event)


def all_to_all(inp: torch.Tensor, group) -> torch.Tensor:
    """Chunk e of ``inp`` along dim 0 goes to rank e of the group; chunk e
    of the result comes from rank e."""
    inp = inp.contiguous()
    out = torch.empty_like(inp)
    _issue("all_to_all", group, out, inp)
    dist.all_to_all_single(out, inp, group=group)
    return out


def permute(inp: torch.Tensor, send_rows: Sequence[int], recv_rows: Sequence[int],
            group) -> torch.Tensor:
    """Uneven all-to-all: the first ``send_rows[0]`` rows of ``inp`` go to
    group rank 0, the next ``send_rows[1]`` to rank 1, and so on; the result
    holds ``recv_rows[e]`` rows from each rank e, in rank order."""
    inp = inp.contiguous()
    out = inp.new_empty((sum(recv_rows),) + tuple(inp.shape[1:]))
    _issue("permute", group, out, inp)
    dist.all_to_all_single(out, inp, list(recv_rows), list(send_rows), group=group)
    return out


def all_gather(inp: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``inp`` [m, ...], in rank order: [D * m, ...]."""
    inp = inp.contiguous()
    out = torch.empty((dist.get_world_size(group) * inp.shape[0],) + tuple(inp.shape[1:]),
                      dtype=inp.dtype, device=inp.device)
    _issue("all_gather", group, out, inp)
    _all_gather(out, inp, group=group)
    return out


def broadcast(t: torch.Tensor, group) -> None:
    """``t`` on every rank of the group takes the value of group rank 0's."""
    _issue("broadcast", group, t)
    dist.broadcast(t, src=dist.get_global_rank(group or dist.group.WORLD, 0), group=group)


def counts() -> dict[str, int]:
    """:data:`issued` summed over groups, by kind."""
    out = dict.fromkeys(KINDS, 0)
    for (kind, _), n in issued.items():
        out[kind] += n
    return out
