"""The collectives of the distributed prover, counted.

Every cross-rank exchange of :mod:`ntt_dist` and :mod:`engine` goes
through these functions.  Each adds one to :data:`issued` under its name
and the global ranks of its group, so a test or ``chip_smoke.py`` can pin
how many exchanges an operation makes and over which ranks (the JAX
package pins them in the compiled HLO, ``tests/test_collectives.py``).

A collective raises when its tensor's device does not suit the group's
backend: CUDA tensors need NCCL, and CPU tensors a CPU backend (gloo).
There is no copy to the other device.
"""

from __future__ import annotations

import collections

import torch
import torch.distributed as dist

#: collectives issued so far, by (name, global ranks of the group)
issued: collections.Counter = collections.Counter()

# all_gather_into_tensor was renamed all_gather_single (torch 2.13, where
# the old name warns); the same function under either name
_all_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


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


def _issue(name: str, group, *tensors: torch.Tensor) -> None:
    backend = dist.get_backend(group)
    for t in tensors:
        require_backend(t.device, backend)
    issued[(name, group_ranks(group))] += 1


def all_to_all(inp: torch.Tensor, group) -> torch.Tensor:
    """Chunk e of ``inp`` along dim 0 goes to rank e of the group; chunk e
    of the result comes from rank e."""
    inp = inp.contiguous()
    out = torch.empty_like(inp)
    _issue("all_to_all", group, inp)
    dist.all_to_all_single(out, inp, group=group)
    return out


def all_gather(inp: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``inp`` [m, ...], in rank order: [D * m, ...]."""
    inp = inp.contiguous()
    out = torch.empty((dist.get_world_size(group) * inp.shape[0],) + tuple(inp.shape[1:]),
                      dtype=inp.dtype, device=inp.device)
    _issue("all_gather", group, inp)
    _all_gather(out, inp, group=group)
    return out


def broadcast(t: torch.Tensor, group) -> None:
    """``t`` on every rank of the group takes the value of group rank 0's."""
    _issue("broadcast", group, t)
    dist.broadcast(t, src=dist.get_global_rank(group or dist.group.WORLD, 0), group=group)


def counts() -> dict[str, int]:
    """:data:`issued` summed over groups, by name."""
    return {op: sum(n for (name, _), n in issued.items() if name == op)
            for op in ("all_to_all", "all_gather", "broadcast")}
