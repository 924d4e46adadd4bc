"""Process-group start-up and the hybrid (proof, shard) mesh.

Counterpart of the JAX package's ``parallel/multihost.py``.  There one
process per host drives that host's devices; here one process drives one
device, so a "device" of the mesh is a rank.

* :func:`initialize` starts ``torch.distributed`` once per process: NCCL
  for a CUDA device, gloo for the CPU, as the caller's device argument
  says.  It is a no-op in a single-process run, so one entry point works
  everywhere.
* :func:`shutdown` ends the group: the captured graphs that hold its
  collectives go first (``segments.release_collective_graphs``), since a
  process group hangs on its destruction while one lives.
* :func:`hybrid_mesh` lays the ranks out as a 2-D mesh: the ``shard``
  dimension (the domain the prover splits, :data:`mesh.AXIS`) runs over
  the ranks of one host, whose exchanges stay on its NVLink; the
  ``proof`` dimension spans hosts and carries only independent proofs.
"""

from __future__ import annotations

import os
import socket
from typing import NamedTuple, Sequence

import torch
import torch.distributed as dist

from .mesh import AXIS, mesh_device_type

#: the cross-host dimension of a hybrid mesh (independent proofs)
DCN_AXIS = "proof"


def _env_int(name: str) -> int | None:
    value = os.environ.get(name)
    return int(value) if value else None


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, device="cuda") -> bool:
    """Start the process group of this process.

    ``coordinator_address`` is ``host:port`` (TCP rendezvous) or a URL
    (``tcp://...``, ``file://...``); without one, the variables ``torchrun``
    sets are read (``MASTER_ADDR`` / ``MASTER_PORT`` through ``env://``,
    ``WORLD_SIZE``, ``RANK``).  The backend follows ``device``: NCCL for
    ``cuda`` (the process's card: ``LOCAL_RANK``, else its rank modulo the
    cards), gloo for ``cpu``.  Returns True when a group exists (already, or
    now), False for a single-process run with no coordinator, which needs
    none."""
    if dist.is_initialized():
        return True
    if coordinator_address is None and os.environ.get("MASTER_ADDR"):
        coordinator_address = "env://"
    if num_processes is None:
        num_processes = _env_int("WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("RANK")
    if coordinator_address is None and num_processes in (None, 1):
        return False
    if num_processes is None or process_id is None:
        raise ValueError("initialize: a coordinator needs the number of processes and "
                         "this process's id (arguments, or WORLD_SIZE and RANK)")

    device = torch.device(device)
    if device.type == "cuda":
        backend = "nccl"
        local = _env_int("LOCAL_RANK")
        torch.cuda.set_device(device.index if device.index is not None else
                              local if local is not None else
                              process_id % torch.cuda.device_count())
    elif device.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"initialize: no backend for device {device}")
    if "://" not in coordinator_address:
        coordinator_address = f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=coordinator_address,
                            world_size=num_processes, rank=process_id)
    return True


def shutdown() -> None:
    """End this process's group, if it has one: every captured graph that
    holds its collectives is released first, the card synchronised, and
    the group destroyed.  Every rank calls it."""
    from .. import segments

    if not dist.is_initialized():
        return
    segments.release_collective_graphs()
    if dist.get_backend() == "nccl":
        torch.cuda.synchronize()
    dist.destroy_process_group()


class Rank(NamedTuple):
    """A rank and the index of its host."""

    host: int
    rank: int


def _device_grid(ranks: Sequence[Rank]) -> list[list[int]]:
    """The ranks as a [hosts, ranks per host] grid: rows by host index,
    each row's ranks in order (deterministic whatever the input order)."""
    by_host: dict[int, list[int]] = {}
    for r in sorted(ranks):
        by_host.setdefault(r.host, []).append(r.rank)
    sizes = {len(v) for v in by_host.values()}
    if len(sizes) != 1:
        raise ValueError(f"uneven ranks per host: { {h: len(v) for h, v in by_host.items()} }")
    return [by_host[h] for h in sorted(by_host)]


def hybrid_grid(ranks: Sequence[Rank], ici_parallelism: int | None = None) -> list[list[int]]:
    """The hybrid layout: rows of ``ici_parallelism`` ranks of one host (all
    of a host's ranks by default); a host's leftover ranks make more rows."""
    grid = _device_grid(ranks)
    per_host = len(grid[0])
    ici = per_host if ici_parallelism is None else ici_parallelism
    if per_host % ici:
        raise ValueError(f"{per_host} ranks per host do not split into rows of {ici}")
    flat = [r for row in grid for r in row]
    return [flat[i : i + ici] for i in range(0, len(flat), ici)]


def world_ranks() -> list[Rank]:
    """Every rank of the world with the index of its host (hosts numbered
    in the order of their lowest rank).  Collective: every rank calls it."""
    names = [None] * dist.get_world_size()
    dist.all_gather_object(names, socket.gethostname())
    hosts: dict[str, int] = {}
    for name in names:
        hosts.setdefault(name, len(hosts))
    return [Rank(hosts[name], rank) for rank, name in enumerate(names)]


def hybrid_mesh(ici_parallelism: int | None = None):
    """The 2-D ``DeviceMesh`` (``proof``, ``shard``) over every rank of the
    world (:func:`hybrid_grid`).  Collective: every rank calls it."""
    from torch.distributed.device_mesh import DeviceMesh

    grid = hybrid_grid(world_ranks(), ici_parallelism)
    return DeviceMesh(mesh_device_type(), grid, mesh_dim_names=(DCN_AXIS, AXIS))
