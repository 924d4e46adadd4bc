"""Device meshes over the ranks of a process group.

Counterpart of the JAX package's ``parallel/mesh.py``.  The evaluation
domain is the prover's "sequence" dimension: the distributed four-step NTT
splits it over a 1-D mesh whose one dimension is named :data:`AXIS`.  The
JAX package's ``col_sharding`` / ``row_sharding`` describe how a global
array lies on the mesh; a process here holds its own block, which
:func:`block` names.
"""

from __future__ import annotations

import functools

import torch.distributed as dist

AXIS = "shard"


def mesh_device_type() -> str:
    """The device type of meshes over the default group: ``cuda`` under
    NCCL, ``cpu`` otherwise (the backend follows the device the group was
    started for, :func:`multihost.initialize`)."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


@functools.lru_cache(maxsize=None)
def _make_mesh_cached(n_devices: int | None, ranks: tuple | None):
    from torch.distributed.device_mesh import DeviceMesh

    if ranks is None:
        ranks = tuple(range(dist.get_world_size()))
    if n_devices is not None:
        if len(ranks) < n_devices:
            raise ValueError(f"need {n_devices} ranks, have {len(ranks)}")
        ranks = ranks[:n_devices]
    return DeviceMesh(mesh_device_type(), list(ranks), mesh_dim_names=(AXIS,))


def make_mesh(n_devices: int | None = None, devices=None):
    """The 1-D ``DeviceMesh`` over the first ``n_devices`` of ``devices``
    (global ranks; every rank of the world by default), one instance per
    rank set.  Every rank of the world calls it with the same arguments:
    a mesh's groups are made collectively."""
    return _make_mesh_cached(n_devices, tuple(devices) if devices is not None else None)


def block(n: int, n_dev: int, index: int) -> slice:
    """Block ``index`` of ``n_dev`` equal blocks of a length-n axis (the
    rows or columns a rank holds)."""
    if n % n_dev:
        raise ValueError(f"an axis of {n} does not split into {n_dev} equal blocks")
    size = n // n_dev
    return slice(index * size, (index + 1) * size)
