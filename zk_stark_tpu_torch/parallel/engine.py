"""Execution engines: the prover's heavy device work on one device or split
over the ranks of a process group.

Counterpart of the JAX package's ``parallel/engine.py``.  The prover
(``stark.py`` seg1 and seg2, ``fri.py`` commit, ``ops/poly_ops.py``) is
written against this small interface, so the same protocol code runs on
one device or over several ranks with byte-identical proofs: the
arithmetic is exact, only where it runs changes.

:class:`Engine` (``DEFAULT``) calls the port's ops.  :class:`DistEngine`
runs on every rank of its group, each rank running the same protocol
code.  Its operations take and return whole ("replicated") tensors that
every rank holds; each rank computes its share, and collectives
(:mod:`collectives`) hand the whole result to every rank:

* ``ntt`` / ``intt``: the four-step decomposition with one all-to-all
  (:func:`ntt_dist.four_step_local`), then one all-gather to natural order;
  lengths that do not tile over the ranks run the single-device transform
  on every rank (the JAX package's replicated fallback: identical values);
* ``batch_inv``: each rank inverts its block with the batched-inversion
  kernel (inversion is elementwise, so each block is exact), one
  all-gather;
* ``fold_round``: each rank folds its share of the pairs (k, k + n/2)
  with the fold kernel, one all-gather;
* ``combine``: each rank sums its block of rows of seg2's weighted
  combination, one all-gather;
* ``draw``: rank 0 draws the prover's random bytes and broadcasts them,
  so that every rank builds the same randomized trace.
"""

from __future__ import annotations

import functools
from typing import Callable, Sequence

import torch
import torch.distributed as dist

from ..ops import fold as FO
from ..ops import limbs as L
from ..ops.ntt import _pad_pow2, intt_mont, ntt_mont
from ..utils.bits import is_pow2, next_pow2
from . import collectives
from .mesh import AXIS, block, make_mesh
from .ntt_dist import (
    flatten_natural,
    four_step_geometry,
    four_step_local,
    gather_columns,
    twiddle_table,
)

P = L.P


def combine_rows(w: torch.Tensor, term_arrs: Sequence[torch.Tensor], shifts: Sequence[int],
                 start: int, stop: int) -> torch.Tensor:
    """Rows [start, stop) of seg2's weighted combination: the sum over terms
    of ``w[idx] * term_arrs[idx]`` placed at row ``shifts[idx]``."""
    comb = torch.zeros((stop - start, L.NLIMB), dtype=L.DTYPE, device=w.device)
    for idx, arr in enumerate(term_arrs):
        sh = shifts[idx]
        lo, hi = max(sh, start), min(sh + arr.shape[0], stop)
        if lo < hi:
            rows = slice(lo - start, hi - start)
            comb[rows] = L.add_mod(comb[rows], L.mont_mul(arr[lo - sh : hi - sh], w[idx]))
    return comb


class Engine:
    """Single-device engine (the default): the port's ops as they are."""

    is_distributed = False
    cache_key = ("single",)
    #: the prover's segments are captured as CUDA graphs on the card
    captures_segments = True

    def ntt(self, x: torch.Tensor, root_int: int) -> torch.Tensor:
        return ntt_mont(x, root_int)

    def intt(self, x: torch.Tensor, root_int: int) -> torch.Tensor:
        return intt_mont(x, root_int)

    def batch_inv(self, x: torch.Tensor) -> torch.Tensor:
        return L.batch_inv(x)

    def constrain(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def fold_round(self, cw, invpows, ao, two_inv) -> tuple[torch.Tensor, torch.Tensor]:
        return FO.fold_round(cw, invpows, ao, two_inv)

    def combine(self, w: torch.Tensor, term_arrs: Sequence[torch.Tensor],
                shifts: Sequence[int]) -> torch.Tensor:
        max_len = max(a.shape[0] + sh for a, sh in zip(term_arrs, shifts))
        return combine_rows(w, term_arrs, shifts, 0, max_len)

    def draw(self, rng: Callable[[int], bytes], sizes: Sequence[int], device) -> list[bytes]:
        """``rng(n)`` for each n of ``sizes``, in order."""
        return [rng(n) for n in sizes]


DEFAULT = Engine()


class DistEngine(Engine):
    """The engine over the ``n_devices`` ranks of ``group`` (by default
    the 1-D mesh over the first ``n_devices`` global ranks, or over
    ``devices``, a tuple of global ranks).  Every rank of the group calls
    every operation with the same arguments."""

    is_distributed = True
    #: NCCL collectives are not captured into the segments' CUDA graphs yet:
    #: under this engine the prover's segments run eagerly
    captures_segments = False

    def __init__(self, n_devices: int, devices=None, group=None):
        if not dist.is_initialized():
            raise RuntimeError("DistEngine needs an initialized torch.distributed "
                               "process group (parallel.multihost.initialize)")
        if not is_pow2(n_devices):
            raise ValueError(f"DistEngine: {n_devices} ranks is not a power of two")
        if group is None:
            group = make_mesh(n_devices, devices).get_group(AXIS)
        self.group = group
        self.devices = collectives.group_ranks(group)
        if len(self.devices) != n_devices or (devices is not None
                                              and tuple(devices) != self.devices):
            raise ValueError(f"DistEngine: the group spans ranks {self.devices}, not "
                             f"{n_devices} ranks {devices}")
        self.n_devices = n_devices
        self.index = dist.get_rank(group)
        self.backend = dist.get_backend(group)
        self.cache_key = ("dist", n_devices, self.devices)

    def _check(self, x: torch.Tensor) -> None:
        collectives.require_backend(x.device, self.backend)

    def _distributable(self, n: int) -> bool:
        if not is_pow2(n):
            return False
        n1, n2 = four_step_geometry(n)
        d = self.n_devices
        return n1 % d == 0 and n2 % d == 0

    def constrain(self, x: torch.Tensor) -> torch.Tensor:
        """The identity.  In the JAX package it pins a flat array to block
        sharding for GSPMD; here there is no GSPMD, and every operation's
        result is whole on every rank, so there is nothing to pin (keeping
        codewords in blocks between the operations is later work)."""
        return x

    def _transform(self, x: torch.Tensor, root_int: int, scale_int: int | None):
        n = x.shape[0]
        n1, n2 = four_step_geometry(n)
        cols = block(n2, self.n_devices, self.index)
        x_local = x.reshape(n1, n2, L.NLIMB)[:, cols]
        tw = twiddle_table(root_int, n1, n2, self.n_devices, self.index, x.device)
        z_local = four_step_local(x_local, n1, n2, self.group, root_int, tw_local=tw)
        if scale_int is not None:
            z_local = L.mont_mul(z_local, L.int_to_mont(scale_int, x.device))
        return flatten_natural(gather_columns(z_local, self.group))

    def ntt(self, x: torch.Tensor, root_int: int) -> torch.Tensor:
        """Forward NTT of Montgomery values [n, 8]; pads to a power of two."""
        self._check(x)
        x = _pad_pow2(x)
        n = x.shape[0]
        if n < 2 or x.ndim != 2 or not self._distributable(n):
            return ntt_mont(x, root_int)
        return self._transform(x, root_int, None)

    def intt(self, x: torch.Tensor, root_int: int) -> torch.Tensor:
        """Inverse NTT: the forward one with root^-1, each rank scaling its
        block by n^-1 before the gather."""
        self._check(x)
        if x.shape[0] < 2:
            return x
        n = next_pow2(x.shape[0])
        if x.ndim != 2 or not self._distributable(n):
            return intt_mont(x, root_int)
        return self._transform(_pad_pow2(x), pow(root_int, -1, P), pow(n, -1, P))

    def batch_inv(self, x: torch.Tensor) -> torch.Tensor:
        self._check(x)
        n = x.shape[0]
        if x.ndim != 2 or n % self.n_devices or n < 8 * self.n_devices:
            return L.batch_inv(x)
        return collectives.all_gather(L.batch_inv(x[block(n, self.n_devices, self.index)]),
                                      self.group)

    def fold_round(self, cw, invpows, ao, two_inv) -> tuple[torch.Tensor, torch.Tensor]:
        """Each rank folds the pairs (k, k + n/2) of its block of k; one
        all-gather of the folded values and their canonical form."""
        self._check(cw)
        half = cw.shape[0] // 2
        if cw.shape[0] % 2 or half % self.n_devices:
            return FO.fold_round(cw, invpows, ao, two_inv)
        rows = block(half, self.n_devices, self.index)
        lo, hi = cw[rows], cw[half + rows.start : half + rows.stop]
        folded, canon = FO.fold_pairs(lo, hi, invpows[rows], ao, two_inv)
        both = collectives.all_gather(torch.stack([folded, canon]), self.group)
        both = both.reshape(self.n_devices, 2, -1, L.NLIMB).transpose(0, 1)
        both = both.reshape(2, half, L.NLIMB)
        return both[0], both[1]

    def combine(self, w: torch.Tensor, term_arrs: Sequence[torch.Tensor],
                shifts: Sequence[int]) -> torch.Tensor:
        self._check(w)
        max_len = max(a.shape[0] + sh for a, sh in zip(term_arrs, shifts))
        rows = -(-max_len // self.n_devices)
        start = min(self.index * rows, max_len)
        local = combine_rows(w, term_arrs, shifts, start, min(start + rows, max_len))
        if local.shape[0] < rows:  # the last ranks' blocks run past the end
            pad = torch.zeros((rows - local.shape[0], L.NLIMB), dtype=L.DTYPE, device=w.device)
            local = torch.cat([local, pad])
        return collectives.all_gather(local, self.group)[:max_len]

    def draw(self, rng: Callable[[int], bytes], sizes: Sequence[int], device) -> list[bytes]:
        """Group rank 0 calls ``rng`` as the single prover does (the same
        sizes, in the same order) and broadcasts all the bytes at once; no
        other rank calls its ``rng``."""
        device = torch.device(device)
        collectives.require_backend(device, self.backend)
        total = sum(sizes)
        buf = torch.empty(total, dtype=torch.uint8, device=device)
        if self.index == 0:
            drawn = b"".join(rng(n) for n in sizes)
            if len(drawn) != total:
                raise ValueError(f"rng returned {len(drawn)} bytes for {total} asked")
            buf.copy_(torch.frombuffer(bytearray(drawn), dtype=torch.uint8))
        collectives.broadcast(buf, self.group)
        data = buf.cpu().numpy().tobytes()
        out, off = [], 0
        for n in sizes:
            out.append(data[off : off + n])
            off += n
        return out


@functools.lru_cache(maxsize=None)
def dist_engine(n_devices: int) -> DistEngine:
    """The DistEngine over the first ``n_devices`` ranks, one per count
    (engines key the prover's segment cache, so reuse matters)."""
    return DistEngine(n_devices)


@functools.lru_cache(maxsize=None)
def engine_for_hybrid(mesh=None, row: int = 0) -> DistEngine:
    """The DistEngine over this rank's row of a hybrid (proof, shard) mesh
    (:func:`multihost.hybrid_mesh`): the row's ranks prove one statement
    together, other rows prove others, and no collective of a proof leaves
    its row.  Raises unless ``row`` is this rank's row::

        mesh = multihost.hybrid_mesh(ici_parallelism=2)
        stark.engine = stark.fri.engine = engine_for_hybrid(mesh, row)
    """
    from .multihost import DCN_AXIS, hybrid_mesh

    if mesh is None:
        mesh = hybrid_mesh()
    own = mesh.get_local_rank(DCN_AXIS)
    if row != own:
        raise ValueError(f"rank {dist.get_rank()} lies in row {own} of the hybrid mesh, "
                         f"not row {row}")
    devices = tuple(int(r) for r in mesh.mesh[row].tolist())
    return DistEngine(len(devices), devices=devices, group=mesh.get_group(AXIS))
