"""Execution engines: the prover's heavy device work on one device or split
over the ranks of a process group.

Counterpart of the JAX package's ``parallel/engine.py``.  The prover
(``stark.py`` seg1 and seg2, ``fri.py`` commit, ``merkle.py``,
``ops/poly_ops.py``) is written against this small interface, so the same
protocol code runs on one device or over several ranks with byte-identical
proofs: the arithmetic is exact, only where it runs changes.

:class:`Engine` (``DEFAULT``) calls the port's ops on whole tensors.
:class:`DistEngine` runs on every rank of its group, each rank running the
same protocol code, and holds every vector whose length splits over the
ranks (:meth:`DistEngine.splits`, the JAX package's ``_distributable``) as
**natural blocks**: rank r holds the rows [r n/D, (r+1) n/D) of a length-n
vector (:meth:`Engine.rows`), the layout the JAX ``DistEngine.constrain``
pins for GSPMD.  Shorter lengths are held whole on every rank and take the
single-device ops (the JAX package's replicated fallback: identical
values).  The blocks are carried explicitly, as plain tensors with the
global length passed alongside (``n``), not as ``torch.distributed.tensor``
DTensors: every exchange then goes through :mod:`collectives`, which counts
it, and the port's kernels need not be registered as aten ops.

* ``constrain``: a whole tensor every rank holds -> the rank's block, no
  collective;
* ``ntt`` / ``intt``: a block -> a block, three all-to-alls: natural rows to
  the four-step's columns, the four-step's own (:func:`ntt_dist.four_step_local`),
  its columns back to natural rows; no all-gather;
* ``batch_inv``: the block's elements inverted in place (inversion is
  elementwise), no collective;
* ``move``: rows of a block moved to the ranks that hold them at another
  length or position, one ``permute`` (a change of transform length, the
  combination's shifts);
* ``fold_round``: the pairs (k, k + n/2) meet on the rank that holds k in
  the folded codeword's blocks, one ``permute``; the folded codeword and its
  canonical copy are blocks of n/2;
* ``combine``: each rank sums the rows of its block of seg2's weighted
  combination, each shifted term fetching the rows its shift moves in, one
  ``permute`` a shifted term;
* ``max_over_ranks`` (the degree scans), ``gather`` (the last FRI codeword)
  and ``draw`` (rank 0 draws the prover's random bytes and broadcasts them).

On the ``nccl`` backend the prover's segments, collectives included, are
captured as CUDA graphs (``captures_segments``); on gloo they run eagerly.
"""

from __future__ import annotations

import functools
from typing import Callable, Sequence

import torch
import torch.distributed as dist

from ..ops import fold as FO
from ..ops import limbs as L
from ..ops.ntt import _pad_pow2, intt_mont, ntt_mont, powers_mont
from ..utils.bits import is_pow2, next_pow2
from . import collectives
from .mesh import AXIS, block, make_mesh
from .ntt_dist import (
    columns_to_rows,
    four_step_geometry,
    four_step_local,
    rows_to_columns,
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


def _zeros(rows: int, device) -> torch.Tensor:
    return torch.zeros((rows, L.NLIMB), dtype=L.DTYPE, device=device)


class Engine:
    """Single-device engine (the default): the port's ops on whole tensors."""

    is_distributed = False
    n_devices = 1
    index = 0
    cache_key = ("single",)
    #: the prover's segments are captured as CUDA graphs on the card
    captures_segments = True

    def splits(self, n: int) -> bool:
        """Whether a length-n vector is held as blocks (never here)."""
        return False

    def rows(self, n: int) -> slice:
        """The rows of a length-n vector this rank holds: all of them."""
        return slice(0, n)

    def constrain(self, x: torch.Tensor, n: int | None = None) -> torch.Tensor:
        """The identity: the single engine holds every tensor whole."""
        return x

    def powers(self, base_int: int, n: int, device, scale_int: int = 1) -> torch.Tensor:
        """The rows :meth:`rows` of ``scale * base^i``, i < n (cached)."""
        return powers_mont(base_int, n, device, scale_int=scale_int)

    def ntt(self, x: torch.Tensor, root_int: int, n: int | None = None) -> torch.Tensor:
        return ntt_mont(x, root_int)

    def intt(self, x: torch.Tensor, root_int: int, n: int | None = None) -> torch.Tensor:
        return intt_mont(x, root_int)

    def batch_inv(self, x: torch.Tensor) -> torch.Tensor:
        return L.batch_inv(x)

    def fold_round(self, cw, omega_int: int, ao, two_inv,
                   n: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
        """One FRI round of the codeword ``cw`` on the coset of ``omega``:
        (folded, canonical), each [n/2, 8]."""
        invpows = powers_mont(pow(omega_int, -1, P), cw.shape[0] // 2, cw.device)
        return FO.fold_round(cw, invpows, ao, two_inv)

    def combine(self, w: torch.Tensor, term_arrs: Sequence[torch.Tensor],
                shifts: Sequence[int], n: int | None = None) -> torch.Tensor:
        """Seg2's weighted combination, whole (``n`` bounds it and is
        unused here)."""
        max_len = max(a.shape[0] + sh for a, sh in zip(term_arrs, shifts))
        return combine_rows(w, term_arrs, shifts, 0, max_len)

    def max_over_ranks(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise maximum of ``x`` over the ranks: ``x``."""
        return x

    #: a collective to run on a capture's side stream before the capture
    #: (none without collectives)
    warm = None

    def draw(self, rng: Callable[[int], bytes], sizes: Sequence[int], device) -> list[bytes]:
        """``rng(n)`` for each n of ``sizes``, in order."""
        return [rng(n) for n in sizes]


DEFAULT = Engine()


class DistEngine(Engine):
    """The engine over the ``n_devices`` ranks of ``group`` (by default
    the 1-D mesh over the first ``n_devices`` global ranks, or over
    ``devices``, a tuple of global ranks).  Every rank of the group calls
    every operation with the same arguments, each with its own block."""

    is_distributed = True

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
        #: NCCL collectives are captured into the segments' CUDA graphs;
        #: gloo's (the CPU) run eagerly, as every CPU segment does
        self.captures_segments = self.backend == "nccl"

    def _check(self, x: torch.Tensor) -> None:
        collectives.require_backend(x.device, self.backend)

    def _distributable(self, n: int) -> bool:
        if not is_pow2(n):
            return False
        n1, n2 = four_step_geometry(n)
        d = self.n_devices
        return n1 % d == 0 and n2 % d == 0

    def splits(self, n: int) -> bool:
        """Whether a length-n vector is held as blocks: the lengths the
        four-step tiles over the ranks (the JAX package's ``_distributable``)."""
        return self._distributable(n)

    def rows(self, n: int) -> slice:
        """This rank's block of a length-n vector, or all of it when n does
        not split."""
        return slice(*self._owner_rows(n, self.index))

    def constrain(self, x: torch.Tensor, n: int | None = None) -> torch.Tensor:
        """The rows :meth:`rows` of the whole ``x`` zero-padded to ``n``
        (its length by default): a slice, no collective."""
        n = x.shape[0] if n is None else n
        if x.shape[0] > n:
            raise ValueError(f"constrain: {x.shape[0]} rows do not fit a length of {n}")
        r = self.rows(n)
        out = x[min(r.start, x.shape[0]) : min(r.stop, x.shape[0])]
        if out.shape[0] < r.stop - r.start:
            out = torch.cat([out, _zeros(r.stop - r.start - out.shape[0], x.device)])
        return out

    def powers(self, base_int: int, n: int, device, scale_int: int = 1) -> torch.Tensor:
        r = self.rows(n)
        return powers_mont(base_int, r.stop - r.start, device,
                           scale_int=scale_int * pow(base_int, r.start, P) % P)

    # -- moving rows between blocks -------------------------------------------

    def _owner_rows(self, n: int, rank: int) -> tuple[int, int]:
        """The rows [start, stop) of a length-n vector that ``rank`` holds."""
        if not self.splits(n):
            return 0, n
        r = block(n, self.n_devices, rank)
        return r.start, r.stop

    def move(self, x: torch.Tensor, n_from: int, n_to: int,
             moves: Sequence[tuple[int, int, int]]) -> list[torch.Tensor]:
        """For each (src, dst, count) of ``moves``: the rows :meth:`rows`
        of the length-``n_to`` vector w with w[dst + i] = v[src + i] for
        i < count and zero elsewhere, ``x`` being this rank's rows of the
        length-``n_from`` vector v.  Every move in one ``permute`` (none
        when every row stays on its rank); each rank receives at most its
        block of each result.  A result whose length does not split is
        gathered whole (one ``all_gather`` of ``count`` rows a rank)."""
        self._check(x)
        dev, me, ranks = x.device, self.index, range(self.n_devices)
        x0, x1 = self._owner_rows(n_from, me)
        if x.shape[0] != x1 - x0:
            raise ValueError(f"move: {x.shape[0]} rows are not this rank's rows of {n_from}")
        if not self.splits(n_to) and self.splits(n_from):
            return [self._gather_move(x, n_from, n_to, *m) for m in moves]

        def span(q: int, e: int, src: int, dst: int, count: int) -> tuple[int, int]:
            """The rows of v that rank q holds and rank e needs."""
            q0, q1 = self._owner_rows(n_from, q)
            e0, e1 = self._owner_rows(n_to, e)
            lo = max(q0, src, e0 - dst + src)
            hi = min(q1, src + count, e1 - dst + src)
            return lo, max(lo, hi)

        out_lo, out_hi = self._owner_rows(n_to, me)
        local = not self.splits(n_from)  # every rank holds v whole
        cross = not local and any(span(q, e, *m)[1] > span(q, e, *m)[0] for m in moves
                                  for q in ranks for e in ranks if q != e)
        if not cross and out_hi - out_lo == x.shape[0] and all(
                span(me, me, *m) == (x0, x0 + x.shape[0]) and m[1] - m[0] == out_lo - x0
                for m in moves):
            return [x for _ in moves]  # every row stays where it is: a view
        outs = [_zeros(out_hi - out_lo, dev) for _ in moves]
        for out, (src, dst, count) in zip(outs, moves):
            lo, hi = span(me, me, src, dst, count)
            out[lo - src + dst - out_lo : hi - src + dst - out_lo] = x[lo - x0 : hi - x0]
        if not cross:
            return outs
        send, send_rows, recv_rows = [], [], []
        for e in ranks:
            parts = [] if e == me else [span(me, e, *m) for m in moves]
            send.extend(x[lo - x0 : hi - x0] for lo, hi in parts)
            send_rows.append(sum(hi - lo for lo, hi in parts))
            recv_rows.append(0 if e == me else
                             sum(hi - lo for lo, hi in (span(e, me, *m) for m in moves)))
        inp = torch.cat(send) if send else _zeros(0, dev)
        recv = collectives.permute(inp, send_rows, recv_rows, self.group)
        off = 0
        for q in ranks:
            if q == me:
                continue
            for out, (src, dst, count) in zip(outs, moves):
                lo, hi = span(q, me, src, dst, count)
                out[lo - src + dst - out_lo : hi - src + dst - out_lo] = recv[off : off + hi - lo]
                off += hi - lo
        return outs

    def _gather_move(self, x, n_from, n_to, src, dst, count) -> torch.Tensor:
        """One move into a length that does not split (held whole): each
        rank's rows of [src, src + count) in one all-gather."""
        x0, x1 = self._owner_rows(n_from, self.index)
        part = _zeros(count, x.device)
        lo, hi = max(x0, src), min(x1, src + count)
        if lo < hi:
            part[lo - src : hi - src] = x[lo - x0 : hi - x0]
        every = collectives.all_gather(part, self.group).reshape(self.n_devices, count, L.NLIMB)
        owner = (torch.arange(src, src + count, device=x.device) // (n_from // self.n_devices))
        out = _zeros(n_to, x.device)
        out[dst : dst + count] = every[owner, torch.arange(count, device=x.device)]
        return out

    # -- the operations -------------------------------------------------------

    def _transform(self, x: torch.Tensor, n: int, root_int: int, scale_int: int | None):
        n1, n2 = four_step_geometry(n)
        x_local = rows_to_columns(x, n1, n2, self.group)
        tw = twiddle_table(root_int, n1, n2, self.n_devices, self.index, x.device)
        z_local = four_step_local(x_local, n1, n2, self.group, root_int, tw_local=tw)
        if scale_int is not None:
            z_local = L.mont_mul(z_local, L.int_to_mont(scale_int, x.device))
        return columns_to_rows(z_local, n1, n2, self.group)

    def _input(self, x: torch.Tensor, n: int | None) -> tuple[torch.Tensor, int]:
        self._check(x)
        if n is None:  # a whole input
            n = next_pow2(x.shape[0])
            return self.constrain(x, n), n
        r = self.rows(n)
        if x.ndim != 2 or x.shape[0] != r.stop - r.start:
            raise ValueError(f"{tuple(x.shape)} is not this rank's rows of a length of {n}")
        return x, n

    def ntt(self, x: torch.Tensor, root_int: int, n: int | None = None) -> torch.Tensor:
        """Forward NTT of this rank's rows of a length-n vector (Montgomery
        [., 8]); a whole ``x`` (``n`` None) is constrained first, padded to
        a power of two."""
        x, n = self._input(x, n)
        if n < 2:
            return x
        if not self.splits(n):
            return ntt_mont(_pad_pow2(x), root_int)
        return self._transform(x, n, root_int, None)

    def intt(self, x: torch.Tensor, root_int: int, n: int | None = None) -> torch.Tensor:
        """Inverse NTT: the forward one with root^-1, each rank scaling its
        columns by n^-1 before the last re-layout."""
        x, n = self._input(x, n)
        if n < 2 or not self.splits(n):
            return intt_mont(x, root_int) if n >= 2 else x
        return self._transform(x, n, pow(root_int, -1, P), pow(n, -1, P))

    def batch_inv(self, x: torch.Tensor) -> torch.Tensor:
        """The rank's rows inverted: elementwise, so no collective."""
        self._check(x)
        return L.batch_inv(x)

    def fold_round(self, cw, omega_int: int, ao, two_inv,
                   n: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
        """One FRI round of this rank's rows ``cw`` of the length-n
        codeword: the pairs (k, k + n/2) for k in this rank's block of the
        folded codeword meet in one ``permute`` (none at world size 1) and
        are folded with the fold kernel.  Returns this rank's rows of the
        folded codeword and of its canonical form.  When n/2 does not split
        the codeword (the last few, shorter than D^2 rows) is gathered and
        folded whole on every rank."""
        self._check(cw)
        n = cw.shape[0] if n is None else n
        half = n // 2
        if not self.splits(half):
            return super().fold_round(self.gather(cw, n), omega_int, ao, two_inv)
        lo, hi = self.move(cw, n, half, [(0, 0, half), (half, 0, half)])
        invpows = self.powers(pow(omega_int, -1, P), half, cw.device)
        return FO.fold_pairs(lo, hi, invpows, ao, two_inv)

    def combine(self, w: torch.Tensor, term_arrs: Sequence[torch.Tensor],
                shifts: Sequence[int], n: int | None = None) -> torch.Tensor:
        """This rank's rows of seg2's combination zero-padded to ``n``:
        ``term_arrs`` are the rank's rows of length-n vectors; an unshifted
        term adds its own rows, a shifted one first fetches the rows its
        shift moves into the block (one ``permute``, at most the shift's rows
        from another rank)."""
        self._check(w)
        r = self.rows(n)
        comb = _zeros(r.stop - r.start, w.device)
        for idx, arr in enumerate(term_arrs):
            sh = shifts[idx]
            if sh:
                (arr,) = self.move(arr, n, n, [(0, sh, n - sh)])
            comb = L.add_mod(comb, L.mont_mul(arr, w[idx]))
        return comb

    def max_over_ranks(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise maximum of ``x`` (int64, any shape) over the
        ranks: one all-gather of ``x`` a rank."""
        self._check(x)
        return collectives.all_gather(x.unsqueeze(0), self.group).amax(0)

    def gather(self, x: torch.Tensor, n: int) -> torch.Tensor:
        """The whole length-n vector from every rank's rows: one all-gather
        (nothing when n does not split)."""
        self._check(x)
        if not self.splits(n):
            return x
        return collectives.all_gather(x, self.group)

    def warm(self, device) -> None:
        """One small all-gather on the current stream: a capture's side
        stream is warmed with it before the capture."""
        collectives.all_gather(torch.zeros((1, 1), dtype=L.DTYPE, device=device), self.group)

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
