"""Distributed four-step (Bailey) NTT over the ranks of a process group.

Counterpart of the JAX package's ``parallel/ntt_dist.py``.  Decomposition
(N = n1 * n2, w a primitive N-th root)::

    coefficient index  i = n2 * i1 + i2    (natural order, matrix B[i1, i2])
    evaluation index   k = k1 + n1 * k2
    X[k1 + n1*k2] = NTT_{i2->k2}^{w^n1}( w^(i2*k1) * NTT_{i1->k1}^{w^n2}(B)[k1, i2] )

Layouts, as there, with a rank holding its block of the sharded dimension:

* input  B[i1, i2], columns i2 split over the ranks: the step-1 transform
  along i1 is local;
* output Z[k2, k1], columns k1 split: the "transposed evaluation order",
  whose row-major flattening is the natural evaluation order
  (:func:`flatten_natural`).

One ``all_to_all`` between the steps is the only exchange of the four-step
body.  The distributed engine holds vectors in natural blocks (rank r the
rows [r n/D, (r+1) n/D)); :func:`rows_to_columns` and
:func:`columns_to_rows` turn a natural block into the body's input columns
and its output columns back into a natural block, one ``all_to_all`` of
n/D rows each (the re-layouts GSPMD puts around the JAX ``shard_map``).  The local
transforms are the port's :func:`ops.ntt.ntt_mont` (the NTT kernel on the
card) and the twiddle product :func:`ops.limbs.mont_mul` (the limb kernel).
"""

from __future__ import annotations

import functools

import torch
import torch.distributed as dist

from ..ops import limbs as L
from ..ops.ntt import ntt_mont, pow_by_exponents
from ..utils.bits import is_pow2
from . import collectives
from .mesh import block

P = L.P


@functools.lru_cache(maxsize=None)
def four_step_geometry(n: int) -> tuple[int, int]:
    """(n1, n2) with n = n1 * n2 and n1 = 2^ceil(log2(n) / 2): the JAX
    package's ``_four_step_geometry``, the split of ``ops.ntt.four_step_split``
    without its length limit."""
    logn = n.bit_length() - 1
    r = 1 << ((logn + 1) // 2)
    return r, n // r


def _twiddle_exponents(n1: int, n2: int, n_dev: int, index: int, device) -> torch.Tensor:
    """[n1, n2/D] int64 exponents k1 * i2, i2 in block ``index`` of the columns."""
    cols = block(n2, n_dev, index)
    k1 = torch.arange(n1, dtype=torch.int64, device=device).unsqueeze(1)
    i2 = torch.arange(cols.start, cols.stop, dtype=torch.int64, device=device).unsqueeze(0)
    return k1 * i2


def twiddle_powers(root_int: int, n1: int, n2: int, n_dev: int, index: int,
                   device) -> torch.Tensor:
    """[n1, n2/D, 8] Montgomery w^(k1 * i2) of column block ``index``,
    computed from log2(N) base powers (the harness's in-body strategy:
    no table kept)."""
    exps = _twiddle_exponents(n1, n2, n_dev, index, device)
    ones = L.one_mont(device).expand(n1, exps.shape[1], L.NLIMB)
    return pow_by_exponents(ones, root_int, exps, max(1, (n1 * n2 - 1).bit_length()))


@functools.lru_cache(maxsize=None)
def _twiddle_table(root_int: int, n1: int, n2: int, n_dev: int, index: int,
                   device: str) -> torch.Tensor:
    return twiddle_powers(root_int, n1, n2, n_dev, index, device)


def twiddle_table(root_int: int, n1: int, n2: int, n_dev: int, index: int,
                  device) -> torch.Tensor:
    """:func:`twiddle_powers` built once per (root, geometry, block, device)
    and kept (the engine's table operand).  Callers must not write into it."""
    return _twiddle_table(root_int % P, n1, n2, n_dev, index, str(torch.device(device)))


def four_step_local(x_local: torch.Tensor, n1: int, n2: int, group, root_int: int,
                    tw_local: torch.Tensor | None = None,
                    inverse: bool = False) -> torch.Tensor:
    """THE four-step body: x_local [n1, n2/D, 8] (this rank's columns of
    B) -> z_local [n2, n1/D, 8] (its columns of Z), with exactly one
    ``all_to_all`` and no other collective.

    The step-2 twiddles w^(i2 * k1) come from ``tw_local`` (the engine's
    table, :func:`twiddle_table`) or, when it is None, are computed here
    (:func:`twiddle_powers`).  ``inverse`` transforms with w^-1 (unscaled).
    The JAX package's ``pow1`` / ``pow2`` stage tables have no counterpart:
    ``ntt_mont`` keeps its own per root and length."""
    n_dev, index = dist.get_world_size(group), dist.get_rank(group)
    root = pow(root_int, -1, P) if inverse else root_int % P
    if (not (is_pow2(n1) and is_pow2(n2)) or n1 % n_dev or n2 % n_dev
            or x_local.shape[:2] != (n1, n2 // n_dev)):
        raise ValueError(f"four_step_local: block {tuple(x_local.shape)} of [{n1}, {n2}] "
                         f"over {n_dev} ranks")

    # step 1: length-n1 transforms along i1, root w^n2 (the local columns)
    y = ntt_mont(x_local, pow(root, n2, P))
    # step 2: the twiddle w^(i2 * k1), i2 the global column
    if tw_local is None:
        tw_local = twiddle_powers(root, n1, n2, n_dev, index, y.device)
    y = L.mont_mul(y, tw_local)
    # step 3: rows k1 in D chunks, chunk e to rank e; chunk e received holds
    # rank e's columns of this rank's rows
    rows = n1 // n_dev
    recv = collectives.all_to_all(y, group).reshape(n_dev, rows, n2 // n_dev, L.NLIMB)
    # step 4: [n2, n1/D] with i2 along dim 0, length-n2 transforms, root w^n1
    y = recv.permute(0, 2, 1, 3).reshape(n2, rows, L.NLIMB)
    return ntt_mont(y, pow(root, n1, P))


def ntt_dist(x_local: torch.Tensor, root_int: int, group=None) -> torch.Tensor:
    """Forward distributed NTT: this rank's columns [n1, n2/D, 8] of the
    natural coefficient matrix (flat index n2*i1 + i2) -> its columns
    [n2, n1/D, 8] of the transposed evaluation matrix (entry (k2, k1) the
    evaluation at w^(k1 + n1*k2)).  One all-to-all."""
    n1, n2 = x_local.shape[0], x_local.shape[1] * dist.get_world_size(group)
    return four_step_local(x_local, n1, n2, group, root_int)


def intt_dist(z_local: torch.Tensor, root_int: int, group=None) -> torch.Tensor:
    """Inverse distributed NTT: this rank's columns [n2, n1/D, 8] of the
    transposed evaluation matrix -> its columns [n1, n2/D, 8] of the
    natural coefficient matrix, scaled by 1/N.  The forward machinery with
    the geometry (n2, n1) and w^-1 maps Z back to B.  One all-to-all."""
    n2, n1 = z_local.shape[0], z_local.shape[1] * dist.get_world_size(group)
    y = four_step_local(z_local, n2, n1, group, root_int, inverse=True)
    return L.mont_mul(y, L.int_to_mont(pow(n1 * n2, -1, P), y.device))


def rows_to_columns(x_block: torch.Tensor, n1: int, n2: int, group=None) -> torch.Tensor:
    """This rank's natural block [n/D, 8] of a length-n1*n2 vector (rows
    i1 of B in its block, every column) -> its columns [n1, n2/D, 8] of B,
    the input of :func:`four_step_local`.  One all-to-all."""
    n_dev = dist.get_world_size(group)
    rows, cols = n1 // n_dev, n2 // n_dev
    chunks = x_block.reshape(rows, n_dev, cols, L.NLIMB).transpose(0, 1)
    return collectives.all_to_all(chunks, group).reshape(n1, cols, L.NLIMB)


def columns_to_rows(z_local: torch.Tensor, n1: int, n2: int, group=None) -> torch.Tensor:
    """This rank's columns [n2, n1/D, 8] of Z (the output of
    :func:`four_step_local`) -> its natural block [n/D, 8] of the flat
    evaluation vector (rows k2 of Z in its block, every column).  One
    all-to-all."""
    n_dev = dist.get_world_size(group)
    rows, cols = n2 // n_dev, n1 // n_dev
    recv = collectives.all_to_all(z_local, group).reshape(n_dev, rows, cols, L.NLIMB)
    return recv.transpose(0, 1).reshape(rows * n1, L.NLIMB)


def gather_columns(local: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's column block [rows, cols/D, 8] -> the whole matrix
    [rows, cols, 8] on every rank.  One all-gather."""
    rows = local.shape[0]
    out = collectives.all_gather(local, group)
    return out.reshape(-1, rows, local.shape[1], L.NLIMB).permute(1, 0, 2, 3).reshape(
        rows, -1, L.NLIMB)


def flatten_natural(m: torch.Tensor) -> torch.Tensor:
    """Either whole matrix layout -> the flat natural-order vector [N, 8]:
    B[i1, i2] (flat n2*i1 + i2) and Z[k2, k1] (flat k1 + n1*k2) are both
    natural order when flattened row-major."""
    return m.reshape(m.shape[0] * m.shape[1], L.NLIMB)
