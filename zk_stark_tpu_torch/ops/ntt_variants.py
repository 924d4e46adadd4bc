"""Four forms of the NTT stage kernel, for the stage-variant probe.

Counterpart of the JAX package's ``tools/ntt_variant_probe.py`` kernels
``kernel_a``, ``kernel_b`` and ``kernel_c``, asked of this card's stage
kernel on its own block (``csrc/ntt_variants.cu`` says how each differs):
a is ``csrc/ntt.cu``'s ``ntt_stages_kernel`` itself, launched through
:func:`ntt.ntt_kernel`; b reads a stage-major twiddle table from shared
memory; c runs the first three stages in registers; d overlaps a resident
block's loads of its next tiles with the stages of the current one.  b, c
and d load and store the tile as a does (``csrc/ntt_stages.cuh``).

Every form takes natural rows, as ``ntt.cu`` does (it bit-reverses on
load), and computes the NTT of each column: the JAX probe's result on the
un-permuted rows.  (The JAX probe feeds bit-reversed rows to kernels that
do not permute; here the permutation is the load's.)

x is ``[n, c, 8]`` Montgomery limbs, 8 <= n <= MAX_KERNEL_N a power of two.
On a CUDA tensor :func:`variant_ntt` launches the chosen kernel; on a CPU
tensor it runs :func:`ntt_columns_plain`, :func:`ntt.ntt_plain`.
"""

from __future__ import annotations

import functools

import torch

from . import _build
from . import limbs as L
from . import ntt as N

VARIANTS = ("a", "b", "c", "d")

_PROBE = "tools/ntt_variant_probe.py"
#: b, c and d take ntt_launch's arguments (their own table in place of tw)
VARIANT_KERNELS = {
    "a": N.NTT_KERNEL,
    "b": _build.Kernel("ntt_variants", "ntt_variant_b_launch", N.NTT_KERNEL.argtypes,
                       replaces=f"{_PROBE}:77 (kernel_b)"),
    "c": _build.Kernel("ntt_variants", "ntt_variant_c_launch", N.NTT_KERNEL.argtypes,
                       replaces=f"{_PROBE}:104 (kernel_c)"),
    # no TPU form: the probe's fourth question, asked on the card only
    "d": _build.Kernel("ntt_variants", "ntt_variant_d_launch", N.NTT_KERNEL.argtypes,
                       replaces=f"{_PROBE}:221 (none of its three: kernel_a with the loads "
                                "overlapped)"),
}
#: what variant a stands in for (its kernel is ntt.cu's, counted as ``ntt``)
A_REPLACES = f"{_PROBE}:50 (kernel_a)"
#: d's threads a block, and the most elements of its tile (16 KB of words:
#: with a second tile of words and two raw slots three blocks fit an SM)
D_THREADS, D_TILE_ELEMS = 512, 1 << 10


def ntt_columns_plain(x: torch.Tensor, root_int: int) -> torch.Tensor:
    """The plain version of the four kernels: the NTT of each column of
    x [n, *batch, 8] (natural rows)."""
    return N.ntt_plain(x, root_int)


@functools.lru_cache(maxsize=None)
def stage_major_table(root_int: int, n: int, device: str) -> torch.Tensor:
    """Kernel b's table: [n - 1, 4] words, stage s's twiddle j
    (root^(j * n / 2^(s+1)), j < 2^s) at 2^s - 1 + j."""
    idx = torch.cat([torch.arange(1 << s) * (n >> (s + 1)) for s in range(n.bit_length() - 1)])
    return N._words(N.powers_mont(root_int, n // 2, device)[idx.to(device)])


def variant_block(which: str, p: N.Pass) -> N.Block:
    """The block of variant ``which`` for pass p: ``ntt.block_shape``'s,
    and for d at most D_TILE_ELEMS elements a tile with D_THREADS
    threads."""
    blk = N.block_shape(p)
    if which != "d":
        return blk
    count = min(1 << blk.log2_count, max(1, D_TILE_ELEMS // p.m))
    return blk._replace(log2_count=count.bit_length() - 1, threads=D_THREADS)


def variant_table(which: str, root_int: int, n: int, device: str) -> torch.Tensor:
    """The twiddle table variant ``which`` reads."""
    return stage_major_table(root_int, n, device) if which == "b" else N._twiddles_u32(
        root_int, n, device)


def _check(x: torch.Tensor, name: str) -> int:
    """log2 n of x [n, c, 8]; raises on another shape."""
    n = x.shape[0]
    if x.dim() != 3 or x.shape[-1] != L.NLIMB or n & (n - 1) or not 8 <= n <= N.MAX_KERNEL_N:
        raise ValueError(f"{name}: expected [n, c, 8] with n a power of two in "
                         f"[8, {N.MAX_KERNEL_N}], got {tuple(x.shape)}")
    return n.bit_length() - 1


def variant_kernel(which: str, x: torch.Tensor, root_int: int) -> torch.Tensor:
    """Launch kernel ``which`` on a CUDA tensor x [n, c, 8] (natural rows):
    a through ``ntt.ntt_kernel``, b, c and d with the pass and block it
    plans."""
    log2n = _check(x, f"variant_kernel {which}")
    _build.check_cuda_tensor(x, f"variant_kernel {which} x", L.DTYPE)
    if which == "a":
        return N.ntt_kernel(x, root_int)
    n, c = x.shape[0], x.shape[1]
    y = torch.empty_like(x)
    if c:
        (p,) = N.kernel_passes(n, c, root_int)
        blk = variant_block(which, p)
        tw = variant_table(which, root_int, n, str(x.device))
        VARIANT_KERNELS[which](x.data_ptr(), y.data_ptr(), tw.data_ptr(), log2n, *p.grid, *p.ins,
                               *p.outs, blk.dim, blk.log2_count, blk.threads,
                               int(blk.in_tmajor), int(blk.out_tmajor),
                               _build.stream_ptr(x.device))
    return y


def variant_ntt(which: str, x: torch.Tensor, root_int: int) -> torch.Tensor:
    """The NTT of each column of x [n, c, 8] (natural rows) through variant
    ``which``: its kernel on a CUDA tensor, :func:`ntt_columns_plain` on a
    CPU one."""
    if which not in VARIANT_KERNELS:
        raise ValueError(f"variant_ntt: unknown variant {which!r}")
    if x.is_cuda:
        return variant_kernel(which, x, root_int)
    _build.check_device(x, "variant_ntt")
    _check(x, f"variant_ntt {which}")
    return ntt_columns_plain(x, root_int)
