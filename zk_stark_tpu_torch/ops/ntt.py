"""Radix-2 NTT / iNTT over GF(p) limb tensors.

Counterpart of the JAX package's ``ops/ntt.py`` and of the Pallas glue
(``ops/ntt_pallas.py`` ``_four_step_pallas``, ``ntt_mont_pallas``,
``_planes_long_ntt``): same transform, same pad-to-power-of-two and
``len < 2`` pass-through semantics.  The transform runs along axis 0 of
``[n, *batch, 8]`` Montgomery tensors.

Up to :data:`MAX_KERNEL_N` points a transform is held by one block of the
hand-written kernel of ``csrc/ntt.cu`` (all stages in shared memory; the
counterpart of the TPU's ``_ntt_stages_kernel``), with its neighbours in
memory (:func:`block_shape`).  Above that, up to
``MAX_KERNEL_N ** 2`` (2^24), the four-step split ``n = r * c`` runs it
twice: the c columns of length r with root w^c, each multiplied by
w^(k1 * i2) in the kernel's fused-twiddle mode before its store, then the
r rows of length c with root w^r, written so that the output index
k = k1 + r * k2 is in natural order.  Up to ``MAX_KERNEL_N ** 3`` (2^36)
the rows are themselves too long for one block and split once more,
c = a * b, as the JAX package's ``_planes_long_ntt`` splits them: three
launches in all (:func:`kernel_passes`).  Larger transforms raise.

On a CUDA tensor :func:`ntt_mont` launches the kernel; on a CPU tensor it
runs the same passes (:func:`kernel_passes`: grids, strides and tables),
each with :func:`ntt_plain` (the butterflies as vectorised tensor code) in
place of the kernel and a plain twiddle multiply in place of the fused one.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..utils.bits import bit_reverse_indices, next_pow2
from . import _build
from . import limbs as L

#: largest transform one thread block holds in shared memory (64 KB); a
#: four-step transform is at most its square, a three-pass one its cube
MAX_KERNEL_N = 1 << 12
#: most blocks along the grid's y and z dimensions
MAX_GRID_YZ = 65535
#: elements a block of the kernel holds at most with several transforms
#: (32 KB of shared memory at 16 bytes an element; the other tiles and
#: widths of tools/kernel_shape_probe.py are no faster on the H100, PERF.md)
TILE_ELEMS = 1 << 11
#: threads of a block, and of the only block of a launch; the threads a
#: block should reach where the transforms allow
BLOCK_THREADS, LONE_BLOCK_THREADS, MIN_THREADS = 512, 1024, 256

_ARGS = [ctypes.c_int] * 4 + [ctypes.c_longlong] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
NTT_KERNEL = _build.Kernel(
    "ntt",
    "ntt_launch",
    [ctypes.c_void_p] * 3 + _ARGS,
    replaces="zk_stark_tpu/ops/ntt_pallas.py:180 (_ntt_stages_kernel)",
)
#: the same kernel in its fused-twiddle mode (the four-step's first pass)
NTT_TW_KERNEL = _build.Kernel(
    "ntt",
    "ntt_tw_launch",
    [ctypes.c_void_p] * 4 + _ARGS,
    replaces="zk_stark_tpu/ops/ntt_pallas.py:180 (_ntt_stages_kernel, fuse_tw :266)",
)
#: the second and third passes of the three-pass split (the same two entry
#: points, counted apart): the row transforms of _planes_long_ntt
_LONG = "zk_stark_tpu/ops/ntt_pallas.py:369 (_planes_long_ntt)"
NTT_LONG_TW_KERNEL = _build.Kernel(
    "ntt", "ntt_tw_launch", [ctypes.c_void_p] * 4 + _ARGS, replaces=_LONG, name="ntt_long_tw"
)
NTT_LONG_KERNEL = _build.Kernel(
    "ntt", "ntt_launch", [ctypes.c_void_p] * 3 + _ARGS, replaces=_LONG, name="ntt_long"
)


# -----------------------------------------------------------------------------
# Power tables (built on the device, cached per device)
# -----------------------------------------------------------------------------


def pow_by_exponents(
    acc: torch.Tensor, base_int: int, exps: torch.Tensor, nbits: int, mul=None
) -> torch.Tensor:
    """``acc * base^exps`` elementwise: ``acc`` [..., 8] Montgomery, ``exps``
    int64 [...] below 2^nbits.  Binary-weighted: one Montgomery product by
    base^(2^k) per bit k, kept where bit k of the exponent is set.  Products
    by ``mul`` (``limbs.mont_mul`` unless given; the plain versions' tables
    pass ``limbs.mont_mul_plain``)."""
    mul = mul or L.mont_mul
    b = base_int % L.P
    for k in range(nbits):
        bit = ((exps >> k) & 1).bool().unsqueeze(-1)
        acc = torch.where(bit, mul(acc, L.int_to_mont(b, acc.device)), acc)
        b = b * b % L.P
    return acc


def _multiplier(plain: bool):
    return L.mont_mul_plain if plain else L.mont_mul


@functools.lru_cache(maxsize=None)
def _powers_dev(base_int: int, n: int, scale_int: int, device: str,
                plain: bool = False) -> torch.Tensor:
    scale = L.int_to_mont(scale_int, device).expand(n, L.NLIMB)
    exps = torch.arange(n, dtype=L.DTYPE, device=device)
    return pow_by_exponents(scale, base_int, exps, max(1, (n - 1).bit_length()),
                            _multiplier(plain))


def powers_mont(base_int: int, n: int, device, scale_int: int = 1) -> torch.Tensor:
    """[n, 8] Montgomery ``scale * base^i`` for i in [0, n), cached per
    (base, n, scale, device).  Callers must not write into it."""
    return _powers_dev(base_int, n, scale_int, str(torch.device(device)))


def _words(limbs: torch.Tensor) -> torch.Tensor:
    """[..., 8] 16-bit limbs -> [..., 4] 32-bit words (as int32), the
    kernel's element layout."""
    w = limbs[..., 0::2] | (limbs[..., 1::2] << 16)
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32).contiguous()


def _limbs(words: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`_words`: [..., 4] words -> [..., 8] limbs."""
    w = words.to(L.DTYPE) & 0xFFFFFFFF
    return torch.stack([w & 0xFFFF, w >> 16], dim=-1).flatten(-2)


@functools.lru_cache(maxsize=None)
def _twiddles_u32(root_int: int, n: int, device: str) -> torch.Tensor:
    """The kernel's stage twiddles: root^k for k < n/2 as [n/2, 4] 32-bit
    words (Montgomery), built once per (root, n) and kept on the device."""
    return _words(powers_mont(root_int, max(1, n // 2), device))


def _four_step_twiddles(root_int: int, r: int, c: int, device: str,
                        plain: bool = False) -> torch.Tensor:
    """[c, r, 8] Montgomery root^(i2 * k1) (row i2 < c, column k1 < r)."""
    i2 = torch.arange(c, dtype=L.DTYPE, device=device).unsqueeze(1)
    k1 = torch.arange(r, dtype=L.DTYPE, device=device).unsqueeze(0)
    n = r * c
    return pow_by_exponents(L.one_mont(device), root_int, (i2 * k1) % n, (n - 1).bit_length(),
                            _multiplier(plain))


@functools.lru_cache(maxsize=None)
def _four_step_twiddles_u32(root_int: int, r: int, c: int, device: str,
                            plain: bool = False) -> torch.Tensor:
    """The fused mode's table: [c, r, 4] words, row i2 multiplying the
    transform at grid index x = i2 of a fused pass.  Only this form is kept (a quarter
    of the int64 limbs': 512 MiB at 2^25 points); the plain passes unpack
    their own copy, built with plain products (:func:`_limbs`)."""
    return _words(_four_step_twiddles(root_int, r, c, device, plain))


@functools.lru_cache(maxsize=None)
def _brev(n: int, device: str) -> torch.Tensor:
    return torch.from_numpy(bit_reverse_indices(n).astype(np.int64)).to(device)


def four_step_split(n: int) -> tuple[int, int]:
    """(r, c) with n = r * c, r = 2^ceil(log2(n)/2), both at most
    MAX_KERNEL_N; n at most MAX_KERNEL_N ** 2."""
    if n > MAX_KERNEL_N * MAX_KERNEL_N:
        raise ValueError(f"four_step_split: {n} > {MAX_KERNEL_N * MAX_KERNEL_N} points")
    log2n = n.bit_length() - 1
    r = 1 << ((log2n + 1) // 2)
    return r, n // r


# -----------------------------------------------------------------------------
# Core transform: plain versions and kernel
# -----------------------------------------------------------------------------


def _stages_plain(x: torch.Tensor, root_int: int) -> torch.Tensor:
    """All log2 n DIT butterfly stages as tensor code (the manner of the
    JAX package's ``ntt_body_unrolled``): x [n, *batch, 8] with its rows in
    bit-reversed order, n a power of two >= 2, Montgomery values; the
    result is in natural order."""
    n = x.shape[0]
    log2n = n.bit_length() - 1
    batch_shape = tuple(x.shape[1:-1])
    nb = len(batch_shape)
    # a table of its own, so that no kernel's product reaches the plain version
    powtable = _powers_dev(root_int, n // 2, 1, str(x.device), plain=True)
    for s in range(log2n):
        h = 1 << s
        w = powtable[:: n >> (s + 1)]  # [h, 8]: root^(j * n / 2h)
        xr = x.reshape((n // (2 * h), 2, h) + batch_shape + (L.NLIMB,))
        even, odd = xr[:, 0], xr[:, 1]
        t = L.mont_mul_plain(odd, w.reshape((1, h) + (1,) * nb + (L.NLIMB,)))
        x = torch.stack([L.add_mod_plain(even, t), L.sub_mod_plain(even, t)], dim=1)
        x = x.reshape((n,) + batch_shape + (L.NLIMB,))
    return x


def ntt_plain(x: torch.Tensor, root_int: int) -> torch.Tensor:
    """The transform of x [n, *batch, 8] in natural order: the bit-reversal
    gather, then :func:`_stages_plain`."""
    n = x.shape[0]
    return _stages_plain(x.index_select(0, _brev(n, str(x.device))), root_int)


class Pass(NamedTuple):
    """One batched launch of the kernel: ``grid`` (x, y, z) transforms of
    ``m`` points with root ``root``; element i of transform (bx, by, bz) at
    bx * s[0] + by * s[1] + bz * s[2] + i * s[3] (strides ``ins`` of the
    input, ``outs`` of the output, in elements of 8 limbs).  ``four_step``
    is (root, m, gx) of the fused-twiddle table (row bx multiplies transform
    bx), else None."""

    kernel: _build.Kernel
    root: int
    four_step: tuple | None
    m: int
    grid: tuple[int, int, int]
    ins: tuple[int, int, int, int]
    outs: tuple[int, int, int, int]


def kernel_passes(n: int, batch: int, root_int: int) -> list[Pass]:
    """The passes of ``batch`` transforms of n points laid out as [n, batch]:
    one up to MAX_KERNEL_N points, the four-step's two up to its square,
    three up to its cube; raises beyond."""
    B = batch
    if n <= MAX_KERNEL_N:
        # transform b: element i at i * B + b
        return [Pass(NTT_KERNEL, root_int, None, n, (B, 1, 1), (1, 0, 0, B), (1, 0, 0, B))]
    if n <= MAX_KERNEL_N ** 2:
        r, c = four_step_split(n)
        return [
            # column (i2, b): element i1 at (i1 * c + i2) * B + b; k1 is
            # stored where i1 was, times root^(i2 * k1)
            Pass(NTT_TW_KERNEL, pow(root_int, c, L.P), (root_int, r, c), r,
                 (c, B, 1), (B, 1, 0, c * B), (B, 1, 0, c * B)),
            # row (k1, b): element i2 at (k1 * c + i2) * B + b; k2 goes to
            # output index k1 + r * k2
            Pass(NTT_KERNEL, pow(root_int, r, L.P), None, c,
                 (r, B, 1), (c * B, 1, 0, B), (B, 1, 0, r * B)),
        ]
    if n > MAX_KERNEL_N ** 3:
        raise NotImplementedError(
            f"NTT of {n} > {MAX_KERNEL_N ** 3} points (MAX_KERNEL_N ** 3): beyond one "
            "level of the recursive split"
        )
    # n = r * c with r = MAX_KERNEL_N; the row transforms of length c (root
    # wr = root^r) split once more as c = a * b, i2 = j1 * b + j2 and
    # k2 = m1 + a * m2 (the JAX package's _planes_long_ntt)
    r = MAX_KERNEL_N
    c = n // r
    a, b = four_step_split(c)
    wr = pow(root_int, r, L.P)
    return [
        # the four-step's first pass, as above
        Pass(NTT_TW_KERNEL, pow(root_int, c, L.P), (root_int, r, c), r,
             (c, B, 1), (B, 1, 0, c * B), (B, 1, 0, c * B)),
        # transform (j2, k1, b): element j1 at (k1 * c + j1 * b + j2) * B + b;
        # m1 is stored where j1 was, times wr^(j2 * m1)
        Pass(NTT_LONG_TW_KERNEL, pow(wr, b, L.P), (wr, a, b), a,
             (b, r, B), (B, c * B, 1, b * B), (B, c * B, 1, b * B)),
        # transform (m1, k1, b): element j2 at (k1 * c + m1 * b + j2) * B + b;
        # m2 goes to output index k1 + r * (m1 + a * m2)
        Pass(NTT_LONG_KERNEL, pow(wr, a, L.P), None, b,
             (a, r, B), (b * B, c * B, 1, B), (r * B, B, 1, r * a * B)),
    ]


class Block(NamedTuple):
    """How ``csrc/ntt.cu`` runs a pass: each block holds ``2 ** log2_count``
    transforms that are neighbours along grid index ``dim`` (0, 1, 2 for
    x, y, z; the last block masked) with ``threads`` threads, and walks its
    input and its output transform-major (``in_tmajor``, ``out_tmajor``:
    the tile index has stride 1 there) or element-major."""

    dim: int
    log2_count: int
    threads: int
    in_tmajor: bool
    out_tmajor: bool


def block_shape(p: Pass) -> Block:
    """The block of a pass.  A block takes up to TILE_ELEMS / m
    neighbouring transforms along one grid index: first one that fills a
    block of 256 threads, then one whose stride is 1 on the sides (input,
    output) where the transforms' own elements are not contiguous, so that
    a warp's 16-byte chunks form runs of several elements, then the one of
    smaller stride.
    Only how the kernel runs depends on it, not what it computes: the
    CPU's plain passes ignore it."""
    need = (p.ins[3] != 1, p.outs[3] != 1)

    def count(d):
        return min(max(1, TILE_ELEMS // p.m), next_pow2(p.grid[d]))

    def key(d):
        serves = sum(nd and s[d] == 1 for nd, s in zip(need, (p.ins, p.outs)))
        return min(count(d) * p.m, 2 * MIN_THREADS), serves, -min(p.ins[d], p.outs[d])

    dim = max((d for d in range(3) if p.grid[d] > 1), key=key, default=0)
    c = count(dim)
    blocks = -(-p.grid[dim] // c) * p.grid[0] * p.grid[1] * p.grid[2] // p.grid[dim]
    threads = min(c * p.m // 2, LONE_BLOCK_THREADS if blocks == 1 else BLOCK_THREADS)
    return Block(dim, c.bit_length() - 1, threads, need[0] and p.ins[dim] == 1,
                 need[1] and p.outs[dim] == 1)


def pass_tables(p: Pass, device: str) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The kernel's stage twiddles and fused-twiddle table (or None) of a pass."""
    ft = None if p.four_step is None else _four_step_twiddles_u32(*p.four_step, device)
    return _twiddles_u32(p.root, p.m, device), ft


def _launch_pass(src: torch.Tensor, dst: torch.Tensor, p: Pass) -> None:
    tw, ft = pass_tables(p, str(src.device))
    ptrs = [src.data_ptr(), dst.data_ptr(), tw.data_ptr()]
    if ft is not None:
        ptrs.append(ft.data_ptr())
    blk = block_shape(p)
    p.kernel(*ptrs, p.m.bit_length() - 1, *p.grid, *p.ins, *p.outs, blk.dim, blk.log2_count,
             blk.threads, int(blk.in_tmajor), int(blk.out_tmajor), _build.stream_ptr(src.device))


def _plain_pass(src: torch.Tensor, dst: torch.Tensor, p: Pass) -> None:
    """The pass in tensor code: :func:`ntt_plain` on the transforms read
    through the kernel's input strides, the fused twiddle as a plain
    product, the result written through its output strides."""
    shape = (p.m,) + tuple(p.grid) + (L.NLIMB,)

    def view(t, s):
        return t.as_strided(shape, tuple(L.NLIMB * v for v in (s[3], s[0], s[1], s[2])) + (1,))

    y = ntt_plain(view(src, p.ins), p.root)  # [m, gx, gy, gz, 8]
    if p.four_step is not None:
        ft = _limbs(_four_step_twiddles_u32(*p.four_step, str(src.device), plain=True))
        y = L.mont_mul_plain(y, ft.transpose(0, 1)[:, :, None, None])  # ft: [gx, m, 8]
    view(dst, p.outs).copy_(y)


def _batch(x: torch.Tensor, name: str) -> int:
    """The number of transforms in x [n, *batch, 8]; raises on a bad shape."""
    n = x.shape[0]
    if x.shape[-1] != L.NLIMB or n < 2 or n & (n - 1):
        raise ValueError(f"{name}: bad shape {tuple(x.shape)}")
    return x.numel() // (n * L.NLIMB)


def _run_passes(x: torch.Tensor, passes: list[Pass], run_pass) -> torch.Tensor:
    src = x
    for p in passes:
        dst = torch.empty_like(src)
        run_pass(src, dst, p)
        src = dst
    return src


def ntt_kernel(x: torch.Tensor, root_int: int) -> torch.Tensor:
    """Launch ``csrc/ntt.cu`` on a CUDA tensor [n, *batch, 8] (n a power of
    two, 2 <= n <= MAX_KERNEL_N ** 3); returns a new tensor of the same
    shape.  One launch up to MAX_KERNEL_N points, two (the four-step) up to
    its square, three above."""
    batch = _batch(x, "ntt_kernel")
    passes = kernel_passes(x.shape[0], batch, root_int)
    if any(max(p.grid[1:]) > MAX_GRID_YZ for p in passes):
        raise ValueError(f"ntt_kernel: batch {batch} of {x.shape[0]}-point transforms "
                         f"exceeds the grid's y/z limit {MAX_GRID_YZ}")
    x = x.contiguous()
    _build.check_cuda_tensor(x, "ntt_kernel x", L.DTYPE)
    if batch == 0:
        return torch.empty_like(x)
    return _run_passes(x, passes, _launch_pass)


def ntt_passes_plain(x: torch.Tensor, root_int: int) -> torch.Tensor:
    """The plain version of :func:`ntt_kernel`: the same passes, strides and
    tables, each pass in tensor code (:func:`_plain_pass`); any device."""
    batch = _batch(x, "ntt_passes_plain")
    passes = kernel_passes(x.shape[0], batch, root_int)
    if batch == 0:
        return torch.empty_like(x)
    return _run_passes(x.contiguous(), passes, _plain_pass)


def _transform(x: torch.Tensor, root_int: int) -> torch.Tensor:
    if x.is_cuda:
        return ntt_kernel(x, root_int)
    _build.check_device(x, "ntt_mont")
    return ntt_passes_plain(x, root_int)


def _pad_pow2(x: torch.Tensor) -> torch.Tensor:
    m = x.shape[0]
    n = next_pow2(m)
    if n == m:
        return x
    pad = torch.zeros((n - m,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    return torch.cat([x, pad])


def ntt_mont(x: torch.Tensor, root_int: int) -> torch.Tensor:
    """Forward NTT of Montgomery values along axis 0; pads to the next power
    of two.  ``root_int`` is a primitive n-th root for the padded size."""
    x = _pad_pow2(x)
    if x.shape[0] < 2:
        return x
    return _transform(x, root_int)


def scalar_mul_mont(x: torch.Tensor, scalar_int: int) -> torch.Tensor:
    """Multiply every element by a host scalar."""
    return L.mont_mul(x, L.int_to_mont(scalar_int, x.device))


def intt_mont(x: torch.Tensor, root_int: int) -> torch.Tensor:
    """Inverse NTT: ntt with root^-1, scaled by n^-1 (inputs shorter than 2
    come back unchanged)."""
    if x.shape[0] < 2:
        return x
    n = next_pow2(x.shape[0])
    y = ntt_mont(x, pow(root_int, -1, L.P))
    return scalar_mul_mont(y, pow(n, -1, L.P))
