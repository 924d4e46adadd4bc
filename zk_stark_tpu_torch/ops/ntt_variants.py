"""Three forms of the NTT stage kernel, for the stage-variant probe.

Counterpart of the JAX package's ``tools/ntt_variant_probe.py`` kernels
``kernel_a``, ``kernel_b`` and ``kernel_c``: each runs every DIT stage of
c transforms whose rows arrive bit-reversed and writes natural order, so
all three compute the NTT of the un-permuted rows.  They differ only in
where the stage twiddles come from and in how the first three stages are
done (``csrc/ntt_variants.cu`` says how), and so measure what of the stage
kernel's time is not arithmetic.

x is ``[n, c, 8]`` Montgomery limbs, 8 <= n <= MAX_KERNEL_N a power of two.
On a CUDA tensor :func:`variant_stages` launches the chosen kernel; on a
CPU tensor it runs :func:`stages_plain`, the stages as tensor code (the
same as :func:`ntt.ntt_plain` after its bit-reversal gather).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from . import limbs as L
from . import ntt as N

VARIANTS = ("a", "b", "c")

_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
_PROBE = "tools/ntt_variant_probe.py"
VARIANT_KERNELS = {
    "a": _build.Kernel("ntt_variants", "ntt_variant_a_launch", _ARGS,
                       replaces=f"{_PROBE}:50 (kernel_a)"),
    "b": _build.Kernel("ntt_variants", "ntt_variant_b_launch", _ARGS,
                       replaces=f"{_PROBE}:77 (kernel_b)"),
    "c": _build.Kernel("ntt_variants", "ntt_variant_c_launch", _ARGS,
                       replaces=f"{_PROBE}:104 (kernel_c)"),
}


def stages_plain(x: torch.Tensor, root_int: int) -> torch.Tensor:
    """The plain version of the three kernels: x [n, *batch, 8] with its rows
    bit-reversed -> the transform in natural order."""
    return N._stages_plain(x, root_int)


@functools.lru_cache(maxsize=None)
def stage_major_table(root_int: int, n: int, device: str) -> torch.Tensor:
    """Kernel b's table: [n - 1, 4] words, stage s's twiddle j
    (root^(j * n / 2^(s+1)), j < 2^s) at 2^s - 1 + j."""
    idx = torch.cat([torch.arange(1 << s) * (n >> (s + 1)) for s in range(n.bit_length() - 1)])
    return N._words(N.powers_mont(root_int, n // 2, device)[idx.to(device)])


def _check(x: torch.Tensor, name: str) -> int:
    """log2 n of x [n, c, 8]; raises on another shape."""
    n = x.shape[0]
    if x.dim() != 3 or x.shape[-1] != L.NLIMB or n & (n - 1) or not 8 <= n <= N.MAX_KERNEL_N:
        raise ValueError(f"{name}: expected [n, c, 8] with n a power of two in "
                         f"[8, {N.MAX_KERNEL_N}], got {tuple(x.shape)}")
    return n.bit_length() - 1


def variant_kernel(which: str, x: torch.Tensor, root_int: int) -> torch.Tensor:
    """Launch kernel ``which`` (a, b or c) on a CUDA tensor x [n, c, 8]."""
    log2n = _check(x, f"variant_kernel {which}")
    _build.check_cuda_tensor(x, f"variant_kernel {which} x", L.DTYPE)
    n, c = x.shape[0], x.shape[1]
    dev = str(x.device)
    tw = stage_major_table(root_int, n, dev) if which == "b" else N._twiddles_u32(root_int, n, dev)
    y = torch.empty_like(x)
    if c:
        VARIANT_KERNELS[which](x.data_ptr(), y.data_ptr(), tw.data_ptr(), log2n, c,
                               _build.stream_ptr(x.device))
    return y


def variant_stages(which: str, x: torch.Tensor, root_int: int) -> torch.Tensor:
    """The stages of x [n, c, 8] (rows bit-reversed) through variant
    ``which``: its kernel on a CUDA tensor, :func:`stages_plain` on a CPU
    one."""
    if which not in VARIANT_KERNELS:
        raise ValueError(f"variant_stages: unknown variant {which!r}")
    if x.is_cuda:
        return variant_kernel(which, x, root_int)
    _build.check_device(x, "variant_stages")
    _check(x, f"variant_stages {which}")
    return stages_plain(x, root_int)
