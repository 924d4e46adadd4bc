"""Chained Montgomery products: the card's measured product rate.

Counterpart of the JAX bench's calibration kernel (``bench.py:202``,
``kern``): y <- y * x, k times from y = x, elementwise, so y = x^(k+1).  It
computes nothing the prover needs; it exists to be timed, as the yardstick
that prices the Rescue kernel's measured-rate ceiling in ``chip_smoke.py``.

On a CUDA tensor :func:`mont_mul_chain` launches ``csrc/montmul_chain.cu``
(:data:`CHAINS` elements' chains a thread, a grid the card holds at once);
on a CPU tensor it runs :func:`mont_mul_chain_plain`, k calls of
``limbs.mont_mul_plain``.
"""

from __future__ import annotations

import ctypes
import re

import torch

from . import _build
from . import limbs as L

MONTMUL_CHAIN_KERNEL = _build.Kernel(
    "montmul_chain",
    "montmul_chain_launch",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
    replaces="bench.py:202 (kern)",
)


def chains() -> int:
    """The elements' chains a thread of the kernel carries (``kChains`` in
    ``csrc/montmul_chain.cu``, its one compile-time value)."""
    src = (_build.CSRC / "montmul_chain.cu").read_text()
    return int(re.search(r"constexpr int kChains = (\d+);", src).group(1))


CHAINS = chains()


def mont_mul_chain_plain(x: torch.Tensor, k: int = 32) -> torch.Tensor:
    """y <- y * x, k times from y = x, elementwise on [n, 8]: x^(k+1)."""
    y = x
    for _ in range(k):
        y = L.mont_mul_plain(y, x)
    return y


def mont_mul_chain_kernel(x: torch.Tensor, k: int = 32) -> torch.Tensor:
    """Launch ``csrc/montmul_chain.cu``; same contract as the plain version."""
    n = x.shape[0]
    _build.check_cuda_tensor(x, "mont_mul_chain x", L.DTYPE, (n, L.NLIMB))
    if k < 0:
        raise ValueError(f"mont_mul_chain: k = {k} < 0")
    y = torch.empty_like(x)
    if n:
        MONTMUL_CHAIN_KERNEL(x.data_ptr(), y.data_ptr(), n, k, _build.stream_ptr(x.device))
    return y


def mont_mul_chain(x: torch.Tensor, k: int = 32) -> torch.Tensor:
    """k chained Montgomery products per element: the kernel on the card,
    the plain version on the CPU."""
    if x.is_cuda:
        return mont_mul_chain_kernel(x, k)
    _build.check_device(x, "mont_mul_chain")
    return mont_mul_chain_plain(x, k)

