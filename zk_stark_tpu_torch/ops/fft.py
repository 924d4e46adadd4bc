"""The complex-valued DFT and FFT (the pedagogical tier).

Counterpart of the JAX package's ``ops/fft.py``, which sits beside the NTT
as teaching material and is on no proving path: ``dft`` is one complex64
matrix product (a plain product outside any kernel, as the JAX package
leaves it to XLA), ``fft`` runs the iterative radix-2 butterfly stages
vectorised, both on ``device`` (the card unless the caller asks for the
CPU); ``fft_recursive`` stays host numpy.  Each returns a numpy array, as
the JAX package's do.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..utils.bits import bit_reverse_indices, next_pow2
from ._build import resolve_device


def _unit(angles: torch.Tensor) -> torch.Tensor:
    """exp(i * angles) as complex64."""
    return torch.polar(torch.ones_like(angles), angles)


def dft(inputs, device="cuda") -> np.ndarray:
    """O(n^2) discrete Fourier transform of a real signal.  The exponents
    f * j are reduced mod n in integers before the float32 angle, so large
    n keeps float32's accuracy."""
    device = resolve_device(device)
    x = torch.from_numpy(np.asarray(inputs, dtype=np.float32)).to(device)
    n = x.shape[0]
    f = torch.arange(n, device=device)
    angles = ((f[:, None] * f[None, :]) % n).to(torch.float32) * (-2.0 * math.pi / n)
    return (_unit(angles) @ x.to(torch.complex64)).cpu().numpy()


def fft_recursive(inputs) -> np.ndarray:
    """Recursive radix-2 Cooley-Tukey on the host."""
    x = np.asarray(inputs, dtype=np.complex64)
    n = len(x)
    if n == 1:
        return x
    even = fft_recursive(x[0::2])
    odd = fft_recursive(x[1::2])
    k = np.arange(n // 2)
    omega = np.exp(-2j * np.pi * k / n).astype(np.complex64)
    t = omega * odd
    return np.concatenate([even + t, even - t]).astype(np.complex64)


def fft(inputs, device="cuda") -> np.ndarray:
    """Iterative radix-2 FFT, each butterfly stage one vectorised step on
    ``device``; pads to the next power of two with zeros."""
    device = resolve_device(device)
    x = np.asarray(inputs, dtype=np.complex64)
    n = next_pow2(len(x)) if len(x) > 1 else len(x)
    if n != len(x):
        x = np.concatenate([x, np.zeros(n - len(x), dtype=np.complex64)])
    if n < 2:
        return x
    brev = torch.from_numpy(bit_reverse_indices(n).astype(np.int64)).to(device)
    y = torch.from_numpy(x).to(device)[brev]
    for s in range(n.bit_length() - 1):
        half = 1 << s
        omega = _unit(torch.arange(half, dtype=torch.float32, device=device)
                      * (-2.0 * math.pi / (2 * half)))
        yr = y.reshape(-1, 2, half)
        even, odd = yr[:, 0], yr[:, 1] * omega
        y = torch.cat([even + odd, even - odd], dim=1).reshape(n)
    return y.cpu().numpy()
