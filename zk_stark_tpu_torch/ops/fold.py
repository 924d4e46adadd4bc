"""One FRI split-and-fold round.

Counterpart of the JAX package's fold (``fri._fold_round_kernel_cached`` and
the Pallas ``ops/fold_pallas.py``).  For a codeword ``cw`` of n Montgomery
elements, with ``lo = cw[:n/2]`` and ``hi = cw[n/2:]``::

    folded = 2^-1 * ((lo + hi) + (alpha/offset) * w^-i * (lo - hi))
    canon  = REDC(folded)          (the next round's Merkle leaves)

On a CUDA tensor :func:`fold_round` launches ``csrc/fold.cu`` (persistent
blocks over bulk-copied tiles of output elements; an operand that starts
off the 16-byte grid is copied first and counted in ``limbs.copies``); on
a CPU tensor it runs :func:`fold_plain`.  :func:`fold_pairs` folds pairs
given as separate lo and hi slices (a rank's share of the pairs under the
distributed engine, ``parallel/engine.py``).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from . import limbs as L

FOLD_KERNEL = _build.Kernel(
    "fold",
    "fold_launch",
    [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_void_p],
    replaces="zk_stark_tpu/ops/fold_pallas.py:42 (_fold_kernel)",
)


def fold_pairs_plain(lo, hi, invpows, ao, two_inv):
    """Tensor-code fold of the pairs (lo[i], hi[i]): (lo, hi, invpows
    [m, 8], ao [8], two_inv [8]) -> (folded [m, 8], canon [m, 8])."""
    f = L.mont_mul_plain(invpows, ao)
    s = L.add_mod_plain(lo, hi)
    d = L.sub_mod_plain(lo, hi)
    folded = L.mont_mul_plain(two_inv, L.add_mod_plain(s, L.mont_mul_plain(f, d)))
    return folded, L.redc_plain(folded)


def fold_plain(cw, invpows, ao, two_inv):
    """Tensor-code fold: (cw [n, 8], invpows [n/2, 8], ao [8], two_inv [8])
    -> (folded [n/2, 8], canon [n/2, 8])."""
    half = cw.shape[0] // 2
    return fold_pairs_plain(cw[:half], cw[half:], invpows, ao, two_inv)


def fold_kernel(cw, invpows, ao, two_inv):
    """Launch ``csrc/fold.cu``; same contract as :func:`fold_plain`."""
    n = cw.shape[0]
    half = n // 2
    if n < 2 or n % 2:
        raise ValueError(f"fold_kernel: codeword length {n} is not even")
    if half > L.MAX_KERNEL_ELEMENTS:
        raise ValueError(f"fold_kernel: {half} outputs, the kernel indexes at most "
                         f"{L.MAX_KERNEL_ELEMENTS}")
    _build.check_cuda_tensor(cw, "fold cw", L.DTYPE, (n, L.NLIMB))
    _build.check_cuda_tensor(invpows, "fold invpows", L.DTYPE, (half, L.NLIMB))
    _build.check_cuda_tensor(ao, "fold ao", L.DTYPE, (L.NLIMB,))
    _build.check_cuda_tensor(two_inv, "fold two_inv", L.DTYPE, (L.NLIMB,))
    operands = []
    for t in (cw, invpows, ao, two_inv):
        if t.data_ptr() & 15:  # the bulk copies and vector loads read 16-byte aligned rows
            t = t.clone()
            L.copies += 1
        operands.append(t)
    cw, invpows, ao, two_inv = operands
    folded = torch.empty((half, L.NLIMB), dtype=L.DTYPE, device=cw.device)
    canon = torch.empty_like(folded)
    FOLD_KERNEL(
        cw.data_ptr(), invpows.data_ptr(), ao.data_ptr(), two_inv.data_ptr(),
        folded.data_ptr(), canon.data_ptr(), half, _build.stream_ptr(cw.device),
    )
    return folded, canon


def fold_round(cw, invpows, ao, two_inv):
    """The round on the codeword's device: the kernel on the card, the plain
    version on the CPU."""
    if cw.is_cuda:
        return fold_kernel(cw, invpows, ao, two_inv)
    _build.check_device(cw, "fold_round")
    return fold_plain(cw, invpows, ao, two_inv)


def fold_pairs(lo, hi, invpows, ao, two_inv):
    """The round on the pairs (lo[i], hi[i]) of two slices [m, 8], on
    their device: the kernel on the card, which reads the pairs of one
    codeword, so the two slices are laid end to end first (one copy); the
    plain version on the CPU."""
    if lo.shape != hi.shape:
        raise ValueError(f"fold_pairs: lo {tuple(lo.shape)} and hi {tuple(hi.shape)} differ")
    if lo.is_cuda:
        return fold_kernel(torch.cat([lo, hi]), invpows, ao, two_inv)
    _build.check_device(lo, "fold_pairs")
    return fold_pairs_plain(lo, hi, invpows, ao, two_inv)
