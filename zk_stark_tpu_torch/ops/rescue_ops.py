"""The batched Rescue-XLIX permutation.

Counterpart of the JAX package's ``ops/rescue_ops.py``: a batch of sponge
states ``[B, m, 8]`` (16-bit limbs, Montgomery) runs all N rounds of
x^alpha -> MDS -> + first constants -> x^alpha_inv -> MDS -> + second
constants, the bulk (Merkle-leaf) hashing path of ``RescuePrime``.

On a CUDA tensor :func:`permutation_batch` launches ``csrc/rescue.cu`` (one
thread per state, every round in one launch, built for m = 2); on a CPU
tensor it runs :func:`permutation_plain`, the tensor-code counterpart of
the JAX package's column kernel.  The TPU's limb-plane layout, its pad to
128 lanes and the switch between the two JAX kernels have no counterpart:
they exist for the TPU's vector tiles.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from . import limbs as L

#: an exponent as 4 little-endian words of 32 bits (host memory)
_WORDS = ctypes.c_uint32 * 4
_WORDS_PTR = ctypes.POINTER(ctypes.c_uint32)

RESCUE_KERNEL = _build.Kernel(
    "rescue",
    "rescue_launch",
    [ctypes.c_void_p] * 4
    + [ctypes.c_int] * 3
    + [_WORDS_PTR, ctypes.c_int, _WORDS_PTR, ctypes.c_int, ctypes.c_void_p],
    replaces="zk_stark_tpu/ops/rescue_ops.py:163 (_permutation_kernel)",
)
#: the state width the kernel is built for (``kM`` in ``csrc/rescue.cu``)
KERNEL_M = 2


def products_per_permutation(m: int, n_rounds: int, alpha: int, alpha_inv: int) -> int:
    """Montgomery products of one permutation, as both versions compute it:
    per round and register the two S-boxes, and two m x m MDS products."""
    sboxes = L.pow_products(alpha) + L.pow_products(alpha_inv, windowed=True)
    return n_rounds * (m * sboxes + 2 * m * m)


def _check_constants(state, mds, round_constants, n_rounds) -> int:
    m = state.shape[1]
    if tuple(mds.shape) != (m, m, L.NLIMB):
        raise ValueError(f"mds: expected shape {(m, m, L.NLIMB)}, got {tuple(mds.shape)}")
    if round_constants.shape[0] < 2 * n_rounds * m:
        raise ValueError(
            f"round_constants: {round_constants.shape[0]} rows, "
            f"{n_rounds} rounds need {2 * n_rounds * m}"
        )
    return m


def _mds_mul(s: torch.Tensor, mds: torch.Tensor) -> torch.Tensor:
    """[B, m, 8] -> MDS @ s: out[:, j] = sum_i mds[j, i] * s[:, i]."""
    prod = L.mont_mul(mds, s.unsqueeze(1))  # [B, m (j), m (i), 8]
    acc = prod[:, :, 0]
    for i in range(1, s.shape[1]):
        acc = L.add_mod(acc, prod[:, :, i])
    return acc


def permutation_plain(state, mds, round_constants, n_rounds: int, alpha: int, alpha_inv: int):
    """Tensor-code permutation on [B, m, 8]: the counterpart of
    ``_permutation_kernel_cols`` (rescue_ops.py:101-159)."""
    m = _check_constants(state, mds, round_constants, n_rounds)
    s = state
    for r in range(n_rounds):
        s = L.mont_pow(s, alpha)
        s = _mds_mul(s, mds)
        s = L.add_mod(s, round_constants[2 * r * m : 2 * r * m + m])
        s = L.mont_pow_windowed(s, alpha_inv)
        s = _mds_mul(s, mds)
        s = L.add_mod(s, round_constants[2 * r * m + m : 2 * r * m + 2 * m])
    return s


def _exponent(e: int, name: str):
    if not 0 <= e < 1 << 128:
        raise ValueError(f"{name} = {e} is not in [0, 2^128)")
    return _WORDS(*((e >> (32 * k)) & 0xFFFFFFFF for k in range(4))), e.bit_length()


def permutation_kernel(state, mds, round_constants, n_rounds: int, alpha: int, alpha_inv: int):
    """Launch ``csrc/rescue.cu``; same contract as :func:`permutation_plain`."""
    b, m = state.shape[0], state.shape[1]
    if m != KERNEL_M:
        raise NotImplementedError(f"rescue kernel: state width m = {m}, built for {KERNEL_M}")
    _build.check_cuda_tensor(state, "rescue state", L.DTYPE, (b, m, L.NLIMB))
    _build.check_cuda_tensor(mds, "rescue mds", L.DTYPE)
    _build.check_cuda_tensor(round_constants, "rescue round_constants", L.DTYPE)
    _check_constants(state, mds, round_constants, n_rounds)
    a_words, a_bits = _exponent(alpha, "alpha")
    ai_words, ai_bits = _exponent(alpha_inv, "alpha_inv")
    out = torch.empty_like(state)
    if b:
        RESCUE_KERNEL(
            state.data_ptr(), out.data_ptr(), mds.data_ptr(), round_constants.data_ptr(),
            b, m, n_rounds, a_words, a_bits, ai_words, ai_bits,
            _build.stream_ptr(state.device),
        )
    return out


def permutation_batch(state, mds, round_constants, n_rounds: int, alpha: int, alpha_inv: int):
    """The full permutation on a batch of states.

    state: [B, m, 8] Montgomery; mds: [m, m, 8]; round_constants:
    [2 * n_rounds * m, 8] (at least).  Returns [B, m, 8].  The kernel on the
    card (m = 2 only: any other width raises there), the plain version on
    the CPU.
    """
    if state.is_cuda:
        return permutation_kernel(state, mds, round_constants, n_rounds, alpha, alpha_inv)
    _build.check_device(state, "permutation_batch")
    return permutation_plain(state, mds, round_constants, n_rounds, alpha, alpha_inv)
