"""The batched Rescue-XLIX permutation.

Counterpart of the JAX package's ``ops/rescue_ops.py``: a batch of sponge
states ``[B, m, 8]`` (16-bit limbs, Montgomery) runs all N rounds of
x^alpha -> MDS -> + first constants -> x^alpha_inv -> MDS -> + second
constants, the bulk (Merkle-leaf) hashing path of ``RescuePrime``.

On a CUDA tensor :func:`permutation_batch` launches ``csrc/rescue.cu`` (one
thread per register of a state, every round in one launch, instantiated for
m = 2 .. :data:`KERNEL_MAX_M`; each S-box runs the exponent chain of
:func:`exponent_chain`); on a CPU tensor it runs :func:`permutation_plain`,
the tensor-code counterpart of the JAX package's column kernel.  The TPU's limb-plane layout, its pad
to 128 lanes and the switch between the two JAX kernels have no
counterpart: they exist for the TPU's vector tiles.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from . import limbs as L

_STEPS_PTR = ctypes.POINTER(ctypes.c_uint32)

RESCUE_KERNEL = _build.Kernel(
    "rescue",
    "rescue_launch",
    [ctypes.c_void_p] * 4
    + [ctypes.c_int] * 3
    + [_STEPS_PTR, ctypes.c_int, _STEPS_PTR, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
    replaces="zk_stark_tpu/ops/rescue_ops.py:163 (_permutation_kernel)",
)
#: the widest state the kernel is instantiated for (``kMaxM`` in ``csrc/rescue.cu``)
KERNEL_MAX_M = 8
#: most threads of a block
KERNEL_THREADS = 128
#: slots and most steps of an exponent chain (``kSlots``, ``kMaxSteps``)
KERNEL_SLOTS = 4
KERNEL_MAX_STEPS = 96
#: a step's "no slot", and its source "the Montgomery one" (``kNone``, ``kOne``)
NONE, ONE = 0xF, 0xE
#: widest sliding window :func:`exponent_chain` tries
_MAX_WINDOW = 16


def chain_step(squarings: int = 0, src: int = NONE, mul: int = NONE, dst: int = NONE) -> int:
    """One step of an exponent chain as the kernel reads it: acc <- slot
    ``src`` (or one; kept if NONE), then ``squarings`` squarings, then
    acc <- acc * slot ``mul``, then slot ``dst`` <- acc."""
    if not 0 <= squarings < 256:
        raise ValueError(f"chain_step: {squarings} squarings")
    return squarings | src << 8 | mul << 12 | dst << 16


def _fields(step: int) -> tuple[int, int, int, int]:
    return step & 0xFF, (step >> 8) & 0xF, (step >> 12) & 0xF, (step >> 16) & 0xF


def chain_products(steps) -> int:
    """Montgomery products an exponent chain spends: its squarings and its
    multiplications."""
    return sum(_fields(s)[0] + (_fields(s)[2] != NONE) for s in steps)


def _continue(steps: list, base_slot: int, bits: str, dst: int) -> None:
    """Append the steps that take acc <- slot ``base_slot`` on to the value
    whose binary form is the base's followed by ``bits`` (left-to-right
    binary, multiplying by x = slot 0), then store it in ``dst``."""
    runs = bits.split("1")  # zeros before each 1, then the trailing zeros
    src = base_slot
    for zeros in runs[:-1]:
        steps.append(chain_step(len(zeros) + 1, src=src, mul=0))
        src = NONE
    if runs[-1] or src != NONE:
        steps.append(chain_step(len(runs[-1]), src=src))
    steps[-1] = steps[-1] & ~(0xF << 16) | dst << 16


def _window_chain(e: int, w: int) -> list[int] | None:
    """The chain of a sliding window of at most ``w`` bits over e > 0, or
    None if its digits need more slots than the kernel has.  Every digit
    used after the first is built once into a slot (left-to-right binary
    from x, or from a smaller digit whose binary form begins its own); the
    first digit is built straight into acc."""
    bits = bin(e)[2:]
    windows, i, zeros = [], 0, 0  # (zeros before, digit bits)
    while i < len(bits):
        if bits[i] == "0":
            zeros, i = zeros + 1, i + 1
            continue
        j = min(i + w, len(bits))
        while bits[j - 1] == "0":
            j -= 1
        windows.append((zeros, bits[i:j]))
        zeros, i = 0, j
    table = sorted({d for _, d in windows[1:] if d != "1"}, key=lambda d: (len(d), d))
    if len(table) > KERNEL_SLOTS - 1:
        return None
    slot = {"1": 0}
    steps: list[int] = []

    def build(d: str, dst: int) -> None:
        base = max((b for b in slot if d.startswith(b) and b != d), key=len)
        _continue(steps, slot[base], d[len(base):], dst)

    for k, d in enumerate(table, start=1):
        build(d, k)
        slot[d] = k
    first = windows[0][1]
    if first in slot:
        steps.append(chain_step(src=slot[first]))
    else:
        build(first, NONE)
    for z, d in windows[1:]:
        steps.append(chain_step(z + len(d), mul=slot[d]))
    if zeros:
        steps.append(chain_step(zeros))
    return steps


@functools.lru_cache(maxsize=None)
def exponent_chain(e: int) -> tuple[int, ...]:
    """The steps by which ``csrc/rescue.cu`` raises x to e (0 <= e < 2^128):
    the sliding-window chain of fewest products over window widths 1 to
    16 whose digits fit the kernel's slots (width 1, square-and-multiply,
    always does).  For the Rescue inverse S-box's 128-bit alpha_inv it is
    156 products (digits 135, then 85 and 171), against the fixed 4-bit
    window's 169."""
    if not 0 <= e < 1 << 128:
        raise ValueError(f"exponent {e} is not in [0, 2^128)")
    if e == 0:
        return (chain_step(src=ONE),)
    chains = [c for w in range(1, _MAX_WINDOW + 1)
              if (c := _window_chain(e, w)) is not None and len(c) <= KERNEL_MAX_STEPS]
    return tuple(min(chains, key=chain_products))


def chain_pow(x: torch.Tensor, steps) -> torch.Tensor:
    """x^e for Montgomery x [..., 8], e given by its chain: the kernel's
    steps as tensor code."""
    slots = {0: x}
    acc = x
    for step in steps:
        squarings, src, mul, dst = _fields(step)
        if src == ONE:
            acc = L.one_mont(x.device).expand(x.shape)
        elif src != NONE:
            acc = slots[src]
        for _ in range(squarings):
            acc = L.mont_mul_plain(acc, acc)
        if mul != NONE:
            acc = L.mont_mul_plain(acc, slots[mul])
        if dst != NONE:
            slots[dst] = acc
    return acc


def products_per_permutation(m: int, n_rounds: int, alpha: int, alpha_inv: int) -> int:
    """Montgomery products of one permutation as the kernel computes it:
    per round and register the two S-boxes' chains, and two m x m MDS
    products."""
    sboxes = chain_products(exponent_chain(alpha)) + chain_products(exponent_chain(alpha_inv))
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
    prod = L.mont_mul_plain(mds, s.unsqueeze(1))  # [B, m (j), m (i), 8]
    acc = prod[:, :, 0]
    for i in range(1, s.shape[1]):
        acc = L.add_mod_plain(acc, prod[:, :, i])
    return acc


def permutation_plain(state, mds, round_constants, n_rounds: int, alpha: int, alpha_inv: int):
    """Tensor-code permutation on [B, m, 8]: the counterpart of
    ``_permutation_kernel_cols`` (rescue_ops.py:101-159)."""
    m = _check_constants(state, mds, round_constants, n_rounds)
    s = state
    for r in range(n_rounds):
        s = L.mont_pow(s, alpha, L.mont_mul_plain)
        s = _mds_mul(s, mds)
        s = L.add_mod_plain(s, round_constants[2 * r * m : 2 * r * m + m])
        s = L.mont_pow_windowed(s, alpha_inv, L.mont_mul_plain)
        s = _mds_mul(s, mds)
        s = L.add_mod_plain(s, round_constants[2 * r * m + m : 2 * r * m + 2 * m])
    return s


def _steps(e: int):
    """The host array of e's chain and its length, for the launch."""
    steps = exponent_chain(e)
    return (ctypes.c_uint32 * len(steps))(*steps), len(steps)


def launch_plan(n_states: int, m: int = 2) -> dict:
    """The blocks and threads a block :func:`permutation_kernel` launches
    for ``n_states`` of width m: m threads a state (one register each), a
    block the largest multiple of m up to KERNEL_THREADS whatever the batch
    (128 at m = 2 and 4, 126 at m = 3; ``tools/kernel_shape_probe.py``
    times other widths at m = 2; PERF.md)."""
    threads = KERNEL_THREADS // m * m
    return {"blocks": -(-n_states * m // threads), "threads": threads}


def permutation_kernel(state, mds, round_constants, n_rounds: int, alpha: int, alpha_inv: int):
    """Launch ``csrc/rescue.cu``; same contract as :func:`permutation_plain`."""
    b, m = state.shape[0], state.shape[1]
    if not 2 <= m <= KERNEL_MAX_M:
        raise NotImplementedError(
            f"rescue kernel: state width m = {m}, instantiated for 2 .. {KERNEL_MAX_M}")
    _build.check_cuda_tensor(state, "rescue state", L.DTYPE, (b, m, L.NLIMB))
    _build.check_cuda_tensor(mds, "rescue mds", L.DTYPE)
    _build.check_cuda_tensor(round_constants, "rescue round_constants", L.DTYPE)
    _check_constants(state, mds, round_constants, n_rounds)
    a_steps, a_len = _steps(alpha)
    ai_steps, ai_len = _steps(alpha_inv)
    out = torch.empty_like(state)
    if b:
        RESCUE_KERNEL(
            state.data_ptr(), out.data_ptr(), mds.data_ptr(), round_constants.data_ptr(),
            b, m, n_rounds, a_steps, a_len, ai_steps, ai_len, launch_plan(b, m)["threads"],
            _build.stream_ptr(state.device),
        )
    return out


def permutation_batch(state, mds, round_constants, n_rounds: int, alpha: int, alpha_inv: int):
    """The full permutation on a batch of states.

    state: [B, m, 8] Montgomery; mds: [m, m, 8]; round_constants:
    [2 * n_rounds * m, 8] (at least).  Returns [B, m, 8].  The kernel on the
    card (a width above KERNEL_MAX_M raises there), the plain version on
    the CPU.
    """
    if state.is_cuda:
        return permutation_kernel(state, mds, round_constants, n_rounds, alpha, alpha_inv)
    _build.check_device(state, "permutation_batch")
    return permutation_plain(state, mds, round_constants, n_rounds, alpha, alpha_inv)
