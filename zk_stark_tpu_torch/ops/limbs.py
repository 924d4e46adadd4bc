"""Field arithmetic on GF(p) elements held as 8x16-bit limbs in int64 tensors.

Counterpart of the JAX package's ``ops/limbs.py``: the same values, the same
Montgomery form (R = 2^128), the same 16-bit limbs, so a tensor here equals
the JAX ``uint32[..., 8]`` array element for element.  The limbs live in
``int64`` because PyTorch's CPU backend has no add, shift or compare kernels
for ``uint32``.

Every operation is vectorised over the limb axis instead of unrolled per
limb: the schoolbook product is one ``[..., 8, 8]`` outer product plus a
scatter-add into 17 columns, and the Montgomery reduction runs 8 steps on
``[..., 8]`` vectors.  Column sums stay below 2^41, far inside ``int64``.
Carry chains normalise a stacked pair (``x`` and ``x - p``) in one pass, so a
conditional subtraction costs no second chain.

That tensor code is the plain version (``mont_mul_plain``, ``add_mod_plain``,
``sub_mod_plain``, ``redc_plain``) of ``csrc/limbs.cu``, which computes each
of the four in one launch on the card.  ``mont_mul``, ``add_mod``,
``sub_mod`` and ``redc`` launch the kernel on CUDA tensors (or raise) and
run the plain version on CPU tensors; so do ``mont_inv_fermat``, the
elementwise inverse (one launch of the kernel's fixed addition chain, or
``mont_inv_fermat_plain``), and ``batch_inv``, the batched inverse (one
launch of ``csrc/batch_inv.cu`` up to its block's capacity, three above,
or ``batch_inv_plain``, a product tree).  Everything else here
(``neg_mod``, ``to_mont``, ``from_mont``, the powers and scans) is built on
those six, and never leaves the tensors' device.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from . import _build

# -----------------------------------------------------------------------------
# Constants
# -----------------------------------------------------------------------------

P = 1 + 407 * (1 << 119)  # field prime
NLIMB = 8
LIMB_BITS = 16
MASK = (1 << LIMB_BITS) - 1

R_INT = (1 << 128) % P          # Montgomery radix mod p
R2_INT = R_INT * R_INT % P      # R^2 mod p, for to_mont
# p' with p * p' == -1 (mod 2^16), for digit-serial REDC
NPRIME = (-pow(P, -1, 1 << LIMB_BITS)) % (1 << LIMB_BITS)

P_LIMBS = tuple((P >> (LIMB_BITS * k)) & MASK for k in range(NLIMB))

DTYPE = torch.int64


def int_to_limbs(x: int) -> np.ndarray:
    """Python int -> int64[8] limb vector (canonical domain)."""
    return np.array(
        [(x >> (LIMB_BITS * k)) & MASK for k in range(NLIMB)], dtype=np.int64
    )


def ints_to_limbs(vals) -> np.ndarray:
    """Sequence of Python ints in [0, 2^128) -> int64[n, 8] limbs."""
    vals = list(vals)
    buf = b"".join(int(v).to_bytes(16, "little") for v in vals)
    u16 = np.frombuffer(buf, dtype="<u2").reshape(len(vals), NLIMB)
    return u16.astype(np.int64)


def limbs_to_ints(limbs) -> np.ndarray:
    """Limbs [..., 8] (tensor or array) -> object ndarray of Python ints."""
    if isinstance(limbs, torch.Tensor):
        limbs = limbs.cpu().numpy()
    arr = np.asarray(limbs)
    flat = np.ascontiguousarray(arr.reshape(-1, NLIMB).astype("<u2"))
    raw = flat.tobytes()
    out = np.empty(flat.shape[0], dtype=object)
    for i in range(flat.shape[0]):
        out[i] = int.from_bytes(raw[16 * i : 16 * i + 16], "little")
    return out.reshape(arr.shape[:-1])


def from_numpy(arr: np.ndarray, device) -> torch.Tensor:
    """int64 limb array -> tensor on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(arr, dtype=np.int64)).to(device)


def ints_to_mont(vals, device) -> torch.Tensor:
    """Host ints -> int64[n, 8] Montgomery form on ``device``."""
    mont = [int(v) % P * R_INT % P for v in vals]
    return from_numpy(ints_to_limbs(mont).reshape(len(mont), NLIMB), device)


@functools.lru_cache(maxsize=None)
def _const(value: int, device: str) -> torch.Tensor:
    return from_numpy(int_to_limbs(value), device)


def const(value: int, device) -> torch.Tensor:
    """A cached [8] limb tensor holding ``value`` as given (no conversion).
    Callers must not write into it.  The cache never shrinks: only for
    configuration constants (roots, offsets, their inverses), never for a
    value that changes with the proof (upload that with
    :func:`ints_to_mont`)."""
    return _const(value, str(torch.device(device)))


def int_to_mont(v: int, device) -> torch.Tensor:
    """Host int -> [8] Montgomery form on ``device``, cached as :func:`const`
    is: for configuration constants only."""
    return const(int(v) % P * R_INT % P, device)


def one_mont(device) -> torch.Tensor:
    return const(R_INT, device)


def mont_to_ints(t: torch.Tensor) -> np.ndarray:
    """Montgomery tensor -> object ndarray of canonical Python ints."""
    return limbs_to_ints(from_mont(t))


def mont_to_canonical_np(t: torch.Tensor) -> np.ndarray:
    """Montgomery tensor -> host ``uint32[..., 8]`` canonical limbs (the JAX
    package's array type), without a Python int per element; pair with
    :func:`row_to_int` for the few values needed one at a time."""
    return from_mont(t).cpu().numpy().astype(np.uint32)


def row_to_int(row) -> int:
    """One canonical limb row [8] -> Python int."""
    acc = 0
    for k in reversed(range(NLIMB)):
        acc = (acc << LIMB_BITS) | int(row[k])
    return acc


# -----------------------------------------------------------------------------
# Carry normalisation
# -----------------------------------------------------------------------------


def _normalize(cols: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Propagate carries through signed int64 columns [..., K].

    Returns (limbs [..., K] in [0, 2^16), carry out of the top column).  The
    arithmetic right shift floors, so a negative column borrows from the
    next one and the carry out is negative when the value is negative.
    """
    x = cols.clone()
    k = x.shape[-1]
    for i in range(k - 1):
        x[..., i + 1] += x[..., i] >> LIMB_BITS
    carry = x[..., k - 1] >> LIMB_BITS
    return x & MASK, carry


@functools.lru_cache(maxsize=None)
def _p_vec(device: str) -> torch.Tensor:
    return torch.tensor(P_LIMBS, dtype=DTYPE, device=device)


def _p(t: torch.Tensor) -> torch.Tensor:
    return _p_vec(str(t.device))


def _select_reduced(raw: torch.Tensor, top: torch.Tensor | None = None):
    """Given raw columns [..., 8] of a value v < 2p (plus an optional extra
    top column), return v mod p: normalise v and v - p together and keep
    v - p where it is non-negative."""
    both = torch.stack([raw, raw - _p(raw)], dim=-2)
    limbs, carry = _normalize(both)
    if top is not None:
        carry = carry + top.unsqueeze(-1)
    take_d = carry[..., 1] >= 0
    return torch.where(take_d.unsqueeze(-1), limbs[..., 1, :], limbs[..., 0, :])


# -----------------------------------------------------------------------------
# Add / sub / neg (canonical or Montgomery domain)
# -----------------------------------------------------------------------------


def add_mod_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a + b) mod p on [..., 8]; inputs in [0, p)."""
    return _select_reduced(a + b)


def sub_mod_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a - b) mod p on [..., 8]; inputs in [0, p)."""
    d = a - b
    both = torch.stack([d, d + _p(d)], dim=-2)
    limbs, carry = _normalize(both)
    borrow = carry[..., 0] < 0
    return torch.where(borrow.unsqueeze(-1), limbs[..., 1, :], limbs[..., 0, :])


def neg_mod(a: torch.Tensor) -> torch.Tensor:
    """(-a) mod p."""
    return sub_mod(torch.zeros_like(a), a)


def is_zero(a: torch.Tensor) -> torch.Tensor:
    """Boolean mask [...]: element == 0 (in either domain: 0*R = 0)."""
    return (a == 0).all(dim=-1)


def eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Boolean mask [...]: elementwise equality (limbs are canonical)."""
    return (a == b).all(dim=-1)


# -----------------------------------------------------------------------------
# Montgomery multiplication
# -----------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _col_index(device: str) -> torch.Tensor:
    i = torch.arange(NLIMB, device=device)
    return (i[:, None] + i[None, :]).reshape(-1)


def _redc_columns(t: torch.Tensor) -> torch.Tensor:
    """Digit-serial REDC of 17 columns [..., 17] (modified in place)."""
    pv = _p(t)
    for k in range(NLIMB):
        m = (t[..., k] * NPRIME) & MASK
        t[..., k : k + NLIMB] += m.unsqueeze(-1) * pv
        # t[k] is now == 0 (mod 2^16); push its carry up
        t[..., k + 1] += t[..., k] >> LIMB_BITS
    return _select_reduced(t[..., NLIMB : 2 * NLIMB], t[..., 2 * NLIMB])


#: most elements one step of :func:`mont_mul_plain` multiplies: a step keeps a
#: [..., 64] int64 temporary (512 B an element, 2 GiB at 2^22), so larger
#: products run in blocks along their leading dimensions
MUL_BLOCK = 1 << 22


def mont_mul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product a*b*R^-1 mod p; inputs and output in [0, p).

    Broadcasts over leading dimensions, in blocks of at most
    :data:`MUL_BLOCK` elements.  The result is the canonical residue, so it
    equals the JAX package's bit for bit.
    """
    a, b = torch.broadcast_tensors(a, b)
    lead = a.shape[:-1]
    if math.prod(lead) <= MUL_BLOCK:
        return _mont_mul_block(a, b)
    out = torch.empty(a.shape, dtype=DTYPE, device=a.device)
    step = MUL_BLOCK // math.prod(lead[1:])
    if step == 0:  # one index of the first dimension is itself too large
        for i in range(lead[0]):
            out[i] = mont_mul_plain(a[i], b[i])
        return out
    for lo in range(0, lead[0], step):
        out[lo : lo + step] = _mont_mul_block(a[lo : lo + step], b[lo : lo + step])
    return out


def _mont_mul_block(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """:func:`mont_mul_plain` of two tensors of one shape, in one step."""
    lead = a.shape[:-1]
    prod = (a.unsqueeze(-1) * b.unsqueeze(-2)).reshape(lead + (NLIMB * NLIMB,))
    t = torch.zeros(lead + (2 * NLIMB + 1,), dtype=DTYPE, device=a.device)
    t.index_add_(-1, _col_index(str(a.device)), prod)
    return _redc_columns(t)


def redc_plain(a: torch.Tensor) -> torch.Tensor:
    """a*R^-1 mod p for a field element (half the cost of mont_mul(a, 1))."""
    lead = a.shape[:-1]
    t = torch.zeros(lead + (2 * NLIMB + 1,), dtype=DTYPE, device=a.device)
    t[..., :NLIMB] = a
    return _redc_columns(t)


# -----------------------------------------------------------------------------
# The kernel (csrc/limbs.cu) and the dispatching names
# -----------------------------------------------------------------------------

#: leading dimensions the kernel indexes (``limbs::Plan``)
KERNEL_DIMS = 4
#: the kernel's element indices are 32-bit
MAX_KERNEL_ELEMENTS = (1 << 31) - 1
_INDEX = [ctypes.c_int64, ctypes.c_int] + [ctypes.c_int64] * 4
_BINARY = [ctypes.c_void_p] * 3 + _INDEX + [ctypes.c_int64] * 12 + [ctypes.c_void_p]
MONT_MUL_KERNEL = _build.Kernel(
    "limbs", "limbs_mont_mul_launch", _BINARY,
    replaces="zk_stark_tpu/ops/limbs.py:181 (mont_mul, XLA-fused)", name="limbs_mont_mul",
)
ADD_MOD_KERNEL = _build.Kernel(
    "limbs", "limbs_add_mod_launch", _BINARY,
    replaces="zk_stark_tpu/ops/limbs.py:146 (add_mod, XLA-fused)", name="limbs_add_mod",
)
SUB_MOD_KERNEL = _build.Kernel(
    "limbs", "limbs_sub_mod_launch", _BINARY,
    replaces="zk_stark_tpu/ops/limbs.py:154 (sub_mod, XLA-fused)", name="limbs_sub_mod",
)
REDC_KERNEL = _build.Kernel(
    "limbs", "limbs_redc_launch", [ctypes.c_void_p] * 2 + _INDEX + [ctypes.c_int64] * 8
    + [ctypes.c_void_p],
    replaces="zk_stark_tpu/ops/limbs.py:235 (from_mont, XLA-fused)", name="limbs_redc",
)
INV_KERNEL = _build.Kernel(
    "limbs", "limbs_inv_launch", [ctypes.c_void_p] * 2 + [ctypes.c_int64, ctypes.c_void_p],
    replaces="zk_stark_tpu/ops/limbs.py:366 (mont_inv_fermat, XLA-fused)",
    name="limbs_mont_inv_fermat",
)
BATCH_INV_KERNEL = _build.Kernel(
    "batch_inv", "batch_inv_launch",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p]
    + [ctypes.c_int] * 3 + [ctypes.c_void_p],
    replaces="zk_stark_tpu/ops/limbs.py:410 (batch_inv) with :366 (mont_inv_fermat), XLA-fused",
    name="limbs_batch_inv",
)
KERNELS = (MONT_MUL_KERNEL, ADD_MOD_KERNEL, SUB_MOD_KERNEL, REDC_KERNEL, INV_KERNEL,
           BATCH_INV_KERNEL)

#: the batch inversion's block (csrc/batch_inv.cu): at most this many
#: threads (a power of two), each taking this many elements (1, 2, 4 or 8);
#: a call of at most their product, the block's capacity, is one launch
BATCH_INV_THREADS = 256
BATCH_INV_PER_THREAD = 4
#: the narrowest block the kernel takes (a warp)
BATCH_INV_MIN_THREADS = 32

#: operands :func:`kernel_plan` copied to a contiguous layout (a limb stride
#: other than 1, a start or an element stride off the 16-byte grid, or more
#: than KERNEL_DIMS leading dimensions after collapsing)
copies = 0


@functools.lru_cache(maxsize=None)
def divider(d: int) -> int:
    """The reciprocal by which the kernel divides a 32-bit index i < 2^31 by
    d (1 <= d < 2^31), packed as magic | shift << 32: i // d is
    (umulhi(i, magic) + i) >> shift, with shift the least s of 2^s >= d and
    magic = 2^32 (2^shift - d) // d + 1 (below 2^32)."""
    shift = (d - 1).bit_length()
    magic = ((1 << 32) * ((1 << shift) - d)) // d + 1
    return magic | shift << 32


class Plan(NamedTuple):
    """How ``csrc/limbs.cu`` reads a call's operands (``limbs::Plan``)."""

    #: the output's leading shape
    lead: tuple
    #: leading dimensions left after collapsing (1 to KERNEL_DIMS)
    ndim: int
    #: their sizes, padded to KERNEL_DIMS with 1 in front (innermost last)
    sizes: list
    #: each operand's element strides (in limbs) over those dimensions; 0
    #: where it is broadcast
    strides: list
    #: the operands whose pointers the kernel takes (copies where needed)
    views: list
    #: each dimension's :func:`divider` (0 for the outermost, which the
    #: kernel does not divide by)
    divisors: list


#: the plan's divisors of a call of one collapsed dimension
_NO_DIVISORS = [0] * KERNEL_DIMS


def _collapse(lead, strides):
    """Drop the dimensions of size 1 of ``lead`` and merge each dimension
    into the one before it where every operand steps through both evenly.
    Returns (sizes, each operand's strides)."""
    sizes, out = [], [[] for _ in strides]
    for d, n in enumerate(lead):
        if n == 1:
            continue
        if sizes and all(o[-1] == s[d] * n for o, s in zip(out, strides)):
            sizes[-1] *= n
            for o, s in zip(out, strides):
                o[-1] = s[d]
        else:
            sizes.append(n)
            for o, s in zip(out, strides):
                o.append(s[d])
    return sizes, out


def _broadcast(shapes) -> tuple:
    """The broadcast of leading shapes (torch.broadcast_shapes, in a few
    integer operations)."""
    nd = max(len(s) for s in shapes)
    out = [1] * nd
    for s in shapes:
        for d, n in enumerate(s, nd - len(s)):
            if n != 1 and n != out[d]:
                if out[d] != 1:
                    raise ValueError(f"limb operands of shapes {shapes} do not broadcast")
                out[d] = n
    return tuple(out)


def _lead_strides(t: torch.Tensor, nd: int) -> list:
    """t's element strides over the nd leading dimensions of the broadcast
    shape: 0 where t has no such dimension or one of size 1."""
    return [0] * (nd + 1 - t.dim()) + [
        s if n != 1 else 0 for n, s in zip(t.shape[:-1], t.stride()[:-1])
    ]


def _vector_ready(t: torch.Tensor) -> bool:
    """Whether the kernel can read ``t``'s elements as 16-byte vectors: limbs
    adjacent, the start and every element stride on the 16-byte grid."""
    return (t.stride(-1) == 1 and not t.data_ptr() & 15
            and not any(s & 1 for n, s in zip(t.shape[:-1], t.stride()[:-1]) if n != 1))


def kernel_plan(*operands: torch.Tensor) -> Plan:
    """How ``csrc/limbs.cu`` reads ``operands`` (one or two int64 [..., 8]
    tensors, any device).  Broadcast dimensions get stride 0; an operand
    the kernel cannot read as 16-byte vectors (:func:`_vector_ready`) is
    copied first, and all of them are, in the broadcast shape, when more
    than KERNEL_DIMS dimensions remain.  Plain integer work on shapes and
    strides: it is the host cost of a call."""
    global copies
    a = operands[0]
    if a.is_contiguous() and not a.data_ptr() & 15 and all(
        ((t.shape == a.shape and t.is_contiguous()) or (t.dim() == 1 and t.stride(0) == 1))
        and not t.data_ptr() & 15
        for t in operands[1:]
    ):  # the common calls: one shape, or against a single [8] element
        n = a.numel() // NLIMB
        strides = [[0, 0, 0, NLIMB if t.dim() > 1 else 0] for t in operands]
        return Plan(tuple(a.shape[:-1]), 1, [1, 1, 1, n], strides, list(operands), _NO_DIVISORS)
    views = list(operands)
    for i, t in enumerate(views):
        if not _vector_ready(t):
            views[i] = t.clone(memory_format=torch.contiguous_format)
            copies += 1
    shapes = [tuple(t.shape[:-1]) for t in views]
    lead = shapes[0] if all(s == shapes[0] for s in shapes) else _broadcast(shapes)
    sizes, strides = _collapse(lead, [_lead_strides(t, len(lead)) for t in views])
    if len(sizes) > KERNEL_DIMS:
        copies += len(views)
        views = [t.expand(lead + (NLIMB,)).contiguous() for t in views]
        sizes, strides = _collapse(lead, [_lead_strides(t, len(lead)) for t in views])
    if not sizes:  # a single element
        sizes, strides = [1], [[0] for _ in views]
    pad = KERNEL_DIMS - len(sizes)
    divisors = [0] * (pad + 1) + [divider(d) for d in sizes[1:]]
    strides = [[0] * pad + s for s in strides]
    return Plan(lead, len(sizes), [1] * pad + sizes, strides, views, divisors)


def _check_operands(name: str, *operands: torch.Tensor) -> torch.device:
    """Raise unless every operand is a CUDA tensor of [..., 8] int64 limbs on
    one device; return that device."""
    dev = operands[0].device
    for t in operands:
        if not t.is_cuda:
            raise ValueError(f"{name}: expected CUDA tensors, got one on {t.device}")
        if t.device != dev:
            raise ValueError(f"{name}: operands on {dev} and {t.device}")
        if t.dtype != DTYPE or t.dim() == 0 or t.shape[-1] != NLIMB:
            raise ValueError(f"{name}: expected {DTYPE} [..., {NLIMB}] limbs, got "
                             f"{t.dtype} {tuple(t.shape)}")
    return dev


def _launch(kernel: _build.Kernel, name: str, *operands: torch.Tensor) -> torch.Tensor:
    dev = _check_operands(name, *operands)
    plan = kernel_plan(*operands)
    out = torch.empty(plan.lead + (NLIMB,), dtype=DTYPE, device=dev)
    n = out.numel() // NLIMB
    if n > MAX_KERNEL_ELEMENTS:
        raise ValueError(f"{name}: {n} elements, the kernel indexes at most {MAX_KERNEL_ELEMENTS}")
    if n:
        kernel(*(v.data_ptr() for v in plan.views), out.data_ptr(), n, plan.ndim, *plan.sizes,
               *(s for st in plan.strides for s in st), *plan.divisors,
               _build.stream_ptr(dev))
    return out


def mont_mul_kernel(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/limbs.cu``'s product; same contract as :func:`mont_mul_plain`."""
    return _launch(MONT_MUL_KERNEL, "mont_mul_kernel", a, b)


def add_mod_kernel(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/limbs.cu``'s addition; same contract as :func:`add_mod_plain`."""
    return _launch(ADD_MOD_KERNEL, "add_mod_kernel", a, b)


def sub_mod_kernel(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/limbs.cu``'s subtraction; same contract as :func:`sub_mod_plain`."""
    return _launch(SUB_MOD_KERNEL, "sub_mod_kernel", a, b)


def redc_kernel(a: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/limbs.cu``'s REDC; same contract as :func:`redc_plain`."""
    return _launch(REDC_KERNEL, "redc_kernel", a)


def mont_inv_fermat_kernel(a: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/limbs.cu``'s inversion (one thread an element, a fixed
    addition chain for a^(p-2)); same contract as :func:`mont_inv_fermat_plain`.
    An operand that is not contiguous or starts off the 16-byte grid is
    copied first (counted in :data:`copies`)."""
    global copies
    dev = _check_operands("mont_inv_fermat_kernel", a)
    x = a
    if not x.is_contiguous() or x.data_ptr() & 15:
        x = a.clone(memory_format=torch.contiguous_format)
        copies += 1
    out = torch.empty(x.shape, dtype=DTYPE, device=dev)
    n = x.numel() // NLIMB
    if n > MAX_KERNEL_ELEMENTS:
        raise ValueError(f"mont_inv_fermat_kernel: {n} elements, the kernel indexes at most "
                         f"{MAX_KERNEL_ELEMENTS}")
    if n:
        INV_KERNEL(x.data_ptr(), out.data_ptr(), n, _build.stream_ptr(dev))
    return out


def batch_inv_grid(x: torch.Tensor, launch, threads: int = 0, per_thread: int = 0) -> torch.Tensor:
    """The launches of ``csrc/batch_inv.cu`` for x [n, 8] (n >= 1,
    contiguous, 16-byte aligned): ``launch(a, out, n, totals, inv_totals,
    blocks, threads, per_thread)`` once for n up to a block's capacity C =
    threads * per_thread (defaults BATCH_INV_THREADS, BATCH_INV_PER_THREAD),
    in the narrowest block of a power of two threads (at least a warp)
    that holds n; else three times: the blocks' totals into scratch, their
    inverses by this function on the totals (one launch up to C blocks, so
    n up to C^2; beyond, it recurses), the outputs.  Grid, widths and
    scratch follow from n alone, and nothing waits for the card, so a CUDA
    graph may capture the launches.  Returns the output [n, 8]."""
    threads = threads or BATCH_INV_THREADS
    per_thread = per_thread or BATCH_INV_PER_THREAD
    n = x.shape[0]
    cap = threads * per_thread
    out = torch.empty_like(x)
    if n <= cap:
        narrow = 1 << (-(-n // per_thread) - 1).bit_length()
        width = min(threads, max(narrow, BATCH_INV_MIN_THREADS))
        launch(x, out, n, None, None, 1, width, per_thread)
        return out
    blocks = -(-n // cap)
    totals = torch.empty((blocks, NLIMB), dtype=DTYPE, device=x.device)
    launch(x, None, n, totals, None, blocks, threads, per_thread)
    inv_totals = batch_inv_grid(totals, launch, threads, per_thread)
    launch(x, out, n, None, inv_totals, blocks, threads, per_thread)
    return out


def batch_inv_kernel(a: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/batch_inv.cu`` (:func:`batch_inv_grid`: one launch up
    to BATCH_INV_THREADS * BATCH_INV_PER_THREAD elements, three above);
    same contract as :func:`batch_inv_plain`.  An operand that is not
    contiguous or starts off the 16-byte grid is copied first (counted in
    :data:`copies`)."""
    global copies
    dev = _check_operands("batch_inv_kernel", a)
    if not a.is_contiguous() or a.data_ptr() & 15:
        a = a.clone(memory_format=torch.contiguous_format)
        copies += 1
    x = a.view(-1, NLIMB)
    n = x.shape[0]
    if n == 0:
        return a
    if n > MAX_KERNEL_ELEMENTS:
        raise ValueError(f"batch_inv_kernel: {n} elements, the kernel indexes at most "
                         f"{MAX_KERNEL_ELEMENTS}")
    stream = _build.stream_ptr(dev)

    def launch(src, out, count, totals, inv_totals, blocks, threads, per_thread):
        BATCH_INV_KERNEL(src.data_ptr(), None if out is None else out.data_ptr(), count,
                         None if totals is None else totals.data_ptr(),
                         None if inv_totals is None else inv_totals.data_ptr(),
                         blocks, threads, per_thread, stream)

    return batch_inv_grid(x, launch).view(a.shape)


def mont_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a*b*R^-1 mod p, broadcasting: the kernel unless both lie on the CPU."""
    if a.is_cpu and b.is_cpu:
        return mont_mul_plain(a, b)
    return mont_mul_kernel(a, b)


def add_mod(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a + b) mod p, broadcasting: the kernel unless both lie on the CPU."""
    if a.is_cpu and b.is_cpu:
        return add_mod_plain(a, b)
    return add_mod_kernel(a, b)


def sub_mod(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a - b) mod p, broadcasting: the kernel unless both lie on the CPU."""
    if a.is_cpu and b.is_cpu:
        return sub_mod_plain(a, b)
    return sub_mod_kernel(a, b)


def redc(a: torch.Tensor) -> torch.Tensor:
    """a*R^-1 mod p: the kernel unless ``a`` lies on the CPU."""
    if a.is_cpu:
        return redc_plain(a)
    return redc_kernel(a)


def mont_inv_fermat(a: torch.Tensor) -> torch.Tensor:
    """Elementwise inverse a^(p-2) in Montgomery form (inv(0) == 0): the
    kernel unless ``a`` lies on the CPU."""
    if a.is_cpu:
        return mont_inv_fermat_plain(a)
    return mont_inv_fermat_kernel(a)


def batch_inv(a: torch.Tensor) -> torch.Tensor:
    """Batched modular inversion over every leading dimension, inv(0) == 0:
    the kernel unless ``a`` lies on the CPU."""
    if a.is_cpu:
        return batch_inv_plain(a)
    return batch_inv_kernel(a)


def mont_sqr(a: torch.Tensor) -> torch.Tensor:
    return mont_mul(a, a)


def to_mont(a: torch.Tensor) -> torch.Tensor:
    """Canonical -> Montgomery: a * R mod p."""
    return mont_mul(a, const(R2_INT, a.device))


def from_mont(a: torch.Tensor) -> torch.Tensor:
    """Montgomery -> canonical: a * R^-1 mod p."""
    return redc(a)


# -----------------------------------------------------------------------------
# Exponentiation, scans and batched inversion
# -----------------------------------------------------------------------------


def mont_pow(a: torch.Tensor, e: int, mul=None) -> torch.Tensor:
    """a^e in Montgomery domain (e a Python int >= 0), square-and-multiply;
    products by ``mul`` (:func:`mont_mul` unless given: a plain version
    passes :func:`mont_mul_plain`)."""
    mul = mul or mont_mul
    if e == 0:
        return one_mont(a.device).expand(a.shape).clone()
    acc = a
    for bit in bin(e)[3:]:
        acc = mul(acc, acc)
        if bit == "1":
            acc = mul(acc, a)
    return acc


#: exponents of at most this many bits go by square-and-multiply in
#: :func:`mont_pow_windowed` (the JAX package's ``_POW_UNROLL_BITS``)
POW_UNROLL_BITS = 8
#: window width of :func:`mont_pow_windowed`: digits 0..15, a table of a^1..a^15
POW_WINDOW = 4


def window_digits(e: int) -> list[int]:
    """Base-2^POW_WINDOW digits of e > 0, most significant (and nonzero) first."""
    ndig = -(-e.bit_length() // POW_WINDOW)
    mask = (1 << POW_WINDOW) - 1
    return [(e >> (POW_WINDOW * (ndig - 1 - i))) & mask for i in range(ndig)]


def mont_pow_windowed(a: torch.Tensor, e: int, mul=None) -> torch.Tensor:
    """a^e in Montgomery domain by fixed-window exponentiation.

    Counterpart of the JAX package's ``limbs.mont_pow_windowed``: digits of
    ``POW_WINDOW`` bits, most significant first, each a run of
    ``POW_WINDOW`` squarings and one product by a table entry (none for a
    zero digit), as ``csrc/rescue.cu`` computes the inverse S-box.
    For the Rescue inverse S-box's 128-bit exponent (65 set bits) that is
    169 products against 191 for square-and-multiply.  Exponents of at most
    ``POW_UNROLL_BITS`` bits go to :func:`mont_pow`.  Products by ``mul``,
    as there.
    """
    mul = mul or mont_mul
    if e.bit_length() <= POW_UNROLL_BITS:
        return mont_pow(a, e, mul)
    # table[d] = a^d; a^0 is never selected (the first digit is nonzero and
    # a zero digit costs no product)
    table = [None, a]
    for _ in range(2, 1 << POW_WINDOW):
        table.append(mul(table[-1], a))
    digits = window_digits(e)
    acc = table[digits[0]]
    for d in digits[1:]:
        for _ in range(POW_WINDOW):
            acc = mul(acc, acc)
        if d:
            acc = mul(acc, table[d])
    return acc


def mont_inv_fermat_plain(a: torch.Tensor) -> torch.Tensor:
    """Plain version of the inversion kernel: a^(p-2) by
    :func:`mont_pow_windowed` with plain products (the JAX package's
    ``mont_inv_fermat``); inv(0) == 0."""
    return mont_pow_windowed(a, P - 2, mul=mont_mul_plain)


def cumprod_mont_blocked(x: torch.Tensor, cols: int | None = None) -> torch.Tensor:
    """Inclusive cumulative Montgomery product along axis 0 of [n, 8].

    Two-level blocked scan: inclusive scans inside all rows at once (cols
    sequential steps), then one exclusive scan over the row totals.
    """
    n = x.shape[0]
    if n <= 1:
        return x
    if cols is None:
        cols = max(1, int(np.sqrt(n)))
    rows = (n + cols - 1) // cols
    m = rows * cols
    one = one_mont(x.device)
    grid = torch.cat([x, one.expand(m - n, NLIMB)]).reshape(rows, cols, NLIMB)

    within = torch.empty_like(grid)
    carry = one.expand(rows, NLIMB)
    for c in range(cols):
        carry = mont_mul(carry, grid[:, c])
        within[:, c] = carry

    row_excl = torch.empty(rows, NLIMB, dtype=DTYPE, device=x.device)
    acc = one
    for r in range(rows):
        row_excl[r] = acc
        acc = mont_mul(acc, within[r, -1])
    out = mont_mul(row_excl[:, None, :], within)
    return out.reshape(m, NLIMB)[:n]


def batch_inv_plain(a: torch.Tensor) -> torch.Tensor:
    """Plain version of the batch inversion kernel; inv(0) == 0 (the
    reference convention).

    The Montgomery product trick over a product tree: the up-sweep
    multiplies pairs level by level, the single root product is inverted
    by :func:`mont_inv_fermat_plain`, and the down-sweep hands each child
    inv(parent) * sibling.  2*log2(n) full-width plain products in all.
    """
    shape = a.shape
    flat = a.reshape(-1, NLIMB)
    n = flat.shape[0]
    if n == 0:
        return a
    zero = is_zero(flat)
    one = one_mont(a.device)
    b = torch.where(zero.unsqueeze(-1), one, flat)
    size = 1 << max(0, (n - 1).bit_length())
    if size > n:
        b = torch.cat([b, one.expand(size - n, NLIMB)])

    levels = [b]
    while levels[-1].shape[0] > 1:
        cur = levels[-1]
        levels.append(mont_mul_plain(cur[0::2], cur[1::2]))

    inv = mont_inv_fermat_plain(levels[-1])

    for cur in reversed(levels[:-1]):
        # children (l, r) of a parent with inverse q: inv(l) = q*r, inv(r) = q*l
        sib = cur.reshape(-1, 2, NLIMB).flip(1)
        inv = mont_mul_plain(inv.unsqueeze(1), sib).reshape(-1, NLIMB)

    inv = inv[:n]
    inv = torch.where(zero.unsqueeze(-1), torch.zeros_like(inv), inv)
    return inv.reshape(shape)
