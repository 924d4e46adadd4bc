"""BLAKE2b-512 Merkle hashing on tensors: leaf and node digests.

Counterpart of the JAX package's ``ops/blake2b_dev.py``.  Byte parity with
``hashlib`` is the contract: a leaf hashes the decimal string of a canonical
field element, an inner node the 128-byte concatenation of its two
children.  Both messages fit one compression block, so each digest is one
final-block compression.  Digests are ``uint8[n, 64]`` tensors; the
digest-word API (:func:`compress_words`, :func:`node_digests_packed`,
:func:`leaf_digest_words`, :func:`node_digest_words`) carries them as the
JAX package does, (hi, lo) 32-bit halves of the 8 little-endian words,
here in ``int64`` planes [8, n].

A Merkle tree's inner levels come from :func:`tree_digests`: leaf
digests [n, 64] -> the n - 1 inner digests [n - 1, 64], level 1 (n / 2
parents) first and the root last, each level in natural order
(:func:`split_levels` cuts them into views).  On CUDA tensors
:func:`leaf_digests`, :func:`tree_digests`, :func:`node_digests` (one
level) and :func:`compress_words` launch the kernels of
``csrc/blake2b.cu``: the leaf one thread per digest; the node several
levels a launch, ceil(log2(n) / TREE_LEVELS) launches a tree
(:func:`tree_launches`).  The leaf and node kernels read 16-byte
aligned rows, so an input that starts off that grid is copied first.  On
CPU tensors they run the plain versions below (:func:`tree_plain` is the
per-level loop of :func:`node_digests_plain`), which carry each 64-bit
word as (hi, lo) 32-bit halves in ``int64`` (PyTorch's ``int64`` right shift is
arithmetic and its CPU backend has no ``uint64``/``uint32`` kernels, so
a direct 64-bit port would rotate wrongly).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import _build
from . import limbs as L

LEAF_KERNEL = _build.Kernel(
    "blake2b",
    "leaf_launch",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p],
    replaces="zk_stark_tpu/ops/blake2b_dev.py:373 (_leaf_fused_kernel)",
)
NODE_KERNEL = _build.Kernel(
    "blake2b",
    "node_launch",
    [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_void_p],
    replaces="zk_stark_tpu/ops/blake2b_dev.py:383 (_node_split_kernel)",
)
#: the most levels one node launch hashes: a block takes 2^10 children down
#: to one digest (48 KB of shared memory for its levels); at most
#: csrc/blake2b.cu node::kMaxSpanLog2 (11)
TREE_LEVELS = 10
#: threads a node block of a tree: two parents a thread on a full block's
#: first level, three blocks an SM (tools/kernel_shape_probe.py node_trees)
NODE_THREADS = 256
#: the node kernel asked for one level: blocks of 128 threads, one parent a
#: thread (tools/kernel_shape_probe.py node_level)
LEVEL_THREADS = 128
LEVEL_SPAN_LOG2 = 8
COMPRESS_KERNEL = _build.Kernel(
    "blake2b",
    "compress_launch",
    [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p],
    replaces="zk_stark_tpu/ops/blake2b_dev.py:224 (_compress_pallas_kernel)",
)

# BLAKE2b IV (RFC 7693 section 2.6)
_IV = (
    0x6A09E667F3BCC908, 0xBB67AE8584CAA73B,
    0x3C6EF372FE94F82B, 0xA54FF53A5F1D36F1,
    0x510E527FADE682D1, 0x9B05688C2B3E6C1F,
    0x1F83D9ABFB41BD6B, 0x5BE0CD19137E2179,
)
# parameter block word 0: digest length 64, no key, fanout 1, depth 1
_H0 = (_IV[0] ^ 0x01010040,) + _IV[1:]

# message schedule (RFC 7693 section 2.7); rounds 10, 11 reuse rows 0, 1
_SIGMA = np.array(
    [
        [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15],
        [14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3],
        [11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4],
        [7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8],
        [9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13],
        [2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9],
        [12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11],
        [13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10],
        [6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5],
        [10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0],
        [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15],
        [14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3],
    ],
    dtype=np.int64,
)

M32 = 0xFFFFFFFF


# -----------------------------------------------------------------------------
# Plain versions: (hi, lo) halves in int64, the four G mixes of a half-round
# vectorised as rows of a [4, n] state
# -----------------------------------------------------------------------------


def _add64(a, b):
    ah, al = a
    bh, bl = b
    lo = al + bl
    return (ah + bh + (lo >> 32)) & M32, lo & M32


def _xor(a, b):
    return a[0] ^ b[0], a[1] ^ b[1]


def _ror64(x, r: int):
    h, l = x
    if r == 32:
        return l, h
    if r < 32:
        return ((h >> r) | (l << (32 - r))) & M32, ((l >> r) | (h << (32 - r))) & M32
    # r == 63: rotate left by 1
    return ((h << 1) | (l >> 31)) & M32, ((l << 1) | (h >> 31)) & M32


def _g(a, b, c, d, x, y):
    a = _add64(_add64(a, b), x)
    d = _ror64(_xor(d, a), 32)
    c = _add64(c, d)
    b = _ror64(_xor(b, c), 24)
    a = _add64(_add64(a, b), y)
    d = _ror64(_xor(d, a), 16)
    c = _add64(c, d)
    b = _ror64(_xor(b, c), 63)
    return a, b, c, d


def _roll(x, k: int):
    return torch.roll(x[0], -k, 0), torch.roll(x[1], -k, 0)


@functools.lru_cache(maxsize=None)
def _sigma(device: str) -> torch.Tensor:
    return torch.from_numpy(_SIGMA).to(device)


def _words(vals, like: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    n = like.shape[-1]
    h = torch.tensor([v >> 32 for v in vals], dtype=L.DTYPE, device=like.device)
    l = torch.tensor([v & M32 for v in vals], dtype=L.DTYPE, device=like.device)
    return h[:, None].expand(len(vals), n), l[:, None].expand(len(vals), n)


def compress_plain(mh, ml, t) -> tuple[torch.Tensor, torch.Tensor]:
    """Final-block BLAKE2b-512 compressions: message words mh, ml [16, n]
    (hi, lo halves), byte counts t [n] -> digest words (hi, lo) [8, n]."""
    h0 = _words(_H0, mh)
    iv = _words(_IV, mh)
    v_hi = torch.cat([h0[0], iv[0]]).clone()
    v_lo = torch.cat([h0[1], iv[1]]).clone()
    v_lo[12] ^= t & M32
    v_hi[12] ^= t >> 32
    v_hi[14] ^= M32
    v_lo[14] ^= M32
    a, b, c, d = ((v_hi[4 * r : 4 * r + 4], v_lo[4 * r : 4 * r + 4]) for r in range(4))
    sigma = _sigma(str(mh.device))
    for r in range(12):
        s = sigma[r]
        x = (mh[s[0:8:2]], ml[s[0:8:2]])
        y = (mh[s[1:8:2]], ml[s[1:8:2]])
        a, b, c, d = _g(a, b, c, d, x, y)
        # diagonal step as a column step on rows rotated by 1, 2, 3
        b, c, d = _roll(b, 1), _roll(c, 2), _roll(d, 3)
        x = (mh[s[8:16:2]], ml[s[8:16:2]])
        y = (mh[s[9:16:2]], ml[s[9:16:2]])
        a, b, c, d = _g(a, b, c, d, x, y)
        b, c, d = _roll(b, -1), _roll(c, -2), _roll(d, -3)
    out_hi = h0[0] ^ torch.cat([a[0], b[0]]) ^ torch.cat([c[0], d[0]])
    out_lo = h0[1] ^ torch.cat([a[1], b[1]]) ^ torch.cat([c[1], d[1]])
    return out_hi, out_lo


def _words_to_bytes(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """Digest words [8, n] -> uint8[n, 64], little-endian per 64-bit word."""
    shifts = torch.arange(0, 32, 8, device=hi.device)
    w = torch.stack([lo, hi], dim=-1)  # [8, n, 2]
    b = (w.unsqueeze(-1) >> shifts) & 0xFF  # [8, n, 2, 4]
    return b.permute(1, 0, 2, 3).reshape(hi.shape[1], 64).to(torch.uint8)


def _bytes_to_words(b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """uint8[n, 8k] -> (hi, lo) [k, n] halves of little-endian 64-bit words."""
    n = b.shape[0]
    shifts = torch.arange(0, 32, 8, device=b.device)
    x = b.to(L.DTYPE).reshape(n, -1, 2, 4) << shifts
    w = x.sum(-1)  # [n, k, 2]: (lo, hi)
    return w[..., 1].T.contiguous(), w[..., 0].T.contiguous()


_DECIMAL_GROUP = 10**9


@functools.lru_cache(maxsize=None)
def _pow10(device: str) -> torch.Tensor:
    return torch.tensor([10**q for q in range(9)], dtype=L.DTYPE, device=device)


def leaf_messages(canon: torch.Tensor):
    """Canonical limbs [n, 8] -> (mh, ml [16, n], t [n]): the decimal string,
    left-aligned, packed little-endian into the message words."""
    n = canon.shape[0]
    dev = canon.device
    words = canon[:, 0::2] | (canon[:, 1::2] << 16)  # [n, 4] of 32 bits
    groups = []
    for _ in range(5):  # 10^45 > 2^128
        rem = torch.zeros(n, dtype=L.DTYPE, device=dev)
        cols = []
        for k in reversed(range(4)):
            cur = (rem << 32) | words[:, k]
            q = cur // _DECIMAL_GROUP
            rem = cur - q * _DECIMAL_GROUP
            cols.append(q)
        words = torch.stack(cols[::-1], dim=1)
        groups.append(rem)
    g = torch.stack(groups, dim=1)  # [n, 5], least significant first
    digits = ((g.unsqueeze(-1) // _pow10(str(dev))) % 10).reshape(n, 45)
    pos = torch.arange(1, 46, device=dev)
    length = torch.where(digits != 0, pos, torch.ones_like(pos)).amax(dim=1)
    j = torch.arange(40, device=dev)
    src = (length.unsqueeze(1) - 1 - j).clamp(min=0)
    msg = torch.where(
        j < length.unsqueeze(1), digits.gather(1, src) + ord("0"), torch.zeros_like(src)
    )
    mh5, ml5 = _bytes_to_words(msg)
    zeros = torch.zeros((11, n), dtype=L.DTYPE, device=dev)
    return torch.cat([mh5, zeros]), torch.cat([ml5, zeros]), length


def leaf_digests_plain(canon: torch.Tensor) -> torch.Tensor:
    """Canonical limbs [n, 8] -> uint8[n, 64] leaf digests (tensor code)."""
    mh, ml, t = leaf_messages(canon)
    return _words_to_bytes(*compress_plain(mh, ml, t))


def node_digests_plain(level: torch.Tensor) -> torch.Tensor:
    """uint8[2m, 64] natural-order level -> uint8[m, 64] parents."""
    m = level.shape[0] // 2
    mh, ml = _bytes_to_words(level.reshape(m, 128))
    t = torch.full((m,), 128, dtype=L.DTYPE, device=level.device)
    return _words_to_bytes(*compress_plain(mh, ml, t))


def tree_plain(leaves: torch.Tensor) -> torch.Tensor:
    """Leaf digests uint8[n, 64] (n a power of two) -> the inner levels
    uint8[n - 1, 64], one :func:`node_digests_plain` a level."""
    levels = [leaves.new_empty((0, 64))]
    level = leaves
    while level.shape[0] > 1:
        level = node_digests_plain(level)
        levels.append(level)
    return torch.cat(levels)


def level_start(n: int, j: int) -> int:
    """The row of level j >= 1 (n >> j digests) in a tree's inner levels."""
    return n - (n >> (j - 1))


def tree_launches(n: int) -> list[tuple[int, int]]:
    """(level, k) of each node launch of a tree of n = 2^L leaves: from
    level ``level`` (n >> level digests; the leaves are level 0), k levels
    up.  The fewest launches, ceil(L / TREE_LEVELS), the levels shared out
    evenly and the first launches the deeper, so that the last launch (one
    block) takes the fewest children."""
    depth = n.bit_length() - 1
    count = -(-depth // TREE_LEVELS)
    out, level = [], 0
    for i in range(count):
        k = depth // count + (i < depth % count)
        out.append((level, k))
        level += k
    return out


def split_levels(leaves: torch.Tensor, inner: torch.Tensor) -> list[torch.Tensor]:
    """[leaves, level 1, ..., root]: the inner levels as views of ``inner``."""
    n = leaves.shape[0]
    depth = n.bit_length() - 1
    return [leaves] + [inner[level_start(n, j) : level_start(n, j + 1)]
                       for j in range(1, depth + 1)]


# -----------------------------------------------------------------------------
# Kernels and the dispatching entry points
# -----------------------------------------------------------------------------


def leaf_kernel(canon: torch.Tensor) -> torch.Tensor:
    n = canon.shape[0]
    _build.check_cuda_tensor(canon, "leaf canon", L.DTYPE, (n, L.NLIMB))
    canon = _aligned(canon)
    out = torch.empty((n, 64), dtype=torch.uint8, device=canon.device)
    if n:
        LEAF_KERNEL(canon.data_ptr(), out.data_ptr(), n, _build.stream_ptr(canon.device))
    return out


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it where it starts off the 16-byte grid that the
    kernels' bulk copies and vector loads read."""
    return t.clone() if t.data_ptr() & 15 else t


def node_kernel(level: torch.Tensor) -> torch.Tensor:
    """One level: the node kernel asked for one level (blocks of
    2^LEVEL_SPAN_LOG2 children, the last one partly full)."""
    n = level.shape[0]
    if n % 2:
        raise ValueError(f"node_kernel: odd level size {n}")
    _build.check_cuda_tensor(level, "node level", torch.uint8, (n, 64))
    level = _aligned(level)
    out = torch.empty((n // 2, 64), dtype=torch.uint8, device=level.device)
    if n:
        NODE_KERNEL(level.data_ptr(), out.data_ptr(), n, LEVEL_SPAN_LOG2, 1, LEVEL_THREADS,
                    _build.stream_ptr(level.device))
    return out


def tree_kernel(leaves: torch.Tensor) -> torch.Tensor:
    """The node kernel's launches of :func:`tree_launches`; same contract as
    :func:`tree_plain`."""
    n = leaves.shape[0]
    if n < 1 or n & (n - 1) or n > L.MAX_KERNEL_ELEMENTS:
        raise ValueError(f"tree_kernel: {n} leaves is not a power of two below 2^31")
    _build.check_cuda_tensor(leaves, "tree leaves", torch.uint8, (n, 64))
    inner = torch.empty((n - 1, 64), dtype=torch.uint8, device=leaves.device)
    leaves = _aligned(leaves)
    stream = _build.stream_ptr(leaves.device)
    for level, k in tree_launches(n):
        src = leaves if level == 0 else inner[level_start(n, level)]
        NODE_KERNEL(src.data_ptr(), inner[level_start(n, level + 1)].data_ptr(), n >> level,
                    k, k, NODE_THREADS, stream)
    return inner


def leaf_digests(canon: torch.Tensor) -> torch.Tensor:
    """Canonical limbs [n, 8] -> uint8[n, 64] leaf digests."""
    if canon.is_cuda:
        return leaf_kernel(canon)
    _build.check_device(canon, "leaf_digests")
    return leaf_digests_plain(canon)


def node_digests(level: torch.Tensor) -> torch.Tensor:
    """uint8[2m, 64] level (natural order) -> uint8[m, 64] parents."""
    if level.is_cuda:
        return node_kernel(level)
    _build.check_device(level, "node_digests")
    return node_digests_plain(level)


def tree_digests(leaves: torch.Tensor) -> torch.Tensor:
    """Leaf digests uint8[n, 64] (n a power of two) -> the inner levels
    uint8[n - 1, 64]: level 1 first, the root last."""
    if leaves.is_cuda:
        return tree_kernel(leaves)
    _build.check_device(leaves, "tree_digests")
    return tree_plain(leaves)


def compress_kernel(mh: torch.Tensor, ml: torch.Tensor, t: torch.Tensor):
    """Launch ``compress_kernel``; same contract as :func:`compress_plain`."""
    n = t.shape[0]
    _build.check_cuda_tensor(mh, "compress mh", L.DTYPE, (16, n))
    _build.check_cuda_tensor(ml, "compress ml", L.DTYPE, (16, n))
    _build.check_cuda_tensor(t, "compress t", L.DTYPE, (n,))
    oh = torch.empty((8, n), dtype=L.DTYPE, device=t.device)
    ol = torch.empty_like(oh)
    if n:
        COMPRESS_KERNEL(mh.data_ptr(), ml.data_ptr(), t.data_ptr(), oh.data_ptr(),
                        ol.data_ptr(), n, _build.stream_ptr(t.device))
    return oh, ol


def compress_words(mh: torch.Tensor, ml: torch.Tensor, t: torch.Tensor):
    """Final-block compressions: message words (hi, lo) [16, n] and byte
    counts t [n], 0 <= t <= 128 -> digest words (hi, lo) [8, n]
    (``blake2b_dev._compress_words``)."""
    if t.is_cuda:
        return compress_kernel(mh, ml, t)
    _build.check_device(t, "compress_words")
    return compress_plain(mh, ml, t)


def node_digests_packed(d: torch.Tensor) -> torch.Tensor:
    """Packed digest level [2, 8, 2m] (hi, lo words) -> parents [2, 8, m]:
    parent i hashes children 2i || 2i+1, whose words are its message."""
    m = d.shape[2] // 2
    mh = torch.cat([d[0, :, 0::2], d[0, :, 1::2]]).contiguous()
    ml = torch.cat([d[1, :, 0::2], d[1, :, 1::2]]).contiguous()
    t = torch.full((m,), 128, dtype=L.DTYPE, device=d.device)
    return torch.stack(compress_words(mh, ml, t))


def leaf_digest_words(canon: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Canonical limbs [n, 8] -> leaf digest words (hi, lo) [8, n]."""
    return _bytes_to_words(leaf_digests(canon))


def node_digest_words(hhi: torch.Tensor, hlo: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Digest words (hi, lo) [8, 2m] -> parent words (hi, lo) [8, m]."""
    d = node_digests_packed(torch.stack([hhi, hlo]))
    return d[0], d[1]


def words_to_digest_np(hhi, hlo) -> np.ndarray:
    """Digest words (hi, lo) [8, n] -> uint8[n, 64] little-endian bytes."""
    hhi = torch.as_tensor(hhi, dtype=L.DTYPE)
    hlo = torch.as_tensor(hlo, dtype=L.DTYPE, device=hhi.device)
    return _words_to_bytes(hhi, hlo).cpu().numpy()
