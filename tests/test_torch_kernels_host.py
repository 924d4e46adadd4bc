"""The CUDA kernel sources' arithmetic, run on the CPU.

There is no nvcc here, so each ``csrc/*.cu`` is compiled with the host C++
compiler under a thin emulation of the CUDA keywords (one thread per block,
blocks run one after another, barriers are no-ops; the launch wrappers sit
under ``#ifdef __CUDACC__`` and drop out) and its kernels are compared with
the plain PyTorch versions.  On the card, chip_smoke.py makes the same
comparison with the real compiler.
"""

import ctypes
import hashlib
import pathlib
import shutil
import subprocess

import numpy as np
import pytest
import torch

from zk_stark_tpu_torch.field import FIELD_PRIME as P
from zk_stark_tpu_torch.field import Field
from zk_stark_tpu_torch.models.rescue_prime import RescuePrime
from zk_stark_tpu_torch.ops import blake2b as B
from zk_stark_tpu_torch.ops import fold as FO
from zk_stark_tpu_torch.ops import limbs as L
from zk_stark_tpu_torch.ops import montmul_chain as MC
from zk_stark_tpu_torch.ops import ntt as N
from zk_stark_tpu_torch.ops import ntt_variants as V
from zk_stark_tpu_torch.ops import rescue_ops as R

CSRC = pathlib.Path(__file__).resolve().parent.parent / "zk_stark_tpu_torch" / "csrc"
F = Field()

_HARNESS = r"""
#include <stdint.h>
struct Dim { unsigned x, y, z; };
static Dim threadIdx, blockIdx, blockDim;
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__
static inline void __syncthreads() {}
#include "ntt.cu"
#include "ntt_variants.cu"
Fe4 sh[1 << 13];
#include "fold.cu"
#include "blake2b.cu"
#include "rescue.cu"
uint32_t rescue_smem[1 << 14];
#include "montmul_chain.cu"

static void grid(unsigned blocks) {
  blockDim.x = 1; threadIdx.x = 0; blockIdx.y = blockIdx.z = 0; (void)blocks;
}
extern "C" void host_ntt(const int64_t* x, int64_t* y, const uint32_t* tw, const uint32_t* ft,
                         int log2n, int gx, int gy, int gz, long long ibx, long long iby,
                         long long ibz, long long ie, long long obx, long long oby,
                         long long obz, long long oe) {
  grid(gx);
  for (int bz = 0; bz < gz; ++bz)
    for (int by = 0; by < gy; ++by)
      for (int bx = 0; bx < gx; ++bx) {
        blockIdx.x = bx; blockIdx.y = by; blockIdx.z = bz;
        ntt_stages_kernel(x, y, tw, ft, log2n, Strides{ibx, iby, ibz, ie},
                          Strides{obx, oby, obz, oe});
      }
}
extern "C" void host_variant(char which, const int64_t* x, int64_t* y, const uint32_t* tw,
                             int log2n, int c) {
  grid(c);
  for (int b = 0; b < c; ++b) {
    blockIdx.x = b;
    if (which == 'a') ntt_variant_a(x, y, tw, log2n, c);
    if (which == 'b') ntt_variant_b(x, y, tw, log2n, c);
    if (which == 'c') ntt_variant_c(x, y, tw, log2n, c);
  }
}
extern "C" void host_fold(const int64_t* cw, const int64_t* ip, const int64_t* ao,
                          const int64_t* ti, int64_t* f, int64_t* c, int half) {
  grid(half);
  for (int i = 0; i < half; ++i) { blockIdx.x = i; fold_kernel(cw, ip, ao, ti, f, c, half); }
}
extern "C" void host_leaf(const int64_t* canon, uint8_t* out, int n) {
  grid(n);
  for (int i = 0; i < n; ++i) { blockIdx.x = i; leaf_kernel(canon, out, n); }
}
extern "C" void host_node(const uint8_t* level, uint8_t* out, int m) {
  grid(m);
  for (int i = 0; i < m; ++i) { blockIdx.x = i; node_kernel(level, out, m); }
}
extern "C" void host_compress(const int64_t* mh, const int64_t* ml, const int64_t* t,
                              int64_t* oh, int64_t* ol, int n) {
  grid(n);
  for (int i = 0; i < n; ++i) { blockIdx.x = i; compress_kernel(mh, ml, t, oh, ol, n); }
}
extern "C" void host_rescue(const int64_t* st, int64_t* out, const int64_t* mds,
                            const int64_t* rc, int n, int rounds, const uint32_t* a, int a_bits,
                            const uint32_t* ai, int ai_bits) {
  grid(n);
  Exp alpha{{a[0], a[1], a[2], a[3]}, a_bits}, alpha_inv{{ai[0], ai[1], ai[2], ai[3]}, ai_bits};
  for (int i = 0; i < n; ++i) {
    blockIdx.x = i;
    rescue_kernel(st, out, mds, rc, n, rounds, alpha, alpha_inv);
  }
}
extern "C" void host_chain(const int64_t* x, int64_t* y, int n, int k) {
  grid(n);
  for (int i = 0; i < n; ++i) { blockIdx.x = i; montmul_chain_kernel(x, y, n, k); }
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to emulate the CUDA sources with")
    out = tmp_path_factory.mktemp("kernels_host")
    src = out / "harness.cpp"
    src.write_text(_HARNESS)
    so = out / "libharness.so"
    subprocess.run(
        [cxx, "-O1", "-std=c++17", "-shared", "-fPIC", "-Wno-unknown-pragmas",
         f"-I{CSRC}", "-o", str(so), str(src)],
        check=True, capture_output=True, timeout=120,
    )
    lib = ctypes.CDLL(str(so))
    lib.host_ntt.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 8
    lib.host_variant.argtypes = [ctypes.c_char] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
    lib.host_compress.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int]
    words = ctypes.POINTER(ctypes.c_uint32)
    lib.host_rescue.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
                                + [words, ctypes.c_int, words, ctypes.c_int])
    lib.host_chain.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
    return lib


def _ptrs(*tensors):
    return [ctypes.c_void_p(t.data_ptr()) for t in tensors]


def _rand_mont(seed, n):
    rng = np.random.default_rng(seed)
    hi = rng.integers(0, 1 << 63, size=n, dtype=np.uint64)
    lo = rng.integers(0, 1 << 63, size=n, dtype=np.uint64)
    return L.ints_to_mont([(int(h) << 63 | int(l)) % P for h, l in zip(hi, lo)], "cpu")


def _ntt_source(lib, x, root):
    """The passes ntt_kernel launches on the card (N.kernel_passes: the
    same tables, grids and strides), run through the emulated source;
    returns the output and the kernels of the passes."""
    n, batch = x.shape[0], x[0].numel() // L.NLIMB
    src, kernels = x, []
    for p in N.kernel_passes(n, batch, root):
        tw, ft = N.pass_tables(p, "cpu")
        dst = torch.empty_like(x)
        lib.host_ntt(src.data_ptr(), dst.data_ptr(), tw.data_ptr(),
                     None if ft is None else ft.data_ptr(),
                     p.m.bit_length() - 1, *p.grid, *p.ins, *p.outs)
        src = dst
        kernels.append(p.kernel)
    return src, kernels


@pytest.mark.parametrize("n", [2, 16, 512, 4096])
def test_ntt_kernel_source(lib, n):
    root = F.primitive_nth_root(n).value
    x = _rand_mont(n, 2 * n).reshape(n, 2, L.NLIMB)
    y, kernels = _ntt_source(lib, x, root)
    assert kernels == [N.NTT_KERNEL]
    assert torch.equal(y, N.ntt_plain(x, root))


@pytest.mark.parametrize("n, max_kernel_n", [(1 << 13, 1 << 12), (1 << 9, 1 << 5)])
def test_ntt_fused_twiddle_source(lib, monkeypatch, n, max_kernel_n):
    """The four-step's two passes, the first in the fused-twiddle mode,
    equal the flat plain transform: 2^13 = 2^7 x 2^6, and 2^9 = 2^5 x 2^4
    with the single-block limit lowered to 2^5."""
    monkeypatch.setattr(N, "MAX_KERNEL_N", max_kernel_n)
    root = F.primitive_nth_root(n).value
    x = _rand_mont(n + 1, 3 * n).reshape(n, 3, L.NLIMB)
    y, kernels = _ntt_source(lib, x, root)
    assert kernels == [N.NTT_TW_KERNEL, N.NTT_KERNEL]
    assert torch.equal(y, N.ntt_plain(x, root))
    inv = pow(root, -1, P)
    assert torch.equal(_ntt_source(lib, x, inv)[0], N.ntt_plain(x, inv))


@pytest.mark.parametrize("n, batch", [(1 << 8, 3), (1 << 9, 1)])
def test_ntt_three_pass_source(lib, monkeypatch, n, batch):
    """Above the four-step's reach the three passes (the second in the
    fused-twiddle mode, batch columns on the grid's z index) equal the flat
    plain transform, forward and inverse: with the single-block limit
    lowered to 2^3, 2^8 = 8 x (8 x 4) and 2^9 = 8 x (8 x 8)."""
    monkeypatch.setattr(N, "MAX_KERNEL_N", 1 << 3)
    root = F.primitive_nth_root(n).value
    x = _rand_mont(n + 2, batch * n).reshape(n, batch, L.NLIMB)
    y, kernels = _ntt_source(lib, x, root)
    assert kernels == [N.NTT_TW_KERNEL, N.NTT_LONG_TW_KERNEL, N.NTT_LONG_KERNEL]
    assert torch.equal(y, N.ntt_plain(x, root))
    inv = pow(root, -1, P)
    assert torch.equal(_ntt_source(lib, x, inv)[0], N.ntt_plain(x, inv))


@pytest.mark.parametrize("which", V.VARIANTS)
@pytest.mark.parametrize("n", [8, 64, 1024])
def test_ntt_variant_sources(lib, which, n):
    """The probe's three stage kernels on 3 transforms of bit-reversed rows
    equal the plain stages (and so each other)."""
    c = 3
    root = F.primitive_nth_root(n).value
    x = _rand_mont(n + 3, n * c).reshape(n, c, L.NLIMB)
    tw = V.stage_major_table(root, n, "cpu") if which == "b" else N._twiddles_u32(root, n, "cpu")
    y = torch.empty_like(x)
    lib.host_variant(which.encode(), *_ptrs(x, y, tw), n.bit_length() - 1, c)
    assert torch.equal(y, V.stages_plain(x, root))


def test_fold_kernel_source(lib):
    n = 512
    cw = _rand_mont(1, n)
    ip = _rand_mont(2, n // 2)
    ao = _rand_mont(3, 1)[0]
    ti = L.int_to_mont(pow(2, -1, P), "cpu")
    folded = torch.empty((n // 2, L.NLIMB), dtype=L.DTYPE)
    canon = torch.empty_like(folded)
    lib.host_fold(*_ptrs(cw, ip, ao, ti, folded, canon), n // 2)
    want_f, want_c = FO.fold_plain(cw, ip, ao, ti)
    assert torch.equal(folded, want_f) and torch.equal(canon, want_c)


def test_leaf_and_node_kernel_sources(lib):
    vals = [0, 1, 9, 10, 99, 100, P - 1, 10**38, 10**38 - 1, 10**37, (1 << 128) - 1]
    vals += [int(v) for v in L.mont_to_ints(_rand_mont(4, 117))]
    canon = L.from_numpy(L.ints_to_limbs(vals), "cpu")
    leaves = torch.empty((len(vals), 64), dtype=torch.uint8)
    lib.host_leaf(*_ptrs(canon, leaves), len(vals))
    assert torch.equal(leaves, B.leaf_digests_plain(canon))
    assert leaves[7].numpy().tobytes() == hashlib.blake2b(
        str(vals[7]).encode(), digest_size=64
    ).digest()
    parents = torch.empty((len(vals) // 2, 64), dtype=torch.uint8)
    lib.host_node(*_ptrs(leaves, parents), len(vals) // 2)
    assert torch.equal(parents, B.node_digests_plain(leaves))


def test_compress_kernel_source(lib):
    """64 messages of random words, random byte counts in [0, 128], zero
    beyond each count."""
    n = 64
    rng = np.random.default_rng(5)
    t = rng.integers(0, 129, size=n)
    t[:3] = (0, 1, 128)
    raw = rng.integers(0, 256, size=(n, 128), dtype=np.uint8)
    raw[np.arange(128)[None, :] >= t[:, None]] = 0
    mh, ml = B._bytes_to_words(torch.from_numpy(raw))
    tt = torch.from_numpy(t.astype(np.int64))
    oh = torch.empty((8, n), dtype=L.DTYPE)
    ol = torch.empty_like(oh)
    lib.host_compress(*_ptrs(mh, ml, tt, oh, ol), n)
    want_h, want_l = B.compress_plain(mh, ml, tt)
    assert torch.equal(oh, want_h) and torch.equal(ol, want_l)


@pytest.mark.parametrize("k", [32, 37])
def test_montmul_chain_kernel_source(lib, k):
    x = _rand_mont(6, 64)
    y = torch.empty_like(x)
    lib.host_chain(*_ptrs(x, y), 64, k)
    assert torch.equal(y, MC.mont_mul_chain_plain(x, k))


@pytest.mark.parametrize(
    "alpha, alpha_inv, rounds",
    [(None, None, 27), (0, 77, 2), (5, (1 << 9) + 3, 2)],
    ids=["default-27-rounds", "alpha0-short-inverse", "9-bit-inverse"],
)
def test_rescue_kernel_source(lib, alpha, alpha_inv, rounds):
    """4 random full states through the rounds: the default instance's
    exponents over all 27, then exponents that reach the kernel's other
    branches (alpha = 0, an inverse exponent of 7 and of 10 bits)."""
    rp = RescuePrime(F)
    alpha = rp.alpha if alpha is None else alpha
    alpha_inv = rp.alpha_inv if alpha_inv is None else alpha_inv
    mds, rc = rp._device_constants("cpu")
    state = _rand_mont(7, 8).reshape(4, 2, L.NLIMB)
    out = torch.empty_like(state)
    a_words, a_bits = R._exponent(alpha, "alpha")
    ai_words, ai_bits = R._exponent(alpha_inv, "alpha_inv")
    lib.host_rescue(*_ptrs(state, out, mds, rc), 4, rounds, a_words, a_bits, ai_words, ai_bits)
    assert torch.equal(out, R.permutation_plain(state, mds, rc, rounds, alpha, alpha_inv))
