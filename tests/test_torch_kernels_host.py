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
from zk_stark_tpu_torch.ops import blake2b as B
from zk_stark_tpu_torch.ops import fold as FO
from zk_stark_tpu_torch.ops import limbs as L
from zk_stark_tpu_torch.ops import ntt as N

CSRC = pathlib.Path(__file__).resolve().parent.parent / "zk_stark_tpu_torch" / "csrc"
F = Field()

_HARNESS = r"""
#include <stdint.h>
struct Dim { unsigned x, y; };
static Dim threadIdx, blockIdx, blockDim;
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__
static inline void __syncthreads() {}
#include "ntt.cu"
Fe4 sh[1 << 12];
#include "fold.cu"
#include "blake2b.cu"

static void grid(unsigned blocks) { blockDim.x = 1; threadIdx.x = 0; blockIdx.y = 0; (void)blocks; }
extern "C" void host_ntt(const int64_t* x, int64_t* y, const uint32_t* tw, const uint32_t* ft,
                         int log2n, int gx, int gy, long long ibx, long long iby, long long ie,
                         long long obx, long long oby, long long oe) {
  grid(gx);
  for (int by = 0; by < gy; ++by)
    for (int bx = 0; bx < gx; ++bx) {
      blockIdx.x = bx; blockIdx.y = by;
      ntt_stages_kernel(x, y, tw, ft, log2n, Strides{ibx, iby, ie}, Strides{obx, oby, oe});
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
    lib.host_ntt.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_longlong] * 6
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
