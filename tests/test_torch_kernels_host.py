"""The CUDA kernel sources' arithmetic, run on the CPU.

There is no nvcc here, so each ``csrc/*.cu`` is compiled with the host C++
compiler under a thin emulation of the CUDA keywords (blocks run one after
another; a block of one thread, where barriers are no-ops, or of several
threads, each a host thread with its own ``threadIdx`` and
``__syncthreads()`` a barrier over them; the launch wrappers sit under
``#ifdef __CUDACC__`` and drop out) and its kernels are compared with the
plain PyTorch versions.  On the card, chip_smoke.py makes the same
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

import chip_smoke
from zk_stark_tpu.ops import limbs as JL
from zk_stark_tpu_torch import merkle
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

_PRELUDE = r"""
#include <stdint.h>
#include <condition_variable>
#include <mutex>
#include <thread>
#include <vector>
struct Dim { unsigned x, y, z; };
static thread_local Dim threadIdx;
static Dim blockIdx, blockDim, gridDim;
// __syncthreads(): every thread of the block waits for all the others
struct Barrier {
  std::mutex m;
  std::condition_variable cv;
  unsigned count = 1, waiting = 0, phase = 0;
  void wait() {
    if (count <= 1) return;
    std::unique_lock<std::mutex> lk(m);
    const unsigned ph = phase;
    if (++waiting == count) { waiting = 0; ++phase; cv.notify_all(); }
    else cv.wait(lk, [&] { return phase != ph; });
  }
};
static Barrier block_barrier;
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__
#define __launch_bounds__(...)
struct alignas(16) longlong2 { long long x, y; };
static inline void __syncthreads() { block_barrier.wait(); }
// __shfl_sync within groups of `width` threads (a power of two up to 32):
// each group meets at its own barrier, so groups that skip a shuffle
// together (warps that skip a level, lanes of one warp) need not wait
static Barrier group_barrier[6][1024];
static uint64_t shfl_slot[1024];
template <class T> static T __shfl_sync(unsigned, T v, int src, int width) {
  const unsigned t = threadIdx.x, base = t & ~(unsigned)(width - 1);
  Barrier& b = group_barrier[__builtin_ctz((unsigned)width)][t / width];
  shfl_slot[t] = (uint64_t)v;
  b.wait();
  const T r = (T)shfl_slot[base + ((unsigned)src & (unsigned)(width - 1))];
  b.wait();
  return r;
}
"""
#: the variants of the stage-variant probe alone, with the launch runners
_VARIANT_HARNESS = r"""
#include "ntt_variants.cu"
Fe4 sh[1 << 14];
static void grid(unsigned blocks) {
  blockDim.x = 1; threadIdx.x = 0; blockIdx.y = blockIdx.z = 0; (void)blocks;
  block_barrier.count = 1;
}
// one block of `threads` threads, each a host thread
template <class F> static void run_block(unsigned threads, F body) {
  blockDim.x = threads;
  block_barrier.count = threads;
  for (unsigned w = 0; w < 6; ++w)
    for (unsigned g = 0; g < 1024; ++g) {
      const unsigned base = g << w, width = 1u << w;
      const unsigned left = base >= threads ? 1 : threads - base;
      group_barrier[w][g].count = left < width ? left : width;
    }
  std::vector<std::thread> ts;
  for (unsigned t = 0; t < threads; ++t)
    ts.emplace_back([=] { threadIdx.x = t; threadIdx.y = threadIdx.z = 0; body(); });
  for (auto& th : ts) th.join();
}
// one launch of the probe's variant b, c or d with ntt_launch's arguments:
// b and c on ntt.cu's grid of tiles, d on `blocks` resident blocks
extern "C" void host_variant(char which, const int64_t* x, int64_t* y, const uint32_t* tw,
                             int log2n, int gx, int gy, int gz, long long ibx, long long iby,
                             long long ibz, long long ie, long long obx, long long oby,
                             long long obz, long long oe, int dim, int log2_count,
                             int in_tmajor, int out_tmajor, int threads, int blocks) {
  int g[3] = {gx, gy, gz};
  const Tile tile{dim, log2_count, g[dim], in_tmajor, out_tmajor};
  g[dim] = (g[dim] + (1 << log2_count) - 1) >> log2_count;
  if (which == 'd') { g[0] = blocks; g[1] = g[2] = 1; }
  grid(g[0]);
  gridDim.x = g[0];
  const Strides in{ibx, iby, ibz, ie}, out{obx, oby, obz, oe};
  for (int bz = 0; bz < g[2]; ++bz)
    for (int by = 0; by < g[1]; ++by)
      for (int bx = 0; bx < g[0]; ++bx) {
        blockIdx.x = bx; blockIdx.y = by; blockIdx.z = bz;
        run_block(threads, [=] {
          if (which == 'b') ntt_variant_b(x, y, tw, log2n, in, out, tile);
          if (which == 'c') ntt_variant_c(x, y, tw, log2n, in, out, tile);
          if (which == 'd') ntt_variant_d(x, y, tw, log2n, in, out, tile);
        });
      }
}
"""
#: the chained product alone, with its runner
_CHAIN_HARNESS = r"""
#include "montmul_chain.cu"
// a grid of `blocks` blocks of `threads` threads (no barriers: each thread
// runs alone)
extern "C" void host_chain(const int64_t* x, int64_t* y, int n, int k, int blocks, int threads) {
  gridDim.x = blocks;
  blockDim.x = threads;
  blockIdx.y = blockIdx.z = 0;
  for (int b = 0; b < blocks; ++b)
    for (int t = 0; t < threads; ++t) {
      blockIdx.x = b; threadIdx.x = t;
      montmul_chain_kernel(x, y, n, k);
    }
}
"""
_HARNESS = _PRELUDE + _VARIANT_HARNESS + _CHAIN_HARNESS + r"""
#include "ntt.cu"
#include "fold.cu"
#include "blake2b.cu"
#include "rescue.cu"
uint32_t rescue_smem[1 << 14];
#include "limbs.cu"
#include "batch_inv.cu"
longlong2 leaf_smem[1 + 4 * 64];
longlong2 fold_smem[1 << 12];
longlong2 node_smem[1 << 12];
longlong2 limbs_smem[1 << 12];
longlong2 batch_inv_smem[3 * 32 + 1];

extern "C" void host_mont_mul(const int64_t* a, const int64_t* b, int64_t* out, int n) {
  for (int i = 0; i < n; ++i)
    zk::store_fe(out + 8 * i, zk::mont_mul(zk::load_fe(a + 8 * i), zk::load_fe(b + 8 * i)));
}

extern "C" void host_ntt(const int64_t* x, int64_t* y, const uint32_t* tw, const uint32_t* ft,
                         int log2n, int gx, int gy, int gz, long long ibx, long long iby,
                         long long ibz, long long ie, long long obx, long long oby,
                         long long obz, long long oe, int dim, int log2_count,
                         int in_tmajor, int out_tmajor, int threads) {
  int g[3] = {gx, gy, gz};
  const Tile tile{dim, log2_count, g[dim], in_tmajor, out_tmajor};
  g[dim] = (g[dim] + (1 << log2_count) - 1) >> log2_count;
  grid(g[0]);
  for (int bz = 0; bz < g[2]; ++bz)
    for (int by = 0; by < g[1]; ++by)
      for (int bx = 0; bx < g[0]; ++bx) {
        blockIdx.x = bx; blockIdx.y = by; blockIdx.z = bz;
        run_block(threads, [=] {
          ntt_stages_kernel(x, y, tw, ft, log2n, Strides{ibx, iby, ibz, ie},
                            Strides{obx, oby, obz, oe}, tile);
        });
      }
}
// a persistent grid of `blocks` blocks of `threads` threads over tiles of
// `tile` outputs (tile <= threads)
extern "C" void host_fold(const int64_t* cw, const int64_t* ip, const int64_t* ao,
                          const int64_t* ti, int64_t* f, int64_t* c, int half, int tile,
                          int blocks, int threads) {
  grid(blocks);
  gridDim.x = blocks;
  for (int b = 0; b < blocks; ++b) {
    blockIdx.x = b;
    run_block(threads, [=] { fold_kernel(cw, ip, ao, ti, f, c, half, tile); });
  }
}
// blocks of `threads` leaves (at most 64), the last one partial
extern "C" void host_leaf(const int64_t* canon, uint8_t* out, int n, int threads) {
  const int blocks = (n + threads - 1) / threads;
  grid(blocks);
  gridDim.x = blocks;
  for (int b = 0; b < blocks; ++b) {
    blockIdx.x = b;
    run_block(threads, [=] { leaf_kernel(canon, out, n); });
  }
}
// one launch of the node kernel: blocks of 2^span_log2 children (the last
// one partly full), `levels` levels, `threads` threads a block
extern "C" void host_node(const uint8_t* in, uint8_t* out, int m, int span_log2, int levels,
                          int threads) {
  const int blocks = (m + (1 << span_log2) - 1) >> span_log2;
  grid(blocks);
  gridDim.x = blocks;
  for (int b = 0; b < blocks; ++b) {
    blockIdx.x = b;
    run_block(threads, [=] { node_kernel(in, out, m, span_log2, levels); });
  }
}
extern "C" void host_compress(const int64_t* mh, const int64_t* ml, const int64_t* t,
                              int64_t* oh, int64_t* ol, int n) {
  grid(n);
  for (int i = 0; i < n; ++i) { blockIdx.x = i; compress_kernel(mh, ml, t, oh, ol, n); }
}
// blocks of `threads` threads (a multiple of the width m), m threads a state
template <int M>
static void rescue_blocks(const int64_t* st, int64_t* out, const int64_t* mds, const int64_t* rc,
                          int n, int rounds, const Chain& alpha, const Chain& alpha_inv,
                          int threads) {
  grid(n);
  for (int b = 0; b * threads < M * n; ++b) {
    blockIdx.x = b;
    run_block(threads, [&] { rescue_kernel<M>(st, out, mds, rc, n, rounds, alpha, alpha_inv); });
  }
}
extern "C" void host_rescue(const int64_t* st, int64_t* out, const int64_t* mds,
                            const int64_t* rc, int n, int m, int rounds, const uint32_t* a,
                            int a_len, const uint32_t* ai, int ai_len, int threads) {
  Chain alpha{a_len, {}}, alpha_inv{ai_len, {}};
  for (int k = 0; k < a_len; ++k) alpha.step[k] = a[k];
  for (int k = 0; k < ai_len; ++k) alpha_inv.step[k] = ai[k];
  switch (m) {
    case 2: rescue_blocks<2>(st, out, mds, rc, n, rounds, alpha, alpha_inv, threads); break;
    case 3: rescue_blocks<3>(st, out, mds, rc, n, rounds, alpha, alpha_inv, threads); break;
    case 4: rescue_blocks<4>(st, out, mds, rc, n, rounds, alpha, alpha_inv, threads); break;
    case 7: rescue_blocks<7>(st, out, mds, rc, n, rounds, alpha, alpha_inv, threads); break;
    case 8: rescue_blocks<8>(st, out, mds, rc, n, rounds, alpha, alpha_inv, threads); break;
  }
}
// a persistent grid of `blocks` blocks of `threads` threads over tiles of
// `tile` elements (at most 2 a thread), the plan as the launcher makes it
extern "C" void host_limbs(int op, const int64_t* a, const int64_t* b, int64_t* out, int64_t n,
                           int ndim, const int64_t* size, const int64_t* sa, const int64_t* sb,
                           const int64_t* div, int tile, int blocks, int threads) {
  const limbs::Plan p = limbs::make_plan(n, ndim, size, sa, sb, div, tile);
  grid(blocks);
  gridDim.x = blocks;
  for (int bx = 0; bx < blocks; ++bx) {
    blockIdx.x = bx;
    run_block(threads, [=] {
      if (op == 0) limbs_mont_mul_kernel(a, b, out, p);
      if (op == 1) limbs_add_mod_kernel(a, b, out, p);
      if (op == 2) limbs_sub_mod_kernel(a, b, out, p);
      if (op == 3) limbs_redc_kernel(a, a, out, p);
    });
  }
}
// one launch of the batch inversion: `blocks` blocks of `threads` threads,
// `per_thread` elements each (ops/limbs.py batch_inv_grid's launch)
extern "C" void host_batch_inv(const int64_t* a, int64_t* out, int64_t n, int64_t* totals,
                               const int64_t* inv_totals, int blocks, int threads,
                               int per_thread) {
  grid(blocks);
  gridDim.x = blocks;
  for (int bx = 0; bx < blocks; ++bx) {
    blockIdx.x = bx;
    run_block(threads, [=] {
      if (per_thread == 1) batch_inv_kernel_k1(a, out, n, totals, inv_totals);
      if (per_thread == 2) batch_inv_kernel_k2(a, out, n, totals, inv_totals);
      if (per_thread == 4) batch_inv_kernel_k4(a, out, n, totals, inv_totals);
      if (per_thread == 8) batch_inv_kernel_k8(a, out, n, totals, inv_totals);
    });
  }
}
// inverse.cuh's binary inversion, element by element
extern "C" void host_inv_binary(const int64_t* a, int64_t* out, int n) {
  for (int i = 0; i < n; ++i) zk::store_fe(out + 8 * i, zk::inv_binary(zk::load_fe(a + 8 * i)));
}
// the inversion kernel on a grid of `blocks` blocks of one thread each
// (a grid-stride loop over n elements)
extern "C" void host_inv(const int64_t* a, int64_t* out, int64_t n, int blocks) {
  grid(blocks);
  gridDim.x = blocks;
  for (int bx = 0; bx < blocks; ++bx) { blockIdx.x = bx; limbs_inv_kernel(a, out, n); }
}
"""


def _compile(out, harness, include_dirs):
    """Build ``harness`` with the host C++ compiler into ``out`` and load it
    (``include_dirs`` searched in order for the sources it includes)."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to emulate the CUDA sources with")
    src = out / "harness.cpp"
    src.write_text(harness)
    so = out / "libharness.so"
    subprocess.run(
        [cxx, "-O1", "-std=c++17", "-shared", "-fPIC", "-pthread", "-Wno-unknown-pragmas",
         *[f"-I{d}" for d in include_dirs], "-o", str(so), str(src)],
        check=True, capture_output=True, timeout=120,
    )
    return ctypes.CDLL(str(so))


def _variant_argtypes(lib):
    lib.host_variant.argtypes = ([ctypes.c_char] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                                 + [ctypes.c_longlong] * 8 + [ctypes.c_int] * 6)
    return lib


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    lib = _variant_argtypes(_compile(tmp_path_factory.mktemp("kernels_host"), _HARNESS, [CSRC]))
    lib.host_ntt.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 8
                             + [ctypes.c_int] * 5)
    lib.host_compress.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int]
    words = ctypes.POINTER(ctypes.c_uint32)
    lib.host_rescue.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                                + [words, ctypes.c_int, words, ctypes.c_int, ctypes.c_int])
    lib.host_mont_mul.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int]
    lib.host_chain.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
    index = ctypes.POINTER(ctypes.c_int64)
    lib.host_limbs.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 3
                               + [ctypes.c_int64, ctypes.c_int] + [index] * 4
                               + [ctypes.c_int] * 3)
    lib.host_leaf.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
    lib.host_fold.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
    lib.host_node.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
    lib.host_inv.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int64, ctypes.c_int]
    lib.host_inv_binary.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int]
    lib.host_batch_inv.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int64] + [ctypes.c_void_p] * 2
                                   + [ctypes.c_int] * 3)
    return lib


def _ptrs(*tensors):
    return [ctypes.c_void_p(t.data_ptr()) for t in tensors]


def _rand_mont(seed, n):
    rng = np.random.default_rng(seed)
    hi = rng.integers(0, 1 << 63, size=n, dtype=np.uint64)
    lo = rng.integers(0, 1 << 63, size=n, dtype=np.uint64)
    return L.ints_to_mont([(int(h) << 63 | int(l)) % P for h, l in zip(hi, lo)], "cpu")


def _ntt_source(lib, x, root, blocks=None, threads=1):
    """The passes ntt_kernel launches on the card (N.kernel_passes: the
    same tables, grids and strides; N.block_shape: the same tiles), run
    through the emulated source with ``threads`` threads a block; returns
    the output and the kernels of the passes (and appends each pass's block
    shape to ``blocks``)."""
    n, batch = x.shape[0], x[0].numel() // L.NLIMB
    src, kernels = x, []
    for p in N.kernel_passes(n, batch, root):
        tw, ft = N.pass_tables(p, "cpu")
        blk = N.block_shape(p)
        dst = torch.empty_like(x)
        lib.host_ntt(src.data_ptr(), dst.data_ptr(), tw.data_ptr(),
                     None if ft is None else ft.data_ptr(),
                     p.m.bit_length() - 1, *p.grid, *p.ins, *p.outs, blk.dim, blk.log2_count,
                     int(blk.in_tmajor), int(blk.out_tmajor), threads)
        src = dst
        kernels.append(p.kernel)
        if blocks is not None:
            blocks.append((p, blk))
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


@pytest.mark.parametrize(
    "n, batch, max_kernel_n, tile, threads",
    [(16, 5, 1 << 12, 1 << 5, 1), (1 << 8, 3, 1 << 5, 1 << 6, 1), (1 << 9, 3, 1 << 3, 1 << 5, 1),
     (1 << 9, 1, 1 << 3, 1 << 4, 1), (1 << 7, 5, 1 << 12, 1 << 8, 3), (1 << 8, 3, 1 << 4, 1 << 6, 5)],
    ids=["one-pass", "four-step", "three-pass", "three-pass-batch-1", "one-pass-3-threads",
         "four-step-5-threads"],
)
def test_ntt_block_shapes_source(lib, monkeypatch, n, batch, max_kernel_n, tile, threads):
    """Every plan with tiles of several transforms, with a batch of 3 or 5
    that leaves a ragged last block (the transforms along the tile's index
    not a multiple of its count), the block limits lowered so that small
    sizes reach them, forward and inverse, against the flat plain
    transform; with blocks of one thread, and of 3 or 5 threads that share
    the tile's chunks and butterflies unevenly between barriers."""
    monkeypatch.setattr(N, "MAX_KERNEL_N", max_kernel_n)
    monkeypatch.setattr(N, "TILE_ELEMS", tile)
    root = F.primitive_nth_root(n).value
    x = _rand_mont(n + 5, batch * n).reshape(n, batch, L.NLIMB)
    blocks = []
    y, _ = _ntt_source(lib, x, root, blocks, threads)
    assert torch.equal(y, N.ntt_plain(x, root))
    inv = pow(root, -1, P)
    assert torch.equal(_ntt_source(lib, x, inv, threads=threads)[0], N.ntt_plain(x, inv))
    counts = [(1 << blk.log2_count, p.grid[blk.dim]) for p, blk in blocks]
    assert any(c > 1 for c, _ in counts), counts
    if batch > 1:  # a batch of 1 leaves every extent a power of two
        assert any(extent % c for c, extent in counts), counts
    assert all(blk.threads <= N.LONE_BLOCK_THREADS for _, blk in blocks)


def test_mont_mul_source(lib):
    """The product of field.cuh (its host branch) against Python integers:
    every pair of {0, 1, p-1, p-2}, then 4096 seeded random pairs."""
    edge = [0, 1, P - 1, P - 2]
    rng = np.random.default_rng(11)
    rand = [int(h) << 64 | int(lo) for h, lo in zip(rng.integers(0, 1 << 63, 8192, dtype=np.uint64),
                                                    rng.integers(0, 1 << 63, 8192, dtype=np.uint64))]
    a_vals = [a for a in edge for _ in edge] + [v % P for v in rand[:4096]]
    b_vals = [b for _ in edge for b in edge] + [v % P for v in rand[4096:]]
    a = L.from_numpy(L.ints_to_limbs(a_vals), "cpu")
    b = L.from_numpy(L.ints_to_limbs(b_vals), "cpu")
    out = torch.empty_like(a)
    lib.host_mont_mul(*_ptrs(a, b, out), len(a_vals))
    r_inv = pow(1 << 128, -1, P)
    assert list(L.limbs_to_ints(out)) == [x * y * r_inv % P for x, y in zip(a_vals, b_vals)]


@pytest.mark.parametrize("blocks", [1, 7])
def test_inv_kernel_source(lib, blocks):
    """limbs.cu's inversion (the fixed addition chain for a^(p-2)) against
    Python's pow(a, -1, p) on 0, 1, p-1, p-2 and seeded random values (in
    Montgomery form in and out), over a grid-stride loop of 1 and 7 blocks."""
    rng = np.random.default_rng(12)
    rand = [int(h) << 64 | int(lo) for h, lo in zip(rng.integers(0, 1 << 63, 60, dtype=np.uint64),
                                                    rng.integers(0, 1 << 63, 60, dtype=np.uint64))]
    vals = [0, 1, P - 1, P - 2] + [v % P for v in rand]
    a = L.ints_to_mont(vals, "cpu")
    out = torch.full_like(a, -1)
    lib.host_inv(*_ptrs(a, out), len(vals), blocks)
    assert [int(v) for v in L.mont_to_ints(out)] == [pow(v, -1, P) if v else 0 for v in vals]
    assert torch.equal(out, L.mont_inv_fermat_plain(a))


def test_inv_binary_source(lib):
    """inverse.cuh's binary extended Euclid (the batch inversion's root)
    against Python's pow(a, -1, p) and the Fermat chain's plain version on
    0, 1, p-1, p-2, R mod p, 2^k (k < 128: its runs of zeros, a whole word
    of them among them) and 4096 seeded random elements, as stored limbs."""
    rng = np.random.default_rng(13)
    rand = [int(h) << 64 | int(lo) for h, lo in zip(rng.integers(0, 1 << 63, 4096, dtype=np.uint64),
                                                    rng.integers(0, 1 << 63, 4096, dtype=np.uint64))]
    vals = [0, 1, P - 1, P - 2, L.R_INT] + [1 << k for k in range(128)] + [v % P for v in rand]
    a = L.from_numpy(L.ints_to_limbs(vals), "cpu")
    out = torch.full_like(a, -1)
    lib.host_inv_binary(*_ptrs(a, out), len(vals))
    r2 = L.R_INT * L.R_INT % P
    assert [int(v) for v in L.limbs_to_ints(out)] == [pow(v, -1, P) * r2 % P if v else 0
                                                      for v in vals]
    assert torch.equal(out, L.mont_inv_fermat_plain(a))


def _batch_inv_values(n, seed):
    """n seeded random elements in Montgomery form with zeros first, in the
    middle and last, and 1 and p-1 after the first zero (as many as fit)."""
    x = _rand_mont(seed, n)
    edges = L.ints_to_mont([1, P - 1], "cpu")
    x[1:3] = edges[:max(0, min(2, n - 1))]
    for i in (0, n // 2, n - 1):
        x[i] = 0
    return x


def _batch_inv_source(lib, x, threads=0, per_thread=0):
    """csrc/batch_inv.cu's launches as ops/limbs.py batch_inv_grid plans
    them (blocks of ``threads`` threads at most and ``per_thread`` elements
    a thread; the defaults where 0), each through the emulated source:
    (output, the launches' (n, blocks, threads, writes totals, reads
    inverses))."""
    launches = []

    def launch(src, out, n, totals, inv_totals, blocks, width, k):
        launches.append((n, blocks, width, totals is not None, inv_totals is not None))
        lib.host_batch_inv(*(None if t is None else t.data_ptr()
                             for t in (src, out)), n,
                           *(None if t is None else t.data_ptr() for t in (totals, inv_totals)),
                           blocks, width, k)

    return L.batch_inv_grid(x, launch, threads, per_thread), launches


BATCH_INV_CAPACITY = L.BATCH_INV_THREADS * L.BATCH_INV_PER_THREAD


@pytest.mark.parametrize("n", [1, 31, 284, 1024, BATCH_INV_CAPACITY])
def test_batch_inv_kernel_source_one_block(lib, n):
    """batch_inv.cu in one block of the default widths (narrowed to the
    least power of two of at least a warp that holds n: 32, 32, 128, 256
    threads of 4 elements; the warps' scan across 1, 4 and 8 warps), the
    block's total inverted in place (inverse.cuh inv_binary), zeros first,
    in the middle and last: bit for bit against batch_inv_plain and Python
    integers, in one launch."""
    x = _batch_inv_values(n, 100 + n)
    out, launches = _batch_inv_source(lib, x)
    assert len(launches) == 1 and launches[0][:2] == (n, 1)
    assert launches[0][2] == min(L.BATCH_INV_THREADS, max(32, 1 << (-(-n // 4) - 1).bit_length()))
    assert torch.equal(out, L.batch_inv_plain(x))
    r2 = L.R_INT * L.R_INT % P
    assert [int(v) for v in L.limbs_to_ints(out)] == [
        pow(int(v), -1, P) * r2 % P if v else 0 for v in L.limbs_to_ints(x)]


#: (n, threads, elements a thread, launches) of the emulated grids above a
#: block's capacity: 4 blocks of one partial warp, 4 blocks of 2 warps,
#: 5 blocks of 2 elements a thread, 4 blocks of 8 elements, and 37 elements
#: in blocks of 4 (10 totals, their 3 totals: the totals' inversion recurses)
BATCH_INV_GRIDS = [(50, 8, 2, 3), (200, 64, 1, 3), (300, 32, 2, 3), (100, 4, 8, 3), (37, 4, 1, 5)]


@pytest.mark.parametrize("n, threads, per_thread, count", BATCH_INV_GRIDS,
                         ids=[f"n{n}-threads{t}-k{k}" for n, t, k, _ in BATCH_INV_GRIDS])
def test_batch_inv_kernel_source_blocks(lib, n, threads, per_thread, count):
    """Above a block's capacity (lowered to 16-128 elements), the three
    launches (totals, their inverses, outputs) of three to nine blocks, and
    five where the totals outnumber a block's capacity, zeros included: bit
    for bit against batch_inv_plain."""
    x = _batch_inv_values(n, 200 + n)
    out, launches = _batch_inv_source(lib, x, threads, per_thread)
    blocks = -(-n // (threads * per_thread))
    assert blocks >= 3 and len(launches) == count
    assert launches[0] == (n, blocks, threads, True, False)
    assert launches[-1] == (n, blocks, threads, False, True)
    assert torch.equal(out, L.batch_inv_plain(x))


#: op: (its code in host_limbs, the plain version, the JAX package's function
#: or None, the value in integers)
LIMB_OPS = {
    "mont_mul": (0, L.mont_mul_plain, JL.mont_mul_jit,
                 lambda x, y: x * y * pow(L.R_INT, -1, P) % P),
    "add_mod": (1, L.add_mod_plain, JL.add_mod_jit, lambda x, y: (x + y) % P),
    "sub_mod": (2, L.sub_mod_plain, JL.sub_mod_jit, lambda x, y: (x - y) % P),
    "redc": (3, L.redc_plain, None, lambda x: x * pow(L.R_INT, -1, P) % P),
}
LIMB_CASES = [(op, layout) for op in LIMB_OPS
              for layout in (chip_smoke.UNARY_LAYOUTS if op == "redc" else chip_smoke.LIMB_LAYOUTS)]
#: 384 = 24 x 16 elements (the outer layout's rows and columns), 64 at a
#: time through the JAX package (the shape tests/test_torch_limbs.py compiles)
LIMB_N, LIMB_ROWS, JAX_CHUNK = 384, 24, 64
#: (elements, tile, blocks, threads) of the emulated launches: 384 in tiles
#: of 6 (two of 8 slots idle, 13 tiles a block), then chip_smoke.py's tail
#: sizes in tiles of 14 that leave a partial last tile
LIMB_GRIDS = [(LIMB_N, 6, 5, 4)] + [(n, 14, 3, 8) for n in chip_smoke.LIMB_TAIL_SIZES]


@pytest.fixture(scope="module")
def limb_values():
    """Every pair of chip_smoke.LIMB_EDGES, then seeded random values, as
    many as the largest tail size."""
    count = max(n for n, *_ in LIMB_GRIDS)
    rng = np.random.default_rng(66)
    rand = [int(h) << 64 | int(lo) for h, lo in
            zip(rng.integers(0, 1 << 63, 2 * count, dtype=np.uint64),
                rng.integers(0, 1 << 63, 2 * count, dtype=np.uint64))]
    ea, eb = chip_smoke.edge_pairs()
    a = ea + [v % P for v in rand[: count - len(ea)]]
    b = eb + [v % P for v in rand[count:2 * count - len(eb)]]
    return (L.from_numpy(L.ints_to_limbs(a), "cpu"), L.from_numpy(L.ints_to_limbs(b), "cpu"))


def _limb_source(lib, code, operands, tile, blocks, threads):
    """The emulated kernel on kernel_plan's plan of ``operands``: (plan, out)."""
    plan = L.kernel_plan(*operands)
    out = torch.full(plan.lead + (L.NLIMB,), -1, dtype=L.DTYPE)
    n = out.numel() // L.NLIMB
    index = ctypes.c_int64 * 4
    if n:
        lib.host_limbs(code, plan.views[0].data_ptr(), plan.views[-1].data_ptr(), out.data_ptr(),
                       n, plan.ndim, index(*plan.sizes), index(*plan.strides[0]),
                       index(*plan.strides[-1]), index(*plan.divisors), tile, blocks, threads)
    return plan, out


@pytest.mark.parametrize("op, layout", LIMB_CASES, ids=[f"{o}-{l}" for o, l in LIMB_CASES])
def test_limb_kernel_source(lib, limb_values, op, layout):
    """limbs.cu's four entry points in every layout of chip_smoke.py's limb
    phase, read through kernel_plan's plan (broadcast dimensions of stride
    0, strided slices, four dimensions that do not merge and their
    reciprocals, a limb-transposed operand and one that starts mid-element,
    each copied once), against the plain versions: blocks of 4 and 8
    threads walking several tiles each, with idle slots and partial last
    tiles (384, 1, 31, 257 and 4097 elements); at 384 the full layout also
    against the JAX package (64 elements a call) and integers."""
    code, plain, jax_fn, host = LIMB_OPS[op]
    arity = 1 if op == "redc" else 2
    for n, tile, blocks, threads in LIMB_GRIDS:
        a, b = limb_values[0][:n], limb_values[1][:n]
        rows = LIMB_ROWS if n == LIMB_N else 1 << (n.bit_length() - 1) // 2
        operands = chip_smoke.limb_operands(layout, a, b, rows)[:arity]
        copies = L.copies
        plan, out = _limb_source(lib, code, operands, tile, blocks, threads)
        # one element's transposed limbs are adjacent all the same
        assert L.copies - copies == (layout in chip_smoke.COPIED_LAYOUTS
                                     and (n > 1 or layout == "misaligned"))
        assert plan.sizes[:L.KERNEL_DIMS - plan.ndim] == [1] * (L.KERNEL_DIMS - plan.ndim)
        assert torch.equal(out, plain(*operands)), (n, layout)
        if n != LIMB_N:
            continue
        assert out.numel() // L.NLIMB == LIMB_N
        assert plan.ndim == {"outer": 2, "permuted": 4}.get(layout, 1)
        if layout == "full":
            ints = [L.limbs_to_ints(t) for t in operands]
            assert [int(v) for v in L.limbs_to_ints(out)] == [host(*vs) for vs in zip(*ints)]
            if jax_fn is not None:
                for lo in range(0, LIMB_N, JAX_CHUNK):
                    chunk = [np.asarray(t[lo:lo + JAX_CHUNK]).astype(np.uint32)
                             for t in operands]
                    assert np.array_equal(out[lo:lo + JAX_CHUNK].numpy().astype(np.uint32),
                                          np.asarray(jax_fn(*chunk)))


#: the probe's variant launches on the emulated source: n -> (transforms,
#: the TILE_ELEMS that gives tiles of 2 transforms, threads a block); d's
#: resident blocks
VARIANT_SHAPES = {8: (5, 16, 3), 64: (5, 128, 5), 1024: (3, 1 << 11, 6)}
VARIANT_D_BLOCKS = 2


def _variant_source(lib, which, x, root):
    """The launch variant_kernel makes on the card (ntt.kernel_passes' one
    pass, ntt_variants.variant_block's block), run through the emulated
    source: a is ntt.cu itself."""
    n, c = x.shape[0], x.shape[1]
    threads = VARIANT_SHAPES[n][2]
    if which == "a":
        return _ntt_source(lib, x, root, threads=threads)[0]
    (p,) = N.kernel_passes(n, c, root)
    blk = V.variant_block(which, p)
    tw = V.variant_table(which, root, n, "cpu")
    y = torch.full_like(x, -1)
    lib.host_variant(which.encode(), *_ptrs(x, y, tw), n.bit_length() - 1, *p.grid, *p.ins,
                     *p.outs, blk.dim, blk.log2_count, int(blk.in_tmajor), int(blk.out_tmajor),
                     threads, VARIANT_D_BLOCKS)
    return y


@pytest.mark.parametrize("which", V.VARIANTS)
@pytest.mark.parametrize("n", [8, 64, 1024])
def test_ntt_variant_sources(lib, monkeypatch, which, n):
    """The probe's four stage kernels (a is ntt.cu's) on natural rows, in
    tiles of 2 transforms of which the last holds one (d: tiles of one
    transform at 1024), with blocks of 3 to 6 threads, d's tiles walked by
    2 resident blocks and streamed in 1, 2 and 4 slices (n = 8, 64, 1024),
    equal the plain transform of each column and so each other."""
    c, tile_elems, _ = VARIANT_SHAPES[n]
    monkeypatch.setattr(N, "TILE_ELEMS", tile_elems)
    root = F.primitive_nth_root(n).value
    x = _rand_mont(n + 3, n * c).reshape(n, c, L.NLIMB)
    (p,) = N.kernel_passes(n, c, root)
    blk = V.variant_block(which, p)
    tiles = -(-c >> blk.log2_count)
    assert tiles >= 2 and (c % (1 << blk.log2_count) or blk.log2_count == 0)
    if which == "d":
        assert tiles > VARIANT_D_BLOCKS and blk.threads == V.D_THREADS
        assert (1 << blk.log2_count) * n <= V.D_TILE_ELEMS
    assert torch.equal(_variant_source(lib, which, x, root), V.ntt_columns_plain(x, root))


#: mutations of csrc/ntt_variants.cu that test_ntt_variant_sources must
#: catch: name -> (the variant run, the text, its replacement).  The z
#: stride in place of an element's; b's table read one stage off; c's
#: register stages with the next stage's twiddles; d repacking the other raw
#: slot than the one its slice landed in.
VARIANT_MUTATIONS = {
    "z-stride": ("b", "xb + 8 * (t * in_t + i * in.e) + 2 * (c & 3));\n    });",
                 "xb + 8 * (t * in_t + i * in.bz) + 2 * (c & 3));\n    });"),
    "b": ("b", "return (1 << s) - 1 + j;", "return (1 << s) + j;"),
    "c": ("c", "from4(tw4[root(s, j)])", "from4(tw4[root(s + 1, j)])"),
    "d": ("d", "raw + (j & 1) * size;", "raw + ((j + 1) & 1) * size;"),
}


@pytest.mark.parametrize("mutation", sorted(VARIANT_MUTATIONS))
def test_ntt_variant_source_mutations(tmp_path, monkeypatch, mutation):
    """Each mutation of the variants' source, built alone under the same
    emulation, gives a wrong transform at 1024 points: the check above
    sees the code it checks."""
    which, text, repl = VARIANT_MUTATIONS[mutation]
    src = (CSRC / "ntt_variants.cu").read_text()
    assert src.count(text) == 1
    (tmp_path / "ntt_variants.cu").write_text(src.replace(text, repl))
    harness = _PRELUDE + _VARIANT_HARNESS
    lib = _variant_argtypes(_compile(tmp_path, harness, [tmp_path, CSRC]))
    n = 1024
    c, tile_elems, _ = VARIANT_SHAPES[n]
    monkeypatch.setattr(N, "TILE_ELEMS", tile_elems)
    root = F.primitive_nth_root(n).value
    x = _rand_mont(n + 3, n * c).reshape(n, c, L.NLIMB)
    assert not torch.equal(_variant_source(lib, which, x, root), V.ntt_columns_plain(x, root))


#: (codeword length, tile, blocks, threads) of the emulated fold launches:
#: a one-element call, one block walking two tiles, 257 outputs in tiles of
#: 8 over 3 persistent blocks (a partial last tile), and tiles smaller than
#: the block (idle threads) over 5 blocks
FOLD_GRIDS = [(2, 8, 1, 8), (64, 16, 1, 16), (514, 8, 3, 8), (4096, 24, 5, 32)]


@pytest.mark.parametrize("n, tile, blocks, threads", FOLD_GRIDS,
                         ids=[f"n{n}-tile{t}-blocks{b}-threads{th}" for n, t, b, th in FOLD_GRIDS])
def test_fold_kernel_source(lib, n, tile, blocks, threads):
    """fold.cu's persistent grid over double-buffered tiles against the
    plain version, with every pair of {0, 1, p-1, p-2, R mod p} leading the
    codeword's halves."""
    half = n // 2
    ea, eb = chip_smoke.edge_pairs()
    cw = _rand_mont(1, n)
    k = min(half, len(ea))
    cw[:k] = L.from_numpy(L.ints_to_limbs(ea[:k]), "cpu")
    cw[half:half + k] = L.from_numpy(L.ints_to_limbs(eb[:k]), "cpu")
    ip = _rand_mont(2, half)
    ao = _rand_mont(3, 1)[0]
    ti = L.int_to_mont(pow(2, -1, P), "cpu")
    folded = torch.full((half, L.NLIMB), -1, dtype=L.DTYPE)
    canon = torch.full_like(folded, -1)
    lib.host_fold(*_ptrs(cw, ip, ao, ti, folded, canon), half, tile, blocks, threads)
    want_f, want_c = FO.fold_plain(cw, ip, ao, ti)
    assert torch.equal(folded, want_f) and torch.equal(canon, want_c)


def _node_source(lib, level, span_log2, levels, threads):
    """One emulated node launch over ``level`` [m, 64]: its `levels` levels
    one after another."""
    m = level.shape[0]
    out = torch.full((sum(m >> j for j in range(1, levels + 1)), 64), 7, dtype=torch.uint8)
    lib.host_node(*_ptrs(level, out), m, span_log2, levels, threads)
    return out


@pytest.mark.parametrize("threads", [1, 7, 64])
def test_leaf_and_node_kernel_sources(lib, threads):
    """The leaf kernel on chip_smoke.py's decimal-length values (one of
    every length from 1 to 39 digits and every group boundary) and seeded
    random elements, in blocks of 1, 7 and 64 threads (a partial last
    block), against hashlib and the plain version; the node kernel asked
    for one level, as ``node_kernel`` asks it (blocks of
    2^LEVEL_SPAN_LOG2 children, here 2^2 and 2^5 with a partly full last
    block), on the digests."""
    vals = chip_smoke.decimal_values() + [(1 << 128) - 1]
    vals += [int(v) for v in L.mont_to_ints(_rand_mont(4, 117))]
    canon = L.from_numpy(L.ints_to_limbs(vals), "cpu")
    leaves = torch.empty((len(vals), 64), dtype=torch.uint8)
    lib.host_leaf(*_ptrs(canon, leaves), len(vals), threads)
    assert torch.equal(leaves, B.leaf_digests_plain(canon))
    assert [bytes(row) for row in leaves.numpy()] == [
        hashlib.blake2b(str(v).encode(), digest_size=64).digest() for v in vals]
    level = leaves[:len(vals) // 2 * 2]
    for span_log2 in (2, 5):
        parents = _node_source(lib, level, span_log2, 1, threads)
        assert torch.equal(parents, B.node_digests_plain(level)), span_log2


#: (leaves, levels a launch at most, threads a block) of the emulated trees:
#: 1 and 2 leaves; depths 3, 6 and 7 a multiple of the launch's levels and
#: not (plans [3], [2, 1], [3, 3], [3, 2, 2], [4, 3], [2, 2, 2]); blocks of
#: 1 and 3 threads (one thread a parent), of 8, 16 and 64 (four lanes a
#: parent on the levels of at most 2, 4 and 16 parents; at 64 the second
#: warp skips the levels of at most 8)
TREE_CASES = [(1, 2, 1), (2, 2, 3), (8, 3, 1), (8, 2, 3), (64, 3, 8), (64, 4, 3), (128, 3, 8),
              (128, 4, 1), (64, 2, 3), (128, 4, 16), (128, 4, 64), (64, 6, 64)]


@pytest.mark.parametrize("n, max_levels, threads", TREE_CASES,
                         ids=[f"leaves{n}-k{k}-threads{t}" for n, k, t in TREE_CASES])
def test_node_tree_kernel_source(lib, monkeypatch, n, max_levels, threads):
    """The node kernel's launches of ``tree_launches`` (TREE_LEVELS lowered
    to 2-4, so that small trees take several levels a launch and several
    launches), each from the level the one before wrote in the shared inner
    buffer, against the per-level plain loop and the host MerkleTree's
    layers (hashlib)."""
    monkeypatch.setattr(B, "TREE_LEVELS", max_levels)
    rng = np.random.default_rng(n + max_levels)
    vals = [int(v) % P for v in rng.integers(0, 1 << 63, size=n, dtype=np.uint64)]
    leaves = B.leaf_digests_plain(L.from_numpy(L.ints_to_limbs(vals), "cpu"))
    inner = torch.full((n - 1, 64), 7, dtype=torch.uint8)
    launches = B.tree_launches(n)
    assert sum(k for _, k in launches) == n.bit_length() - 1
    assert len(launches) == -(-(n.bit_length() - 1) // max_levels)
    for level, k in launches:
        src = leaves if level == 0 else inner[B.level_start(n, level)]
        dst = inner[B.level_start(n, level + 1)]
        lib.host_node(*_ptrs(src, dst), n >> level, k, k, threads)
    assert torch.equal(inner, B.tree_plain(leaves))
    levels = B.split_levels(leaves, inner)
    host = merkle.MerkleTree.from_ints(vals)
    assert [[bytes(row) for row in lvl.numpy()] for lvl in levels] == host.layers


def test_node_kernel_source_partial_block(lib):
    """A launch whose blocks take more children than its levels reduce, the
    last block partly full: 24 children in spans of 16, two levels (blocks
    of 16 and 8 children, 4 and 2 digests at the top), 3 threads a block."""
    rng = np.random.default_rng(24)
    level = torch.from_numpy(rng.integers(0, 256, size=(24, 64), dtype=np.uint8))
    out = _node_source(lib, level, 4, 2, 3)
    one = B.node_digests_plain(level)
    assert torch.equal(out, torch.cat([one, B.node_digests_plain(one)]))


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


#: (n, k, blocks, threads, chains a thread) of the emulated chain launches:
#: the launcher's grid (one block: n below one block's groups), a grid
#: smaller than the groups (threads stride over them), and in builds of 2
#: and 4 chains a thread (the shape probe's, kChains) an n that is a
#: multiple of neither (its last group masked), below one block
CHAIN_GRIDS = {"32": (64, 32, 1, 128, None), "37": (64, 37, 3, 4, None),
               "ragged-n-2-chains": (4 * 4 + 1, 33, 2, 3, 2),
               "ragged-n-4-chains": (4 * 4 + 2, 32, 1, 128, 4),
               "below-one-block": (5, 32, 1, 128, None)}


@pytest.fixture(scope="module")
def chain_builds(tmp_path_factory):
    """The emulated chained product built with 2 and 4 chains a thread."""
    src = (CSRC / "montmul_chain.cu").read_text()
    piece = f"constexpr int kChains = {MC.CHAINS};"
    assert src.count(piece) == 1
    libs = {}
    for chains in (2, 4):
        out = tmp_path_factory.mktemp(f"chain{chains}")
        (out / "montmul_chain.cu").write_text(
            src.replace(piece, f"constexpr int kChains = {chains};"))
        libs[chains] = _compile(out, _PRELUDE + _CHAIN_HARNESS, [out, CSRC])
        libs[chains].host_chain.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
    return libs


@pytest.mark.parametrize("case", list(CHAIN_GRIDS))
def test_montmul_chain_kernel_source(lib, chain_builds, case):
    """x^(k+1) by k chained products against the plain chain, with the
    package's chains a thread (MC.CHAINS) or another build's; the unrolled
    body (k = 32) and its tail (k = 33, 37)."""
    n, k, blocks, threads, chains = CHAIN_GRIDS[case]
    if chains is not None:
        assert n % chains
        lib = chain_builds[chains]
    x = _rand_mont(6, n)
    y = torch.full_like(x, -1)
    lib.host_chain(*_ptrs(x, y), n, k, blocks, threads)
    assert torch.equal(y, MC.mont_mul_chain_plain(x, k))


@pytest.mark.parametrize(
    "alpha, alpha_inv, rounds, n, threads, m",
    [(None, None, 27, 4, 2, 2), (0, 77, 2, 4, 2, 2), (5, (1 << 9) + 3, 2, 4, 2, 2),
     (None, None, 2, 1, 2, 2), (None, None, 2, 7, 4, 2), (None, None, 3, 5, 6, 2),
     (None, None, 2, 50, 126, 3), (None, None, 2, 40, 128, 4), (None, None, 2, 20, 126, 7),
     (None, None, 2, 5, 16, 8)],
    ids=["default-27-rounds", "alpha0-short-inverse", "9-bit-inverse", "one-state",
         "ragged-block-of-4", "ragged-block-of-6", "m3-blocks-of-126", "m4-blocks-of-128",
         "m7-blocks-of-126", "m8-ragged"],
)
def test_rescue_kernel_source(lib, alpha, alpha_inv, rounds, n, threads, m):
    """n random full states of width m through the rounds, m threads a
    state: the default instance's exponents over all 27, exponents that
    reach the chains' other forms (alpha = 0, an inverse exponent of 7 and
    of 10 bits), a single state, and 7 and 5 states in blocks of 4 and 6
    threads (the last block half idle: its spare threads meet every barrier
    and store nothing); at m = 3 and 4 the blocks launch_plan gives (126
    and 128 threads; 50 and 40 states leave the last block partly full),
    m = 7 in blocks of 126 (20 states, the second block partly full) and
    m = 8."""
    rp = RescuePrime(F, m=m)
    alpha = rp.alpha if alpha is None else alpha
    alpha_inv = rp.alpha_inv if alpha_inv is None else alpha_inv
    mds, rc = rp._device_constants("cpu")
    state = _rand_mont(7, m * n).reshape(n, m, L.NLIMB)
    out = torch.full_like(state, -1)
    a_steps, a_len = R._steps(alpha)
    ai_steps, ai_len = R._steps(alpha_inv)
    if m in (3, 4, 7) and threads > 100:
        assert R.launch_plan(n, m) == {"blocks": 2, "threads": threads}
    lib.host_rescue(*_ptrs(state, out, mds, rc), n, m, rounds, a_steps, a_len, ai_steps, ai_len,
                    threads)
    assert torch.equal(out, R.permutation_plain(state, mds, rc, rounds, alpha, alpha_inv))


def test_mont_mul_ops_counts_the_ptx():
    """The bounds' instruction count is the PTX block of field.cuh's product
    as written: 35 for the schoolbook product, 19 for the reduction, 10 for
    the subtraction of p; 41 of them multiplies (32 halves of the 16 word
    products, 9 in the reduction)."""
    from zk_stark_tpu_torch.tools import measure

    src = (CSRC / "field.cuh").read_text()
    block = src[src.index("// mont_mul PTX begin"):src.index("// mont_mul PTX end")]
    opcodes = [line.split('"')[1].split()[0] for line in block.splitlines()
               if line.strip().endswith(';\\n\\t"') and not line.strip().startswith('".reg')]
    assert measure.mont_mul_ops() == measure.MONT_MUL_OPS == len(opcodes) == 64
    assert sum(op.startswith(("mul.", "mad")) for op in opcodes) == 32 + 9  # 16 a*b pairs, 2 halves
