// Whole radix-2 NTTs of a tile of neighbouring transforms in shared memory,
// with an optional four-step twiddle multiplied in before the store.
//
// Replaces: _ntt_stages_kernel (zk_stark_tpu/ops/ntt_pallas.py:180), launched
// by _ntt_planes_call (:311), in both its modes.  The TPU kernel runs the
// log2 n butterfly stages of bit-reversed rows held in VMEM, with limb planes
// [8, n, c] so that 128 transforms fill the vector lanes; with fuse_tw
// (:266-268) it multiplies each transform by the four-step tile
// root^(k1*i2) after the last stage.  The four-step glue around it
// (_four_step_pallas :408, ntt_mont_pallas :449) and the recursive split of
// long columns (_planes_long_ntt :369) are in ops/ntt.py.
//
// The grid is three batch dimensions of transforms of n <= 2^12 points;
// element i of transform (bx, by, bz) lives at element offset
// bx*sx + by*sy + bz*sz + i*se of its tensor, for the input and the output
// separately.  So the four-step split (two launches) and the three-pass
// split beyond 2^24 points (three launches) read columns and write
// transposed rows straight from and to device memory, with no transpose
// pass between launches.  In the fused mode (ft != nullptr), element k of
// transform bx is multiplied by ft[bx * n + k] before the store: the
// four-step twiddle costs no pass of its own, nor does the inner twiddle of
// the three-pass split.
//
// A block holds 2^log2_count transforms that are neighbours along one grid
// index (tile.dim; ops/ntt.py block_shape chooses it, the one whose stride
// is 1 on a side where the transform's own elements are not contiguous, and
// the count, up to 2048 / n transforms: 32 KB), the last block masked.  An element
// is 64 bytes of int64 limbs; its 16-byte quarter k (limbs 2k, 2k+1) is
// exactly its 32-bit word k.  Loads and stores walk the tile in 16-byte
// chunks, neighbouring threads on neighbouring chunks in memory order:
// transform-major where the tile index has stride 1 (a warp covers 8
// transforms' element i, 512 contiguous bytes), element-major where the
// transform's elements are contiguous.  Each thread repacks its chunk to a
// word in shared memory (TileLayout, ntt_stages.cuh: padded and swizzled
// against bank conflicts); the stages of all the tile's transforms are one
// block-stride loop.  The tile's walks and its stages are ntt_stages.cuh's
// (load_tile, store_tile, stages_shared), which the stage-variant probe's
// kernels (ntt_variants.cu) share.
//
// Bound: each stage does n/2 Montgomery products (field.cuh: 64
// instructions) and 2 modular add/sub on data that never leaves shared
// memory; device memory sees the input and output once (64 B each per
// element as int64 limbs) plus the 16-byte twiddles.  A four-step
// transform of 2^20 points moves 134 MB, 0.040 ms at 3.35 TB/s, and bytes
// bound the transforms from 4096 points to 2^25 (tools/measure.py
// ntt_bound).  The old design (one transform a block, each thread loading
// whole elements as eight strided int64 limbs) ran ~10x its bound
// (PERF.md).

#include <stdint.h>

#include "ntt_stages.cuh"

// x, y: int64 limbs (Montgomery) laid out by the strides; tw: [n/2, 4]
// uint32 words of root^k (Montgomery), k < n/2, stage s using
// root^(j * n / 2^(s+1)); ft: nullptr, or [extent along x, n, 4] words.
// Dynamic shared memory: 2^log2_count * (n + 1) elements of 16 bytes.
extern "C" __global__ void __launch_bounds__(1024) ntt_stages_kernel(
    const int64_t* __restrict__ x, int64_t* __restrict__ y,
    const uint32_t* __restrict__ tw, const uint32_t* __restrict__ ft,
    int log2n, Strides in, Strides out, Tile tile) {
    extern __shared__ Fe4 sh[];
    const int n = 1 << log2n;
    const TileAt a = tile_at(tile, blockIdx.x, blockIdx.y, blockIdx.z);
    const int count = a.count;
    const int64_t* xb = tile_base(x, in, a);
    int64_t* yb = tile_base(y, out, a);
    const long long in_t = dim_stride(in, tile.dim), out_t = dim_stride(out, tile.dim);
    const TileLayout at{log2n};
    uint32_t* words = reinterpret_cast<uint32_t*>(sh);

    load_tile(words, log2n, tile.log2_count, tile.in_tmajor, count, at,
              [&](int c, int t, int i) {
        return *reinterpret_cast<const longlong2*>(
            xb + 8 * (t * in_t + i * in.e) + 2 * (c & 3));
    });
    __syncthreads();
    stages_shared(sh, reinterpret_cast<const Fe4*>(tw), log2n, 0, count, at, RootIndex{log2n});

    if (ft) {
        const Fe4* ft4 = reinterpret_cast<const Fe4*>(ft);
        for (int e = threadIdx.x; e < count * n; e += blockDim.x) {
            const int t = e >> log2n, k = e & (n - 1);
            const long long bx = tile.dim == 0 ? a.ix + t : a.ix;
            const int p = at(t, k);
            sh[p] = to4(zk::mont_mul(from4(sh[p]), from4(ft4[bx * n + k])));
        }
        __syncthreads();
    }

    store_tile(reinterpret_cast<longlong2*>(yb), out_t, out.e, words, log2n, tile.log2_count,
               tile.out_tmajor, count, at);
}

#ifdef __CUDACC__
#include <cuda_runtime.h>

// Lets the kernel take `smem` bytes of dynamic shared memory on the current
// card: the attribute is set only when a launch needs more than any before
// it (so a CUDA graph's capture, whose sizes its warm-up run has set, makes
// no such call).
static cudaError_t allow_smem(int smem) {
    constexpr int kMaxDevices = 16;
    static int allowed[kMaxDevices] = {};
    int dev = 0;
    cudaGetDevice(&dev);
    int& cur = allowed[dev < kMaxDevices ? dev : kMaxDevices - 1];
    if (smem <= cur) return cudaSuccess;
    const cudaError_t e = cudaFuncSetAttribute(
        ntt_stages_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess) cur = smem;
    return e;
}

// gx, gy, gz: the transforms along each grid index; the block takes
// 2^log2_count of them along dim with `threads` threads.
static int launch(const void* x, void* y, const void* tw, const void* ft, int log2n,
                  int gx, int gy, int gz, Strides in, Strides out, int dim, int log2_count,
                  int threads, int in_tmajor, int out_tmajor, void* stream) {
    const int n = 1 << log2n;
    const int smem = ((n + 1) << log2_count) * (int)sizeof(Fe4);
    const cudaError_t e = allow_smem(smem);
    if (e != cudaSuccess) return (int)e;
    int grid[3] = {gx, gy, gz};
    const Tile tile{dim, log2_count, grid[dim], in_tmajor, out_tmajor};
    grid[dim] = (grid[dim] + (1 << log2_count) - 1) >> log2_count;
    ntt_stages_kernel<<<dim3(grid[0], grid[1], grid[2]), threads, smem, (cudaStream_t)stream>>>(
        (const int64_t*)x, (int64_t*)y, (const uint32_t*)tw, (const uint32_t*)ft, log2n, in,
        out, tile);
    return (int)cudaGetLastError();
}

// Plain mode: gx * gy * gz transforms; returns cudaGetLastError().
extern "C" int ntt_launch(const void* x, void* y, const void* tw, int log2n,
                          int gx, int gy, int gz, long long in_bx, long long in_by,
                          long long in_bz, long long in_e, long long out_bx,
                          long long out_by, long long out_bz, long long out_e,
                          int dim, int log2_count, int threads, int in_tmajor,
                          int out_tmajor, void* stream) {
    return launch(x, y, tw, nullptr, log2n, gx, gy, gz,
                  Strides{in_bx, in_by, in_bz, in_e}, Strides{out_bx, out_by, out_bz, out_e},
                  dim, log2_count, threads, in_tmajor, out_tmajor, stream);
}

// Fused-twiddle mode (the first pass of a four-step split, and the second
// of the three-pass split): as ntt_launch, then element k of transform
// (bx, by, bz) times ft[bx, k].
extern "C" int ntt_tw_launch(const void* x, void* y, const void* tw,
                             const void* ft, int log2n, int gx, int gy, int gz,
                             long long in_bx, long long in_by, long long in_bz,
                             long long in_e, long long out_bx, long long out_by,
                             long long out_bz, long long out_e, int dim, int log2_count,
                             int threads, int in_tmajor, int out_tmajor, void* stream) {
    return launch(x, y, tw, ft, log2n, gx, gy, gz,
                  Strides{in_bx, in_by, in_bz, in_e}, Strides{out_bx, out_by, out_bz, out_e},
                  dim, log2_count, threads, in_tmajor, out_tmajor, stream);
}
#endif
