// Three forms of the NTT stage kernel beside ntt.cu's own, for the
// stage-variant probe.
//
// Replaces: kernel_b (tools/ntt_variant_probe.py:77) and kernel_c (:104),
// launched by make_call (:183) through pl.pallas_call (:221); kernel_a
// (:50) is ntt.cu's ntt_stages_kernel itself (ops/ntt_variants.py launches
// it through ops/ntt.py), so the probe's baseline is the kernel it probes.
// The TPU probe isolates the non-arithmetic cost of the stage kernel: every
// form runs all DIT stages of c transforms and computes one function, and
// they differ only in where the stage twiddles come from and in how the
// first three stages are done.  Here the same questions are asked of
// ntt_stages_kernel on its own block: a tile of neighbouring transforms
// (ntt_stages.cuh tile_at, TileLayout) loaded and stored in 16-byte chunks
// by ntt_stages.cuh's load_tile and store_tile, the rows bit-reversed on
// load, so every form takes natural rows and writes each transform's NTT:
//
//   a  ntt_stages_kernel: one [n/2] table root^k read from device memory
//      at j << (log2n - 1 - s) in every stage (RootIndex);
//   b  a stage-major table of n - 1 words, stage s's 2^s twiddles from
//      offset 2^s - 1, copied into shared memory once a block, so every
//      stage reads its twiddles at unit stride from there;
//   c  a's twiddles, but after the tile load each thread takes 8
//      consecutive positions of one transform into registers and runs the
//      stages h = 1, 2, 4 there: two barriers and two shared-memory round
//      trips fewer; the stages from h = 8 on run as in a.  Neighbouring
//      threads take groups 2^(log2n-6) apart, so the 8 threads of a quarter
//      warp meet 8 different swizzles of TileLayout and 8 bank groups;
//   d  a with its loads overlapped with the stages: a resident block walks
//      its tiles, and each next tile streams in while the one before runs
//      its stages, in slices of raw chunks (cp.async, 16 bytes a thread)
//      double-buffered in two raw slots and repacked into a second tile of
//      words between stages.  At n = 1024 a tile is one transform: two
//      tiles of words (32 KB) and two slots of a quarter tile (2 x 16 KB),
//      so three blocks fit an SM (two whole raw tiles, 128 KB, would leave
//      one block of 16 warps).
//
// Bound: at the probe's n = c = 1024, 2^20 elements in and out at 64 B
// (134 MB, 0.040 ms at 3.35 TB/s) against 10 * 512 * 1024 butterflies
// (0.017 ms at the SM issue rate): bytes bound all four.  What the four
// times say is how much of ntt_stages_kernel's distance from that bound is
// twiddle reads (a against b), the early stages' barriers and shared-memory
// round trips (a against c), and loads that do not overlap the stages (a
// against d).

#include <stdint.h>
#include <string.h>

#include "ntt_stages.cuh"

// the tile's chunks from device memory, and back (ntt.cu's walks)
__device__ __forceinline__ void load_global(Fe4* sh, const int64_t* x, const Strides& in,
                                            int log2n, const Tile& tile, const TileAt& a,
                                            TileLayout at) {
    const int64_t* xb = tile_base(x, in, a);
    const long long in_t = dim_stride(in, tile.dim);
    load_tile(reinterpret_cast<uint32_t*>(sh), log2n, tile.log2_count, tile.in_tmajor, a.count,
              at, [&](int c, int t, int i) {
        return *reinterpret_cast<const longlong2*>(
            xb + 8 * (t * in_t + i * in.e) + 2 * (c & 3));
    });
}

__device__ __forceinline__ void store_global(const Fe4* sh, int64_t* y, const Strides& out,
                                             int log2n, const Tile& tile, const TileAt& a,
                                             TileLayout at) {
    store_tile(reinterpret_cast<longlong2*>(tile_base(y, out, a)), dim_stride(out, tile.dim), out.e,
               reinterpret_cast<const uint32_t*>(sh), log2n, tile.log2_count, tile.out_tmajor,
               a.count, at);
}

// Where stage s's twiddle j lies in b's stage-major table.
struct StageMajor {
    __device__ __forceinline__ int operator()(int s, int j) const { return (1 << s) - 1 + j; }
};

// x, y: int64 limbs laid out by the strides, as ntt.cu's; tws: [n - 1, 4]
// words, stage s's twiddle j (root^(j * n / 2^(s+1)), j < 2^s) at
// 2^s - 1 + j.  Dynamic shared memory: the tile and n - 1 elements.
extern "C" __global__ void __launch_bounds__(1024) ntt_variant_b(
    const int64_t* __restrict__ x, int64_t* __restrict__ y, const uint32_t* __restrict__ tws,
    int log2n, Strides in, Strides out, Tile tile) {
    extern __shared__ Fe4 sh[];
    const int n = 1 << log2n;
    const TileAt a = tile_at(tile, blockIdx.x, blockIdx.y, blockIdx.z);
    const TileLayout at{log2n};
    Fe4* shtw = sh + ((n + 1) << tile.log2_count);
    const Fe4* tws4 = reinterpret_cast<const Fe4*>(tws);
    for (int i = threadIdx.x; i < n - 1; i += blockDim.x) shtw[i] = tws4[i];
    load_global(sh, x, in, log2n, tile, a, at);
    __syncthreads();
    stages_shared(sh, shtw, log2n, 0, a.count, at, StageMajor{});
    store_global(sh, y, out, log2n, tile, a, at);
}

// tw: [n/2, 4] words root^k, as ntt.cu's; n >= 8.  Dynamic shared memory:
// the tile.
extern "C" __global__ void __launch_bounds__(1024) ntt_variant_c(
    const int64_t* __restrict__ x, int64_t* __restrict__ y, const uint32_t* __restrict__ tw,
    int log2n, Strides in, Strides out, Tile tile) {
    extern __shared__ Fe4 sh[];
    const int n = 1 << log2n;
    const TileAt a = tile_at(tile, blockIdx.x, blockIdx.y, blockIdx.z);
    const TileLayout at{log2n};
    const Fe4* tw4 = reinterpret_cast<const Fe4*>(tw);
    const RootIndex root{log2n};
    load_global(sh, x, in, log2n, tile, a, at);
    __syncthreads();
    const int groups = n >> 3;  // of 8 positions, a transform
    for (int k = threadIdx.x; k < a.count * groups; k += blockDim.x) {
        const int t = k >> (log2n - 3), kk = k & (groups - 1);
        const int g = log2n >= 6 ? ((kk & 7) << (log2n - 6)) | (kk >> 3) : kk;
        Fe v[8];
#pragma unroll
        for (int r = 0; r < 8; ++r) v[r] = from4(sh[at(t, 8 * g + r)]);
#pragma unroll
        for (int s = 0; s < 3; ++s) {
            const int h = 1 << s;
#pragma unroll
            for (int q = 0; q < 4; ++q) {  // the 4 butterflies of 8 positions
                const int j = q & (h - 1);
                const int i0 = ((q >> s) << (s + 1)) + j;
                const Fe e = v[i0];
                const Fe w = zk::mont_mul(v[i0 + h], from4(tw4[root(s, j)]));
                v[i0] = zk::add_mod(e, w);
                v[i0 + h] = zk::sub_mod(e, w);
            }
        }
#pragma unroll
        for (int r = 0; r < 8; ++r) sh[at(t, 8 * g + r)] = to4(v[r]);
    }
    __syncthreads();
    stages_shared(sh, tw4, log2n, 3, a.count, at, root);
    store_global(sh, y, out, log2n, tile, a, at);
}

// 16 bytes from device memory to shared memory, asynchronously (the host
// compiler's branch copies at once), and the groups that wait for them
__device__ __forceinline__ void copy16_async(void* dst, const void* src) {
#ifdef __CUDA_ARCH__
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                     (uint32_t)__cvta_generic_to_shared(dst)),
                 "l"(src)
                 : "memory");
#else
    memcpy(dst, src, 16);
#endif
}

__device__ __forceinline__ void commit_async() {
#ifdef __CUDA_ARCH__
    asm volatile("cp.async.commit_group;" ::: "memory");
#endif
}

// every group of this thread's copies but the newest has landed
__device__ __forceinline__ void wait_async_but_one() {
#ifdef __CUDA_ARCH__
    asm volatile("cp.async.wait_group 1;" ::: "memory");
#endif
}

// d streams a tile in as this many slices at most (fewer where the stages
// are too few to space their repacks two stages apart)
constexpr int kMaxSlices = 4;

__host__ __device__ __forceinline__ int d_slices(int log2n) {
    int s = 1;
    while (2 * s <= kMaxSlices && 2 * s <= log2n / 2) s *= 2;
    return s;
}

// d: this thread's copies of slice j (`size` chunks) of tile k to the raw
// slot (chunk c at slot[c - j * size]), as one group (an empty one past the
// last tile or slice)
__device__ __forceinline__ void issue_slice(longlong2* slot, const int64_t* x,
                                            const Strides& in, int log2n, const Tile& tile,
                                            int tiles, int k, int j, int slices, int size) {
    if (k < tiles && j < slices) {
        const TileAt a = tile_at(tile, k, 0, 0);
        const int64_t* xb = tile_base(x, in, a);
        const long long in_t = dim_stride(in, tile.dim);
        for (int c = j * size + threadIdx.x; c < (j + 1) * size; c += blockDim.x) {
            int t, i;
            tile_index(c >> 2, tile.in_tmajor, log2n, tile.log2_count, t, i);
            if (t < a.count) {
                copy16_async(slot + c - j * size, xb + 8 * (t * in_t + i * in.e) + 2 * (c & 3));
            }
        }
    }
    commit_async();
}

// tw: as c's.  A grid of resident blocks along x only (tile.dim 0, the
// transforms on grid x); block b takes tiles b, b + gridDim.x, ...  Its
// first tile is loaded as a loads it; each next tile streams in while the
// one before runs its stages: slices 0 and 1 are issued at the tile's
// start, slice j is waited for and repacked into the other word buffer
// after stage 2j + 1, and its raw slot is refilled with slice j + 2 after
// the stage that follows (so each slice has three stages to land, and no
// slot is written before every thread has repacked it).  Dynamic shared
// memory: two tiles of words, then two raw slots of a slice each.
extern "C" __global__ void __launch_bounds__(1024) ntt_variant_d(
    const int64_t* __restrict__ x, int64_t* __restrict__ y, const uint32_t* __restrict__ tw,
    int log2n, Strides in, Strides out, Tile tile) {
    extern __shared__ Fe4 sh[];
    const int n = 1 << log2n;
    const TileLayout at{log2n};
    const Fe4* tw4 = reinterpret_cast<const Fe4*>(tw);
    const int per = (n + 1) << tile.log2_count;  // elements of a tile of words
    const int slices = d_slices(log2n), size = (n << (tile.log2_count + 2)) / slices;
    const int tiles = (tile.extent + (1 << tile.log2_count) - 1) >> tile.log2_count;
    longlong2* raw = reinterpret_cast<longlong2*>(sh + 2 * per);
    const int step = gridDim.x;
    if ((int)blockIdx.x < tiles) {
        load_global(sh, x, in, log2n, tile, tile_at(tile, blockIdx.x, 0, 0), at);
    }
    int cur = 0;
    for (int k = blockIdx.x; k < tiles; k += step, cur ^= 1) {
        __syncthreads();  // tile k's words are in place; the last store is done
        Fe4* words = sh + cur * per;
        uint32_t* next = reinterpret_cast<uint32_t*>(sh + (cur ^ 1) * per);
        const int kn = k + step;
        issue_slice(raw, x, in, log2n, tile, tiles, kn, 0, slices, size);
        issue_slice(raw + size, x, in, log2n, tile, tiles, kn, 1, slices, size);
        const TileAt a = tile_at(tile, k, 0, 0);
        const int count_n = kn < tiles ? tile_at(tile, kn, 0, 0).count : 0;
        int j = 0;  // slices of tile kn repacked
        for (int s = 0; s < log2n; ++s) {
            stage_shared(words, tw4, log2n, s, a.count, at, RootIndex{log2n});
            const bool point = j < slices && s == 2 * j + 1;
            if (point) wait_async_but_one();  // slice j: every group but the newest
            __syncthreads();
            if (point) {
                const longlong2* slot = raw + (j & 1) * size;
                const int c0 = j * size;
                load_chunks(next, c0, c0 + size, log2n, tile.log2_count, tile.in_tmajor, count_n,
                            at, [&](int c, int, int) { return slot[c - c0]; });
                ++j;
            } else if (j > 0 && s == 2 * j) {
                // slot (j - 1) & 1 was repacked before this stage's barrier
                issue_slice(raw + ((j + 1) & 1) * size, x, in, log2n, tile, tiles, kn, j + 1,
                            slices, size);
            }
        }
        store_global(words, y, out, log2n, tile, a, at);
    }
}

#ifdef __CUDACC__
#include <cuda_runtime.h>

typedef void (*VariantKernel)(const int64_t*, int64_t*, const uint32_t*, int, Strides, Strides,
                              Tile);

// The launch of ntt.cu's ntt_launch (gx, gy, gz transforms, the block
// taking 2^log2_count of them along dim with `threads` threads), with
// `extra` bytes of dynamic shared memory beyond the tile; `resident`: a
// grid of as many blocks as the card holds at once, at most one a tile.
static int launch(VariantKernel kernel, int extra, bool resident, const void* x, void* y,
                  const void* tw, int log2n, int gx, int gy, int gz, Strides in, Strides out,
                  int dim, int log2_count, int threads, int in_tmajor, int out_tmajor,
                  void* stream) {
    const int n = 1 << log2n;
    const int smem = ((n + 1) << log2_count) * (int)sizeof(Fe4) + extra;
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    int grid[3] = {gx, gy, gz};
    const Tile tile{dim, log2_count, grid[dim], in_tmajor, out_tmajor};
    grid[dim] = (grid[dim] + (1 << log2_count) - 1) >> log2_count;
    if (resident) {
        if (dim != 0 || gy != 1 || gz != 1) return (int)cudaErrorInvalidValue;
        int dev = 0, sms = 0, per_sm = 0;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
        if (e != cudaSuccess) return (int)e;
        if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
        if (grid[0] > per_sm * sms) grid[0] = per_sm * sms;
    }
    kernel<<<dim3(grid[0], grid[1], grid[2]), threads, smem, (cudaStream_t)stream>>>(
        (const int64_t*)x, (int64_t*)y, (const uint32_t*)tw, log2n, in, out, tile);
    return (int)cudaGetLastError();
}

// Every entry point takes ntt_launch's arguments (tw: the form's table) and
// returns cudaGetLastError().
#define VARIANT_LAUNCH(name, kernel, extra, resident)                                          \
    extern "C" int name(const void* x, void* y, const void* tw, int log2n, int gx, int gy,    \
                        int gz, long long in_bx, long long in_by, long long in_bz,            \
                        long long in_e, long long out_bx, long long out_by, long long out_bz, \
                        long long out_e, int dim, int log2_count, int threads, int in_tmajor, \
                        int out_tmajor, void* stream) {                                       \
        return launch(kernel, extra, resident, x, y, tw, log2n, gx, gy, gz,                   \
                      Strides{in_bx, in_by, in_bz, in_e},                                     \
                      Strides{out_bx, out_by, out_bz, out_e}, dim, log2_count, threads,       \
                      in_tmajor, out_tmajor, stream);                                         \
    }

VARIANT_LAUNCH(ntt_variant_b_launch, ntt_variant_b, ((1 << log2n) - 1) * (int)sizeof(Fe4), false)
VARIANT_LAUNCH(ntt_variant_c_launch, ntt_variant_c, 0, false)
VARIANT_LAUNCH(ntt_variant_d_launch, ntt_variant_d,
               (((1 << log2n) + 1) << log2_count) * (int)sizeof(Fe4) +
                   2 * (((1 << log2n) << (log2_count + 2)) / d_slices(log2n)) *
                       (int)sizeof(longlong2),
               true)
#endif
