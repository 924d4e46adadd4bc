// One FRI split-and-fold round.
//
// Replaces: _fold_kernel (zk_stark_tpu/ops/fold_pallas.py:42), launched by
// _fold_call (:76).  For i < n/2, with lo = cw[i], hi = cw[i + n/2]:
//
//     folded[i] = 2^-1 * ((lo + hi) + (alpha/offset) * w^-i * (lo - hi))
//     canon[i]  = REDC(folded[i])          (the next Merkle tree's leaves)
//
// Bound: device memory.  Per output it reads lo, hi and w^-i (3 x 64 B as
// int64 limbs) and writes folded and canon (2 x 64 B); its 4 products, 2
// additions and 1 subtraction (~300 32-bit instructions) are far below the
// integer rate for that traffic.  So the design is about moving bytes, on
// what csrc/limbs.cu built for the H100 (csrc/tiles.cuh):
//
// * Persistent blocks of kThreads threads walk tiles of up to kThreads
//   output elements (one a thread), double-buffered in shared memory:
//   while a block computes one tile, the bulk copy engine fetches the lo,
//   hi and w^-i tiles of its next one (three cp.async.bulk on one
//   mbarrier), and the folded and canon tiles leave as one bulk store each.
// * A thread reads its element's 4 chunks from the rotated start
//   (tiles::rotation), so 8 threads' 16-byte reads hit 8 bank groups.
// * alpha/offset and 2^-1 are read once by each thread.
// * Calls of fewer than a tile per SM (a sign's 2048 outputs) get smaller
//   tiles, ceil(half / SMs) rounded up to kMinTile, so that they spread
//   over the SMs.
//
// The wrapper (ops/fold.py) passes 16-byte aligned, contiguous operands
// (it copies one that starts mid-element) and fewer than 2^31 outputs.

#include <stdint.h>

#include "field.cuh"
#include "tiles.cuh"

namespace fold {

constexpr int kThreads = 128;
constexpr int kStages = 2;
// arrays a stage holds: lo, hi, w^-i in; folded, canon out
constexpr int kArrays = 5;
// the stages' mbarriers, padded so that the tiles start 128-byte aligned
constexpr int kBarrierBytes = 128;
// the smallest tile a small call is cut into
constexpr int kMinTile = 32;

__host__ __device__ inline int smem_bytes(int tile) {
    return kBarrierBytes + kStages * kArrays * tile * tiles::kRecordBytes;
}

}  // namespace fold

using zk::Fe;

// cw: [2 half, 8]; ip: [half, 8] (w^-i, Montgomery); ao, ti: [8] (alpha/offset
// and 2^-1, Montgomery); folded, canon: [half, 8].  All int64 limbs.  tile:
// output elements a tile, at most blockDim.x.
extern "C" __global__ void __launch_bounds__(fold::kThreads) fold_kernel(
    const int64_t* __restrict__ cw, const int64_t* __restrict__ ip,
    const int64_t* __restrict__ ao, const int64_t* __restrict__ ti,
    int64_t* __restrict__ folded, int64_t* __restrict__ canon, int half, int tile) {
    extern __shared__ longlong2 fold_smem[];
    unsigned char* smem = reinterpret_cast<unsigned char*>(fold_smem);
    uint64_t* full = reinterpret_cast<uint64_t*>(smem);  // one mbarrier a stage
    int64_t* stages = reinterpret_cast<int64_t*>(smem + fold::kBarrierBytes);
    const int t = threadIdx.x;
    const int ntiles = (half + tile - 1) / tile;
    const int tile_limbs = 8 * tile;
    // array k of stage s: 0 lo, 1 hi, 2 w^-i, 3 folded, 4 canon
    auto array = [&](int s, int k) { return stages + (s * fold::kArrays + k) * tile_limbs; };
    auto count_of = [&](int base) { return half - base < tile ? half - base : tile; };

    const Fe a_o = tiles::load_fe<true>(ao, 0);
    const Fe t_i = tiles::load_fe<true>(ti, 0);

    // thread 0: the three input tiles of this block's i-th tile into stage s
    auto fetch = [&](int i, int s) {
        const int tl = blockIdx.x + i * gridDim.x;
        if (tl >= ntiles) return;
        const int base = tl * tile;
        const uint32_t bytes = (uint32_t)count_of(base) * tiles::kRecordBytes;
        tiles::bar_expect(full + s, 3 * bytes);
        tiles::load_async(array(s, 0), cw + 8 * (int64_t)base, bytes, full + s);
        tiles::load_async(array(s, 1), cw + 8 * ((int64_t)half + base), bytes, full + s);
        tiles::load_async(array(s, 2), ip + 8 * (int64_t)base, bytes, full + s);
    };
    if (t == 0) {
        for (int s = 0; s < fold::kStages; ++s) tiles::bar_init(full + s);
    }
    __syncthreads();
    if (t == 0) {
        for (int s = 0; s < fold::kStages; ++s) fetch(s, s);
    }

    for (int i = 0;; ++i) {
        const int tl = blockIdx.x + i * gridDim.x;
        if (tl >= ntiles) break;
        const int s = i % fold::kStages;
        const int base = tl * tile;
        const int count = count_of(base);
        const bool live = t < count;
        const int rot = tiles::rotation(t);
        tiles::bar_wait(full + s, (uint32_t)(i / fold::kStages) & 1u);

        Fe out{}, out_canon{};
        if (live) {
            const Fe lo = tiles::load_fe<false>(array(s, 0) + 8 * t, rot);
            const Fe hi = tiles::load_fe<false>(array(s, 1) + 8 * t, rot);
            const Fe f = zk::mont_mul(tiles::load_fe<false>(array(s, 2) + 8 * t, rot), a_o);
            const Fe sum = zk::add_mod(lo, hi);
            const Fe diff = zk::sub_mod(lo, hi);
            out = zk::mont_mul(t_i, zk::add_mod(sum, zk::mont_mul(f, diff)));
            out_canon = zk::redc(out);
        }

        // stage s's output tiles are free once the two stores that left from
        // them kStages tiles ago have read them (stores complete in order)
        if (t == 0) tiles::store_wait_read<2 * (fold::kStages - 1)>();
        __syncthreads();  // stage s's input tiles are read: refill them
        if (t == 0) fetch(i + fold::kStages, s);
        if (live) {
            tiles::store_fe(array(s, 3) + 8 * t, out, rot);
            tiles::store_fe(array(s, 4) + 8 * t, out_canon, rot);
        }
        tiles::fence_async();
        __syncthreads();
        if (t == 0) {
            const uint32_t bytes = (uint32_t)count * tiles::kRecordBytes;
            tiles::store_async(folded + 8 * (int64_t)base, array(s, 3), bytes);
            tiles::store_async(canon + 8 * (int64_t)base, array(s, 4), bytes);
        }
    }
    if (t == 0) tiles::store_wait_all();
}

#ifdef __CUDACC__
#include <cuda_runtime.h>

namespace {

constexpr int kMaxDevices = 16;

int device() {
    int dev = 0;
    cudaGetDevice(&dev);
    return dev < kMaxDevices ? dev : kMaxDevices - 1;
}

int sm_count() {
    static int sms[kMaxDevices] = {};
    const int dev = device();
    if (sms[dev] == 0) cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    return sms[dev];
}

}  // namespace

// 0 < half < 2^31 outputs (the wrapper returns before an empty call)
extern "C" int fold_launch(const void* cw, const void* ip, const void* ao,
                           const void* ti, void* folded, void* canon, int half,
                           void* stream) {
    static int per_sm[kMaxDevices] = {};
    const int dev = device();
    if (per_sm[dev] == 0) {  // the first launch on this card
        cudaFuncSetAttribute(fold_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             fold::smem_bytes(fold::kThreads));
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm[dev], fold_kernel, fold::kThreads,
                                                      fold::smem_bytes(fold::kThreads));
        if (per_sm[dev] < 1) per_sm[dev] = 1;
    }
    // a full tile, or for fewer than a tile an SM about one tile an SM
    const int64_t sms = sm_count();
    int tile = fold::kThreads;
    if ((int64_t)half < (int64_t)fold::kThreads * sms) {
        const int64_t t = ((half + sms - 1) / sms + fold::kMinTile - 1) / fold::kMinTile
                          * fold::kMinTile;
        tile = (int)(t < fold::kThreads ? t : fold::kThreads);
    }
    const int64_t ntiles = (half + tile - 1) / tile;
    const int64_t cap = sms * per_sm[dev];
    const int blocks = (int)(ntiles < cap ? ntiles : cap);
    fold_kernel<<<blocks, fold::kThreads, fold::smem_bytes(tile), (cudaStream_t)stream>>>(
        (const int64_t*)cw, (const int64_t*)ip, (const int64_t*)ao, (const int64_t*)ti,
        (int64_t*)folded, (int64_t*)canon, half, tile);
    return (int)cudaGetLastError();
}
#endif
