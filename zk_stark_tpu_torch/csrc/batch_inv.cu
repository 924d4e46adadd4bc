// Batched inversion of field elements in Montgomery form, zeros to zero:
// Montgomery's trick inside a block, the block's total inverted in place.
//
// Replaces: batch_inv (zk_stark_tpu/ops/limbs.py:410) with its root's
// mont_inv_fermat (:366).  The JAX package runs them inside its jitted
// segments as one XLA fusion region (a prefix and a suffix blocked
// cumulative product, one Fermat inversion of the total); the port's tensor
// code for them (ops/limbs.py batch_inv_plain, a product tree) costs 30-40
// launches a call and stays as the plain version.
//
// Bound: 64 B read and 64 B written an element against ~3 products (192
// instructions, field.cuh), so bytes; but the paths call it at 284 to 2^18
// elements, where the floor is latency: one thread's inversion of the
// total (inverse.cuh inv_binary, ~91 rounds) and a chain of dependent
// products, log2(threads) + 2 * K + 1 of them.  On an H100 a call of 1024
// elements took 0.022 ms, the root ~0.008 of it and the rest one SM's
// scans (tools/kernel_shape_probe.py batch_inv_builds, root_inverse).  So
// the design keeps every dependent chain short:
//
// * A block of `threads` threads (a power of two) takes K consecutive
//   stretches of `threads` elements: thread j element j + i * threads of
//   stretch i, so a warp's loads and stores are 32 neighbouring records.
//   A zero is read as one (and written as zero).  Each thread keeps the
//   inclusive prefix products of its K elements in registers.
// * The threads' totals are scanned both ways at once, prefix and suffix,
//   by shuffles of the four 32-bit words: within each warp, then across
//   the warps by warp 0 over their totals in shared memory.  Thread j then
//   holds the product of every other thread's total (before * after),
//   and so the inverse of its own total is inv(block total) * that.
// * Walking its elements backwards from that inverse, a thread writes
//   out_i = inv * prefix_(i-1) and goes on with inv * x_i.
//
// Launches: n <= threads * K (the block's capacity C) is one block that
// inverts its own total (`totals` and `inv_totals` null).  Above C the
// wrapper (ops/limbs.py batch_inv_grid) launches three times: each block
// writes its total to `totals` [blocks, 8]; the totals are inverted as a
// batch of their own (one block while blocks <= C, else the same three
// launches again); each block reads the inverse of its total from
// `inv_totals` and writes its outputs.  Each element is read once a launch
// and written once; the block's scratch is (3 * warps + 1) elements of
// dynamic shared memory (under 48 KB: no attribute to set).

#include <stdint.h>

#include "field.cuh"
#include "inverse.cuh"
#include "tiles.cuh"

namespace binv {

constexpr int kMaxThreads = 1024;
constexpr int kWarp = 32;

// R mod p: the Montgomery form of one
__device__ __forceinline__ zk::Fe one() {
    return zk::Fe{{0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0x347FFFFFu}};
}

__device__ __forceinline__ bool is_zero(const zk::Fe& x) {
    return (x.w[0] | x.w[1] | x.w[2] | x.w[3]) == 0;
}

__device__ __forceinline__ zk::Fe shfl(unsigned mask, const zk::Fe& x, int src, int width) {
    zk::Fe r;
#pragma unroll
    for (int k = 0; k < 4; ++k) r.w[k] = __shfl_sync(mask, x.w[k], src, width);
    return r;
}

// over the lanes of a group of `width` (a power of two): pre becomes the
// product of the lanes up to this one, suf of this one and those after it.
// A lane with no lane d before (after) it multiplies by one: every lane
// runs both products, which overlap, and no branch splits the warp.
__device__ __forceinline__ void scan(unsigned mask, int lane, int width, zk::Fe& pre,
                                     zk::Fe& suf) {
#pragma unroll 1
    for (int d = 1; d < width; d <<= 1) {
        const zk::Fe up = shfl(mask, pre, lane - d, width);
        const zk::Fe down = shfl(mask, suf, lane + d, width);
        pre = zk::mont_mul(pre, lane >= d ? up : one());
        suf = zk::mont_mul(suf, lane + d < width ? down : one());
    }
}

// after scan: the products of the lanes before this one and after it
__device__ __forceinline__ void others(unsigned mask, int lane, int width, const zk::Fe& pre,
                                       const zk::Fe& suf, zk::Fe& before, zk::Fe& after) {
    before = shfl(mask, pre, lane - 1, width);
    after = shfl(mask, suf, lane + 1, width);
    if (lane == 0) before = one();
    if (lane == width - 1) after = one();
}

template <int K>
__device__ __forceinline__ void run(const int64_t* __restrict__ a, int64_t* __restrict__ out,
                                    int64_t n, int64_t* __restrict__ totals,
                                    const int64_t* __restrict__ inv_totals, zk::Fe* sm) {
    const int t = threadIdx.x;
    const int threads = blockDim.x;
    // a block narrower than a warp (the host tests' small blocks) is one
    // partial warp
    const int width = threads < kWarp ? threads : kWarp;
    const unsigned mask = width == kWarp ? 0xFFFFFFFFu : (1u << width) - 1u;
    const int lane = t & (width - 1);
    const int warp = t / width;
    const int warps = threads / width;
    const int64_t first = (int64_t)blockIdx.x * threads * K + t;
    zk::Fe* warp_total = sm;
    zk::Fe* warps_before = sm + warps;
    zk::Fe* warps_after = sm + 2 * warps;
    zk::Fe* root = sm + 3 * warps;

    zk::Fe inv_total{};
    if (inv_totals != nullptr) inv_total = tiles::load_fe<true>(inv_totals + 8 * blockIdx.x, 0);

    zk::Fe x[K], pre[K];
#pragma unroll
    for (int i = 0; i < K; ++i) {
        const int64_t e = first + (int64_t)i * threads;
        x[i] = e < n ? tiles::load_fe<true>(a + 8 * e, 0) : one();
    }
    unsigned zeros = 0;
#pragma unroll
    for (int i = 0; i < K; ++i) {
        if (is_zero(x[i])) {
            x[i] = one();
            zeros |= 1u << i;
        }
        pre[i] = i ? zk::mont_mul(pre[i - 1], x[i]) : x[i];
    }

    // the warp, both ways; lane width - 1 holds the warp's total
    zk::Fe p = pre[K - 1], s = p, lane_before, lane_after;
    scan(mask, lane, width, p, s);
    others(mask, lane, width, p, s, lane_before, lane_after);
    if (lane == width - 1) warp_total[warp] = p;
    __syncthreads();

    // the warps, by warp 0; its lane warps - 1 holds the block's total
    if (warp == 0) {
        const int wl = lane & (warps - 1);
        zk::Fe wp = lane < warps ? warp_total[lane] : one(), ws = wp, wb, wa;
        scan(mask, wl, warps, wp, ws);
        others(mask, wl, warps, wp, ws, wb, wa);
        if (lane < warps) {
            warps_before[lane] = wb;
            warps_after[lane] = wa;
        }
        if (lane == warps - 1) {
            if (totals != nullptr) {
                tiles::store_fe(totals + 8 * blockIdx.x, wp, 0);
            } else if (inv_totals == nullptr) {
                *root = zk::inv_binary(wp);
            }
        }
    }
    if (totals != nullptr) return;
    const zk::Fe mine = zk::mont_mul(lane_before, lane_after);  // while the root inverts
    __syncthreads();
    if (inv_totals == nullptr) inv_total = *root;

    // the inverse of this thread's total, then its elements last to first
    zk::Fe acc = zk::mont_mul(zk::mont_mul(inv_total, mine),
                              zk::mont_mul(warps_before[warp], warps_after[warp]));
#pragma unroll
    for (int i = K - 1; i >= 0; --i) {
        const int64_t e = first + (int64_t)i * threads;
        if (e >= n) continue;
        const zk::Fe r = i ? zk::mont_mul(acc, pre[i - 1]) : acc;
        tiles::store_fe(out + 8 * e, (zeros >> i) & 1u ? zk::Fe{{0u, 0u, 0u, 0u}} : r, 0);
        acc = zk::mont_mul(acc, x[i]);
    }
}

}  // namespace binv

// a: [n, 8] limbs in Montgomery form, contiguous and 16-byte aligned.
// Block b takes elements [b * C, (b + 1) * C), C = blockDim.x * K.  With
// `totals`: write the block's total (zeros as one) to totals[b] and no
// output.  With `inv_totals`: the inverse of the block's total is
// inv_totals[b]; write out.  With neither (one block): invert the total
// in place; write out.
#define BATCH_INV_KERNEL(K)                                                                \
    extern "C" __global__ void __launch_bounds__(binv::kMaxThreads)                        \
        batch_inv_kernel_k##K(const int64_t* __restrict__ a, int64_t* __restrict__ out,    \
                              int64_t n, int64_t* __restrict__ totals,                     \
                              const int64_t* __restrict__ inv_totals) {                    \
        extern __shared__ longlong2 batch_inv_smem[];                                      \
        binv::run<K>(a, out, n, totals, inv_totals,                                        \
                     reinterpret_cast<zk::Fe*>(batch_inv_smem));                           \
    }
BATCH_INV_KERNEL(1)
BATCH_INV_KERNEL(2)
BATCH_INV_KERNEL(4)
BATCH_INV_KERNEL(8)
#undef BATCH_INV_KERNEL

#ifdef __CUDACC__
#include <cuda_runtime.h>

// blocks >= 1; threads a power of two in [32, 1024]; per_thread (K) 1, 2,
// 4 or 8; n <= blocks * threads * K < 2^31 elements.  Anything else is
// refused as cudaErrorInvalidValue, before any launch.
extern "C" int batch_inv_launch(const void* a, void* out, int64_t n, void* totals,
                                const void* inv_totals, int blocks, int threads, int per_thread,
                                void* stream) {
    void (*kernel)(const int64_t*, int64_t*, int64_t, int64_t*, const int64_t*) =
        per_thread == 1   ? batch_inv_kernel_k1
        : per_thread == 2 ? batch_inv_kernel_k2
        : per_thread == 4 ? batch_inv_kernel_k4
        : per_thread == 8 ? batch_inv_kernel_k8
                          : nullptr;
    if (kernel == nullptr || blocks < 1 || threads < binv::kWarp || threads > binv::kMaxThreads ||
        (threads & (threads - 1)) != 0 || n < 1 || n > (int64_t)blocks * threads * per_thread)
        return (int)cudaErrorInvalidValue;
    const size_t smem = (3 * (threads / binv::kWarp) + 1) * sizeof(zk::Fe);
    kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
        (const int64_t*)a, (int64_t*)out, n, (int64_t*)totals, (const int64_t*)inv_totals);
    return (int)cudaGetLastError();
}
#endif
