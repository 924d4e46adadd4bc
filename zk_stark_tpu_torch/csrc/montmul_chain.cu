// Chained Montgomery products: y <- y * x, k times from y = x, per element.
//
// Replaces: kern (bench.py:202), launched by the pl.pallas_call at :213,
// the JAX bench's calibration kernel: 32 unrolled mont_mul_planes on a
// [8, 128, 128] tile held in VMEM, whose measured time per product prices
// the Rescue batch and the NTT in the bench's roofline (bench.py:119-142).
//
// It exists to be timed: at n = 2^18 and k = 32 (the bench's sizes) it
// gives the card's rate of full Montgomery products, and its SASS the
// instructions one product costs as compiled.  So the design keeps the
// products' issue, and nothing else, in the way:
//
//   - each thread carries kChains elements' chains at once, interleaved in
//     the unrolled 32-product body, so that a product that does not wait
//     on the one before it is always at hand (elements g + c * G of the
//     thread's group g, c < kChains, G = ceil(n / kChains) groups: each
//     chain's loads coalesce across the warp; the tail of n past a
//     multiple of kChains is masked, its products computed on x = 0 and
//     not stored);
//   - the grid is what the card holds at once (blocks an SM from the
//     occupancy calculator, times the SMs, at most one group a thread),
//     each thread striding over the groups, so no partial second wave of
//     blocks sets the time; __launch_bounds__ holds the register count
//     that gives that occupancy;
//   - an element's 64 bytes move as four 16-byte chunks.
//
// kChains is one compile-time value, chosen on the card: 1.  At 2 and 4
// (tools/kernel_shape_probe.py montmul_chains; PERF.md) a thread takes 45
// and 72 registers against 27, so fewer warps fit an SM, and the compiler
// still runs a thread's products one after the other (field.cuh's product
// is one carry-chained PTX block, and two of them do not interleave): k =
// 1024 took 17-19 % and 43-55 % longer.
//
// Bound: operations.  64 bytes in and 64 out per element against k products
// of 64 integer instructions each (field.cuh; tools/measure.py mont_mul_ops).

#include <stdint.h>

#include "field.cuh"

constexpr int kChains = 1;
constexpr int kThreads = 128;
// blocks an SM the register cap allows: 64 registers a thread up to two
// chains, 80 at four
constexpr int kMinBlocks = kChains >= 4 ? 6 : 8;

// an element's four 16-byte chunks of two 16-bit limbs: word k is chunk k
__device__ __forceinline__ zk::Fe load_chunks(const int64_t* limbs) {
    zk::Fe r;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        const longlong2 v = reinterpret_cast<const longlong2*>(limbs)[k];
        r.w[k] = (uint32_t)v.x | ((uint32_t)v.y << 16);
    }
    return r;
}

__device__ __forceinline__ void store_chunks(int64_t* limbs, const zk::Fe& a) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        longlong2 v;
        v.x = (long long)(a.w[k] & 0xFFFFu);
        v.y = (long long)(a.w[k] >> 16);
        reinterpret_cast<longlong2*>(limbs)[k] = v;
    }
}

// x, y: [n, 8] int64 limbs (Montgomery), 16-byte aligned
extern "C" __global__ void __launch_bounds__(kThreads, kMinBlocks) montmul_chain_kernel(
    const int64_t* __restrict__ x, int64_t* __restrict__ y, int n, int k) {
    const int groups = (n + kChains - 1) / kChains;
    for (int g = blockIdx.x * blockDim.x + threadIdx.x; g < groups; g += gridDim.x * blockDim.x) {
        zk::Fe a[kChains], acc[kChains];
#pragma unroll
        for (int c = 0; c < kChains; ++c) {
            const int e = g + c * groups;
            a[c] = e < n ? load_chunks(x + 8 * (size_t)e) : zk::Fe{{0u, 0u, 0u, 0u}};
            acc[c] = a[c];
        }
        int r = 0;
#pragma unroll 1
        for (; r + 32 <= k; r += 32) {
#pragma unroll
            for (int u = 0; u < 32; ++u) {
#pragma unroll
                for (int c = 0; c < kChains; ++c) acc[c] = zk::mont_mul(acc[c], a[c]);
            }
        }
#pragma unroll 1
        for (; r < k; ++r) {
#pragma unroll
            for (int c = 0; c < kChains; ++c) acc[c] = zk::mont_mul(acc[c], a[c]);
        }
#pragma unroll
        for (int c = 0; c < kChains; ++c) {
            const int e = g + c * groups;
            if (e < n) store_chunks(y + 8 * (size_t)e, acc[c]);
        }
    }
}

#ifdef __CUDACC__
#include <cuda_runtime.h>

extern "C" int montmul_chain_launch(const void* x, void* y, int n, int k, void* stream) {
    constexpr int kMaxDevices = 16;
    static int resident[kMaxDevices] = {};  // blocks the card holds at once
    int dev = 0;
    cudaGetDevice(&dev);
    int& cap = resident[dev < kMaxDevices ? dev : kMaxDevices - 1];
    if (cap == 0) {
        int sms = 0, per_sm = 0;
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, montmul_chain_kernel, kThreads, 0);
        if (e != cudaSuccess) return (int)e;
        cap = per_sm * sms;
    }
    const int groups = (n + kChains - 1) / kChains;
    const int need = (groups + kThreads - 1) / kThreads;
    montmul_chain_kernel<<<need < cap ? need : cap, kThreads, 0, (cudaStream_t)stream>>>(
        (const int64_t*)x, (int64_t*)y, n, k);
    return (int)cudaGetLastError();
}
#endif
