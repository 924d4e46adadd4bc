// Chained Montgomery products: y <- y * x, k times from y = x, per element.
//
// Replaces: kern (bench.py:202), launched by the pl.pallas_call at :213,
// the JAX bench's calibration kernel: 32 unrolled mont_mul_planes on a
// [8, 128, 128] tile held in VMEM, whose measured time per product prices
// the Rescue batch and the NTT in the bench's roofline (bench.py:119-142).
//
// Here one thread owns one element and runs the k dependent products in
// registers; the 32-product body is unrolled, and the compiler cannot fold
// it because every product takes the last one's result.  It exists to be
// timed: at n = 2^18 and k = 32 (the bench's sizes) it gives the card's
// rate of full Montgomery products with 2^18 independent chains in flight,
// and its SASS gives the instructions one product costs as compiled.
//
// Bound: operations.  64 bytes in and 64 out per element against k products
// of 64 integer instructions each (field.cuh; tools/measure.py mont_mul_ops).

#include <stdint.h>

#include "field.cuh"

// x, y: [n, 8] int64 limbs (Montgomery)
extern "C" __global__ void montmul_chain_kernel(const int64_t* __restrict__ x,
                                                int64_t* __restrict__ y, int n, int k) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const zk::Fe a = zk::load_fe(x + 8 * (size_t)i);
    zk::Fe acc = a;
    int r = 0;
#pragma unroll 1
    for (; r + 32 <= k; r += 32) {
#pragma unroll
        for (int u = 0; u < 32; ++u) acc = zk::mont_mul(acc, a);
    }
#pragma unroll 1
    for (; r < k; ++r) acc = zk::mont_mul(acc, a);
    zk::store_fe(y + 8 * (size_t)i, acc);
}

#ifdef __CUDACC__
#include <cuda_runtime.h>

extern "C" int montmul_chain_launch(const void* x, void* y, int n, int k, void* stream) {
    const int threads = 128;
    montmul_chain_kernel<<<(n + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
        (const int64_t*)x, (int64_t*)y, n, k);
    return (int)cudaGetLastError();
}
#endif
