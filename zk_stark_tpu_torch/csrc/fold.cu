// One FRI split-and-fold round.
//
// Replaces: _fold_kernel (zk_stark_tpu/ops/fold_pallas.py:42), launched by
// _fold_call (:76).  For i < n/2, with lo = cw[i], hi = cw[i + n/2]:
//
//     folded[i] = 2^-1 * ((lo + hi) + (alpha/offset) * w^-i * (lo - hi))
//     canon[i]  = REDC(folded[i])          (the next Merkle tree's leaves)
//
// One thread per output element: three Montgomery products, one REDC, two
// modular adds and one subtraction, all in registers.
//
// Bound: device memory.  Per output it reads lo, hi and w^-i (3 x 64 B as
// int64 limbs) and writes folded and canon (2 x 64 B); the ~70 32-bit
// multiplies per element are far below the integer rate for that traffic.
// At the signature's n <= 4096 the launch itself dominates; at the chain's
// n = 2^20 it takes 0.127 ms against a 0.050 ms bytes bound (H100 80GB
// HBM3, 700 W, chip_smoke.py).  The design fuses the whole round (and the
// canonical form) into one pass so the round costs one launch and one trip
// through memory.

#include <stdint.h>

#include "field.cuh"

using zk::Fe;

// cw: [n, 8]; ip: [n/2, 8] (w^-i, Montgomery); ao, ti: [8] (alpha/offset and
// 2^-1, Montgomery); folded, canon: [n/2, 8].  All int64 limbs.
extern "C" __global__ void fold_kernel(
    const int64_t* __restrict__ cw, const int64_t* __restrict__ ip,
    const int64_t* __restrict__ ao, const int64_t* __restrict__ ti,
    int64_t* __restrict__ folded, int64_t* __restrict__ canon, int half) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= half) return;
    const Fe lo = zk::load_fe(cw + 8 * (size_t)i);
    const Fe hi = zk::load_fe(cw + 8 * ((size_t)i + half));
    const Fe f = zk::mont_mul(zk::load_fe(ip + 8 * (size_t)i), zk::load_fe(ao));
    const Fe s = zk::add_mod(lo, hi);
    const Fe d = zk::sub_mod(lo, hi);
    const Fe out = zk::mont_mul(zk::load_fe(ti), zk::add_mod(s, zk::mont_mul(f, d)));
    zk::store_fe(folded + 8 * (size_t)i, out);
    zk::store_fe(canon + 8 * (size_t)i, zk::redc(out));
}

#ifdef __CUDACC__
#include <cuda_runtime.h>

extern "C" int fold_launch(const void* cw, const void* ip, const void* ao,
                           const void* ti, void* folded, void* canon, int half,
                           void* stream) {
    const int threads = 128;
    const int blocks = (half + threads - 1) / threads;
    fold_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const int64_t*)cw, (const int64_t*)ip, (const int64_t*)ao,
        (const int64_t*)ti, (int64_t*)folded, (int64_t*)canon, half);
    return (int)cudaGetLastError();
}
#endif
