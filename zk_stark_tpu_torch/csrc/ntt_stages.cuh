// The pieces the NTT stage kernels share (ntt.cu, ntt_variants.cu): an
// element in shared memory as 4 words of 32 bits, and the radix-2 DIT
// butterfly stages of one transform held in shared memory.

#pragma once

#include <stdint.h>

#include "field.cuh"

using zk::Fe;

struct alignas(16) Fe4 {
    uint32_t w[4];
};

__device__ __forceinline__ Fe from4(const Fe4& v) {
    Fe r;
#pragma unroll
    for (int k = 0; k < 4; ++k) r.w[k] = v.w[k];
    return r;
}

__device__ __forceinline__ Fe4 to4(const Fe& v) {
    Fe4 r;
#pragma unroll
    for (int k = 0; k < 4; ++k) r.w[k] = v.w[k];
    return r;
}

__device__ __forceinline__ unsigned bit_reverse(unsigned i, int log2n) {
#ifdef __CUDA_ARCH__
    return __brev(i) >> (32 - log2n);
#else
    unsigned r = 0;
    for (int b = 0; b < log2n; ++b) r |= ((i >> b) & 1u) << (log2n - 1 - b);
    return r;
#endif
}

// Stages s0 .. log2n-1 of the transform in sh[0, 2^log2n), each followed by
// a barrier: the input of stage 0 is in bit-reversed order, the output of
// the last in natural order.  Stage s pairs i0 and i0 + 2^s and multiplies
// the odd one by tw4[j << (log2n - 1 - s)], tw4 the [n/2] table root^k.
__device__ __forceinline__ void stages_shared(Fe4* sh, const Fe4* __restrict__ tw4,
                                              int log2n, int s0) {
    const int n = 1 << log2n;
    for (int s = s0; s < log2n; ++s) {
        const int h = 1 << s;
        const int tstep = log2n - 1 - s;  // twiddle index = j << tstep
        for (int b = threadIdx.x; b < n / 2; b += blockDim.x) {
            const int j = b & (h - 1);
            const int i0 = ((b >> s) << (s + 1)) + j;
            const int i1 = i0 + h;
            const Fe e = from4(sh[i0]);
            const Fe t = zk::mont_mul(from4(sh[i1]), from4(tw4[j << tstep]));
            sh[i0] = to4(zk::add_mod(e, t));
            sh[i1] = to4(zk::sub_mod(e, t));
        }
        __syncthreads();
    }
}
