// The pieces the NTT stage kernels share (ntt.cu, ntt_variants.cu): an
// element in shared memory as 4 words of 32 bits, two layouts of a block's
// transforms in shared memory, and the radix-2 DIT butterfly stages of the
// transforms a block holds.

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

// Where element q of transform t of a block lives in shared memory (in
// elements of 16 bytes).  FlatLayout: one transform, q itself.
// TileLayout (ntt.cu): transforms at a stride of n + 1 elements, and from
// n = 64 on the low three bits of q XOR-ed with its top three.  An element
// spans 4 of the 32 banks, so 8 elements that a quarter of a warp touches
// at once should differ in their index mod 8: the pad separates the same q
// of neighbouring transforms, the XOR the bit-reversed scatter of 8
// neighbouring q (which differ in their top bits only), while neighbouring q
// (the butterflies of a stage, the natural-order store) keep distinct low
// bits.
struct FlatLayout {
    __device__ __forceinline__ int operator()(int, int q) const { return q; }
};

struct TileLayout {
    int log2n;
    __device__ __forceinline__ int operator()(int t, int q) const {
        const int swz = log2n >= 6 ? (q >> (log2n - 3)) & 7 : 0;
        return t * ((1 << log2n) + 1) + (q ^ swz);
    }
};

// Stages s0 .. log2n-1 of the ``count`` transforms in sh (laid out by
// ``at``), each stage followed by a barrier: the input of stage 0 is in
// bit-reversed order, the output of the last in natural order.  Stage s
// pairs i0 and i0 + 2^s and multiplies the odd one by
// tw4[j << (log2n - 1 - s)], tw4 the [n/2] table root^k.  The butterflies
// of all the transforms are one block-stride loop.
template <class Layout>
__device__ __forceinline__ void stages_shared(Fe4* sh, const Fe4* __restrict__ tw4,
                                              int log2n, int s0, int count, Layout at) {
    const int half = 1 << (log2n - 1);
    for (int s = s0; s < log2n; ++s) {
        const int h = 1 << s;
        const int tstep = log2n - 1 - s;  // twiddle index = j << tstep
        for (int b = threadIdx.x; b < count * half; b += blockDim.x) {
            const int t = b >> (log2n - 1);
            const int bb = b & (half - 1);
            const int j = bb & (h - 1);
            const int i0 = ((bb >> s) << (s + 1)) + j;
            const int p0 = at(t, i0), p1 = at(t, i0 + h);
            const Fe e = from4(sh[p0]);
            const Fe v = zk::mont_mul(from4(sh[p1]), from4(tw4[j << tstep]));
            sh[p0] = to4(zk::add_mod(e, v));
            sh[p1] = to4(zk::sub_mod(e, v));
        }
        __syncthreads();
    }
}
