// Elementwise GF(p) arithmetic on limb tensors: one launch a Montgomery
// product, modular addition, modular subtraction or REDC.
//
// Replaces: mont_mul (zk_stark_tpu/ops/limbs.py:181), add_mod (:146),
// sub_mod (:154) and from_mont's REDC (:235).  The JAX package calls them
// only inside its jitted prover and verifier segments, where XLA fuses
// each into one loop on the TPU (an XLA kernel, not a pl.pallas_call).
// The port's tensor code for them (ops/limbs.py, the *_plain functions)
// costs ~75 launches a product, ~40 of them elementwise; it stays as the
// plain version.
//
// One thread an output element, in a grid-stride loop: it reads one
// element of each operand (8 int64 limbs), repacks it to 4 words of 32
// bits, runs field.cuh's arithmetic in registers and writes 8 limbs.  The
// output is contiguous in the broadcast shape.  Each operand is read
// through the element strides of up to 4 leading dimensions, which the
// wrapper (ops/limbs.py kernel_plan) has collapsed where it could; a
// broadcast dimension has stride 0 and the limb stride is 1, so broadcast
// and strided operands need no copy.  All index arithmetic is 64-bit.
//
// Bound: device memory.  A full-shape product reads 2 x 64 B and writes
// 64 B (128 B with one broadcast operand, which stays in the cache)
// against 64 integer instructions (field.cuh): at 3.35 TB/s, 192 B take
// 57 ps and 64 instructions 2 ps at the card's issue rate.  The design
// spends one launch a call; vector loads and several elements a thread are
// later work.

#include <stdint.h>

#include "field.cuh"

namespace limbs {

// sizes or element strides of 4 leading dimensions, the innermost last;
// a call of ndim dimensions uses the last ndim
struct Index4 {
    int64_t v[4];
};

enum Op { kMul, kAdd, kSub, kRedc };

// the element offsets in a and b of output element i
__device__ __forceinline__ void offsets(int64_t i, const Index4& size, const Index4& sa,
                                        const Index4& sb, int ndim, int64_t& oa, int64_t& ob) {
    oa = 0;
    ob = 0;
#pragma unroll
    for (int d = 3; d >= 0; --d) {
        if (d == 4 - ndim) {  // the outermost dimension: what is left of i
            oa += i * sa.v[d];
            ob += i * sb.v[d];
            return;
        }
        const int64_t q = i / size.v[d];
        const int64_t r = i - q * size.v[d];
        oa += r * sa.v[d];
        ob += r * sb.v[d];
        i = q;
    }
}

template <int OP>
__device__ __forceinline__ void elementwise(const int64_t* __restrict__ a,
                                            const int64_t* __restrict__ b,
                                            int64_t* __restrict__ out, int64_t n, int ndim,
                                            const Index4& size, const Index4& sa,
                                            const Index4& sb) {
    const int64_t step = (int64_t)gridDim.x * blockDim.x;
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += step) {
        int64_t oa, ob;
        offsets(i, size, sa, sb, ndim, oa, ob);
        const zk::Fe x = zk::load_fe(a + oa);
        zk::Fe r;
        if constexpr (OP == kRedc) {
            r = zk::redc(x);
        } else {
            const zk::Fe y = zk::load_fe(b + ob);
            if constexpr (OP == kMul) r = zk::mont_mul(x, y);
            if constexpr (OP == kAdd) r = zk::add_mod(x, y);
            if constexpr (OP == kSub) r = zk::sub_mod(x, y);
        }
        zk::store_fe(out + 8 * i, r);
    }
}

}  // namespace limbs

// a, b: int64 limbs read at the element offsets of sizes and strides sa, sb;
// out: [n, 8] contiguous.  out = a * b * R^-1, a + b, a - b (mod p).
#define LIMBS_BINARY(NAME, OP)                                                          \
    extern "C" __global__ void NAME(const int64_t* __restrict__ a,                      \
                                    const int64_t* __restrict__ b,                      \
                                    int64_t* __restrict__ out, int64_t n, int ndim,     \
                                    limbs::Index4 size, limbs::Index4 sa,               \
                                    limbs::Index4 sb) {                                 \
        limbs::elementwise<OP>(a, b, out, n, ndim, size, sa, sb);                       \
    }
LIMBS_BINARY(limbs_mont_mul_kernel, limbs::kMul)
LIMBS_BINARY(limbs_add_mod_kernel, limbs::kAdd)
LIMBS_BINARY(limbs_sub_mod_kernel, limbs::kSub)
#undef LIMBS_BINARY

// out = a * R^-1 mod p (Montgomery form -> canonical)
extern "C" __global__ void limbs_redc_kernel(const int64_t* __restrict__ a,
                                             int64_t* __restrict__ out, int64_t n, int ndim,
                                             limbs::Index4 size, limbs::Index4 sa) {
    limbs::elementwise<limbs::kRedc>(a, nullptr, out, n, ndim, size, sa, sa);
}

#ifdef __CUDACC__
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// a grid-stride loop past 2^24 elements
constexpr int64_t kMaxBlocks = 1 << 16;

int blocks(int64_t n) {
    const int64_t b = (n + kThreads - 1) / kThreads;
    return (int)(b < kMaxBlocks ? b : kMaxBlocks);
}

limbs::Index4 index4(int64_t v0, int64_t v1, int64_t v2, int64_t v3) {
    return limbs::Index4{{v0, v1, v2, v3}};
}

}  // namespace

// n > 0 elements (a grid of no blocks is an invalid launch: the wrapper
// returns before it); 1 <= ndim <= 4
#define LIMBS_BINARY_LAUNCH(NAME, KERNEL)                                                \
    extern "C" int NAME(const void* a, const void* b, void* out, int64_t n, int ndim,    \
                        int64_t s0, int64_t s1, int64_t s2, int64_t s3, int64_t a0,      \
                        int64_t a1, int64_t a2, int64_t a3, int64_t b0, int64_t b1,      \
                        int64_t b2, int64_t b3, void* stream) {                          \
        KERNEL<<<blocks(n), kThreads, 0, (cudaStream_t)stream>>>(                        \
            (const int64_t*)a, (const int64_t*)b, (int64_t*)out, n, ndim,                \
            index4(s0, s1, s2, s3), index4(a0, a1, a2, a3), index4(b0, b1, b2, b3));     \
        return (int)cudaGetLastError();                                                  \
    }
LIMBS_BINARY_LAUNCH(limbs_mont_mul_launch, limbs_mont_mul_kernel)
LIMBS_BINARY_LAUNCH(limbs_add_mod_launch, limbs_add_mod_kernel)
LIMBS_BINARY_LAUNCH(limbs_sub_mod_launch, limbs_sub_mod_kernel)
#undef LIMBS_BINARY_LAUNCH

extern "C" int limbs_redc_launch(const void* a, void* out, int64_t n, int ndim, int64_t s0,
                                 int64_t s1, int64_t s2, int64_t s3, int64_t a0, int64_t a1,
                                 int64_t a2, int64_t a3, void* stream) {
    limbs_redc_kernel<<<blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
        (const int64_t*)a, (int64_t*)out, n, ndim, index4(s0, s1, s2, s3),
        index4(a0, a1, a2, a3));
    return (int)cudaGetLastError();
}
#endif
