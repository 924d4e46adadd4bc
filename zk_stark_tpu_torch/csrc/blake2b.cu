// BLAKE2b-512 Merkle hashing: leaves, inner nodes, and bare compressions.
//
// Replaces: _leaf_fused_kernel (zk_stark_tpu/ops/blake2b_dev.py:373, with
// _leaf_tile :315 and _compress :152), launched by _leaf_fused_call (:420);
// _node_split_kernel (:383), launched by _node_split_call (:449); and
// _compress_pallas_kernel (:224), launched by _compress_call (:260) through
// _compress_words (:277).
//
// Every message fits one compression block, so each digest is one
// final-block BLAKE2b-512 compression (RFC 7693):
//
// * leaf: the canonical field element's decimal string, left-aligned, as
//   the message (value 0 is "0"); t = number of digits.  Byte-identical to
//   hashlib.blake2b(str(v).encode(), digest_size=64).
// * node: parent i = H(child[2i] || child[2i+1]), 128 bytes, t = 128.  The
//   levels are in natural order, so the two children are one contiguous
//   128-byte run: the TPU kernel's bit-reversed "split" layout was a Mosaic
//   lowering workaround and is not needed here.
// * compress: any 16 message words and byte count t (0 <= t <= 128), as
//   (hi, lo) 32-bit halves of each little-endian 64-bit word in int64
//   planes [16, n] (the JAX package's [16, m] uint32 pair), digest halves
//   out as [8, n].  Word k of message i sits at k * n + i, so the threads of
//   a warp read and write neighbouring words.
//
// The TPU carried each 64-bit word as two 32-bit halves; Hopper has native
// 64-bit adds and rotates (funnel shifts), so the state is 16 uint64_t in
// registers and the 12 rounds are unrolled with the message schedule as
// literal indices (no dynamic indexing, no local memory for the message).
//
// Bound: operations.  A compression is ~2.9k 64-bit integer ops (96 G
// mixes) for at most 128 bytes in and 64 out; a 64-bit add or rotate is
// several 32-bit instructions on the SM.  One thread per digest gives the
// card n (or n/2) independent compressions; at the signature's 4096 leaves
// that is 32 blocks of 128, which fills a quarter of the SMs.  At the
// chain's 2^20 leaves (2^19 parents) the leaf takes 0.268 ms against a
// 0.104 ms bound and the node 0.075 ms against 0.042 ms (H100 80GB HBM3,
// 700 W, chip_smoke.py, bound at the SM issue rate).  The compress
// interface carries every 32-bit half in an int64 (the JAX package's word
// planes in the port's limb dtype): 392 bytes a message, so bytes bound it
// where the leaf and node are bound by operations.

#include <stdint.h>

#include "field.cuh"

namespace {

__device__ __forceinline__ uint64_t rotr64(uint64_t x, int r) {
    return (x >> r) | (x << (64 - r));
}

#define B2B_IV0 0x6A09E667F3BCC908ULL
#define B2B_IV1 0xBB67AE8584CAA73BULL
#define B2B_IV2 0x3C6EF372FE94F82BULL
#define B2B_IV3 0xA54FF53A5F1D36F1ULL
#define B2B_IV4 0x510E527FADE682D1ULL
#define B2B_IV5 0x9B05688C2B3E6C1FULL
#define B2B_IV6 0x1F83D9ABFB41BD6BULL
#define B2B_IV7 0x5BE0CD19137E2179ULL
// parameter block word 0: digest length 64, no key, fanout 1, depth 1
#define B2B_H0 (B2B_IV0 ^ 0x01010040ULL)

#define B2B_G(a, b, c, d, x, y)      \
    do {                             \
        a = a + b + (x);             \
        d = rotr64(d ^ a, 32);       \
        c = c + d;                   \
        b = rotr64(b ^ c, 24);       \
        a = a + b + (y);             \
        d = rotr64(d ^ a, 16);       \
        c = c + d;                   \
        b = rotr64(b ^ c, 63);       \
    } while (0)

#define B2B_ROUND(s0, s1, s2, s3, s4, s5, s6, s7, s8, s9, s10, s11, s12, s13, s14, s15) \
    do {                                                   \
        B2B_G(v0, v4, v8, v12, m[s0], m[s1]);              \
        B2B_G(v1, v5, v9, v13, m[s2], m[s3]);              \
        B2B_G(v2, v6, v10, v14, m[s4], m[s5]);             \
        B2B_G(v3, v7, v11, v15, m[s6], m[s7]);             \
        B2B_G(v0, v5, v10, v15, m[s8], m[s9]);             \
        B2B_G(v1, v6, v11, v12, m[s10], m[s11]);           \
        B2B_G(v2, v7, v8, v13, m[s12], m[s13]);            \
        B2B_G(v3, v4, v9, v14, m[s14], m[s15]);            \
    } while (0)

// One final-block compression of the 16-word message m with byte count t;
// writes the 8 digest words to out.
__device__ __forceinline__ void compress_final(const uint64_t m[16], uint64_t t,
                                               uint64_t out[8]) {
    uint64_t v0 = B2B_H0, v1 = B2B_IV1, v2 = B2B_IV2, v3 = B2B_IV3;
    uint64_t v4 = B2B_IV4, v5 = B2B_IV5, v6 = B2B_IV6, v7 = B2B_IV7;
    uint64_t v8 = B2B_IV0, v9 = B2B_IV1, v10 = B2B_IV2, v11 = B2B_IV3;
    uint64_t v12 = B2B_IV4 ^ t, v13 = B2B_IV5, v14 = ~B2B_IV6, v15 = B2B_IV7;

    B2B_ROUND(0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15);
    B2B_ROUND(14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3);
    B2B_ROUND(11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4);
    B2B_ROUND(7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8);
    B2B_ROUND(9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13);
    B2B_ROUND(2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9);
    B2B_ROUND(12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11);
    B2B_ROUND(13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10);
    B2B_ROUND(6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5);
    B2B_ROUND(10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0);
    B2B_ROUND(0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15);
    B2B_ROUND(14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3);

    out[0] = B2B_H0 ^ v0 ^ v8;
    out[1] = B2B_IV1 ^ v1 ^ v9;
    out[2] = B2B_IV2 ^ v2 ^ v10;
    out[3] = B2B_IV3 ^ v3 ^ v11;
    out[4] = B2B_IV4 ^ v4 ^ v12;
    out[5] = B2B_IV5 ^ v5 ^ v13;
    out[6] = B2B_IV6 ^ v6 ^ v14;
    out[7] = B2B_IV7 ^ v7 ^ v15;
}

// Decimal string of a canonical element (4 words of 32 bits, < 2^128),
// left-aligned into message words m[0..4], little-endian bytes; returns the
// digit count (1 for the value 0).
__device__ __forceinline__ int decimal_message(zk::Fe v, uint64_t m[16]) {
    // five base-10^9 groups (10^45 > 2^128), least significant first
    uint32_t groups[5];
#pragma unroll
    for (int g = 0; g < 5; ++g) {
        uint64_t rem = 0;
#pragma unroll
        for (int k = 3; k >= 0; --k) {
            const uint64_t cur = (rem << 32) | v.w[k];
            v.w[k] = (uint32_t)(cur / 1000000000ULL);
            rem = cur % 1000000000ULL;
        }
        groups[g] = (uint32_t)rem;
    }
    uint8_t digits[45];  // least significant first
    int len = 1;
#pragma unroll
    for (int g = 0; g < 5; ++g) {
        uint32_t x = groups[g];
#pragma unroll
        for (int q = 0; q < 9; ++q) {
            const int idx = 9 * g + q;
            digits[idx] = (uint8_t)(x % 10u);
            x /= 10u;
            if (digits[idx] != 0) len = idx + 1;
        }
    }
#pragma unroll
    for (int w = 0; w < 16; ++w) m[w] = 0;
    for (int j = 0; j < len; ++j) {
        const uint64_t byte = (uint64_t)('0' + digits[len - 1 - j]);
        m[j >> 3] |= byte << (8 * (j & 7));
    }
    return len;
}

}  // namespace

// canon: [n, 8] int64 limbs (canonical, not Montgomery); out: [n, 64] bytes.
extern "C" __global__ void leaf_kernel(const int64_t* __restrict__ canon,
                                       uint8_t* __restrict__ out, int n) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    uint64_t m[16];
    const int len = decimal_message(zk::load_fe(canon + 8 * (size_t)i), m);
    uint64_t h[8];
    compress_final(m, (uint64_t)len, h);
    uint64_t* o = reinterpret_cast<uint64_t*>(out + 64 * (size_t)i);
#pragma unroll
    for (int k = 0; k < 8; ++k) o[k] = h[k];
}

// level: [2m, 64] bytes in natural order; out: [m, 64] bytes.
extern "C" __global__ void node_kernel(const uint8_t* __restrict__ level,
                                       uint8_t* __restrict__ out, int m_parents) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= m_parents) return;
    const uint64_t* in = reinterpret_cast<const uint64_t*>(level + 128 * (size_t)i);
    uint64_t m[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) m[k] = in[k];
    uint64_t h[8];
    compress_final(m, 128ULL, h);
    uint64_t* o = reinterpret_cast<uint64_t*>(out + 64 * (size_t)i);
#pragma unroll
    for (int k = 0; k < 8; ++k) o[k] = h[k];
}

// mh, ml: [16, n] hi and lo halves of the message words; t: [n] byte
// counts; oh, ol: [8, n] hi and lo halves of the digest words.
extern "C" __global__ void compress_kernel(const int64_t* __restrict__ mh,
                                           const int64_t* __restrict__ ml,
                                           const int64_t* __restrict__ t,
                                           int64_t* __restrict__ oh,
                                           int64_t* __restrict__ ol, int n) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    uint64_t m[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) {
        const size_t at = (size_t)k * n + i;
        m[k] = ((uint64_t)(uint32_t)mh[at] << 32) | (uint32_t)ml[at];
    }
    uint64_t h[8];
    compress_final(m, (uint64_t)t[i], h);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
        const size_t at = (size_t)k * n + i;
        oh[at] = (int64_t)(h[k] >> 32);
        ol[at] = (int64_t)(h[k] & 0xFFFFFFFFull);
    }
}

#ifdef __CUDACC__
#include <cuda_runtime.h>

extern "C" int compress_launch(const void* mh, const void* ml, const void* t, void* oh,
                               void* ol, int n, void* stream) {
    const int threads = 128;
    compress_kernel<<<(n + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
        (const int64_t*)mh, (const int64_t*)ml, (const int64_t*)t, (int64_t*)oh,
        (int64_t*)ol, n);
    return (int)cudaGetLastError();
}

extern "C" int leaf_launch(const void* canon, void* out, int n, void* stream) {
    const int threads = 128;
    leaf_kernel<<<(n + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
        (const int64_t*)canon, (uint8_t*)out, n);
    return (int)cudaGetLastError();
}

extern "C" int node_launch(const void* level, void* out, int m_parents, void* stream) {
    const int threads = 128;
    node_kernel<<<(m_parents + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)level, (uint8_t*)out, m_parents);
    return (int)cudaGetLastError();
}
#endif
