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
// card n (or n/2) independent compressions.  The compress interface
// carries every 32-bit half in an int64 (the JAX package's word planes in
// the port's limb dtype): 392 bytes a message, so bytes bound it where the
// leaf and node are bound by operations.
//
// The leaf (redesigned for the H100): a block of kLeafThreads elements
// comes into shared memory as one bulk copy and its digests leave as one
// (csrc/tiles.cuh), so device memory sees whole lines in both directions.
// A thread turns its element into the message in registers only: the
// base-10^8 groups by multiply-high with a reciprocal (10 steps of 64 by
// 32 bits, each starting at the highest word the value's size leaves
// nonzero, where a full long division takes 20), each group's 8 digits as 8
// ASCII bytes at fixed places (two 4-digit words, each a few multiplies),
// and the left alignment of the 40-byte string as a byte shift made of
// selects and funnel shifts.  The compression then knows at compile time
// that message words 5-15 are zero (a decimal string of a value below
// 2^128 has at most 39 bytes), so their additions fold away.
//
// The node (redesigned for the H100) hashes several levels of a tree in
// one launch, where the TPU kernel (one Mosaic call a level) took one: a
// block takes 2^k consecutive digests of one level and hashes k levels of
// their subtree, one barrier between levels, keeping them in shared memory
// and storing each level's share as one bulk copy (csrc/tiles.cuh).  A
// tree of 2^L leaves is ceil(L / 10) launches (ops/blake2b.py
// tree_launches), where one a level cost a launch and a compression's
// dependent chain (~5 us) at each of the narrow top levels.  What bounds a
// block is then its own narrow levels: one thread issues a compression's
// ~2,700 instructions at about one every two cycles (~2.6 us a level), so
// levels of at most a quarter as many parents as threads run four lanes a
// compression (compress_lanes: ~1.9 us a level).  A block keeps 48 KB of
// shared memory for 2^10 children (its first level is read from device
// memory, not staged) and at most 80 registers a thread, so that three
// blocks of 256 threads share an SM and one's narrow levels overlap
// another's wide ones (tools/kernel_shape_probe.py node_builds: 64
// registers spill, 128 leave two blocks an SM; both slower).

#include <stdint.h>

#include "field.cuh"
#include "tiles.cuh"

namespace node {

// threads a node block has at most, and blocks an SM at that width: at most
// 80 registers a thread, so that three blocks of 256 threads (24 warps)
// share an SM (the wrapper's NODE_THREADS is 256, two parents a thread on a
// full block's first level; one level alone runs blocks of 128)
constexpr int kMaxThreads = 256;
constexpr int kMinBlocks = 3;
// the most children a block takes: 2^11 (the wrapper asks for 2^10 at most)
constexpr int kMaxSpanLog2 = 11;

// a block's shared memory for 2^span_log2 children: its odd levels in
// region X (2^span_log2 / 2 digests), its even levels in region Y (a quarter)
__host__ __device__ inline int smem_bytes(int span_log2) {
    return (3 << span_log2) / 4 * tiles::kRecordBytes;
}

}  // namespace node

namespace {

// elements a leaf block hashes (one a thread): 64 spreads a sign's 4096
// leaves over 64 SMs
constexpr int kLeafThreads = 64;

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
        B2B_G(v0, v4, v8, v12, B2B_M(s0), B2B_M(s1));      \
        B2B_G(v1, v5, v9, v13, B2B_M(s2), B2B_M(s3));      \
        B2B_G(v2, v6, v10, v14, B2B_M(s4), B2B_M(s5));     \
        B2B_G(v3, v7, v11, v15, B2B_M(s6), B2B_M(s7));     \
        B2B_G(v0, v5, v10, v15, B2B_M(s8), B2B_M(s9));     \
        B2B_G(v1, v6, v11, v12, B2B_M(s10), B2B_M(s11));   \
        B2B_G(v2, v7, v8, v13, B2B_M(s12), B2B_M(s13));    \
        B2B_G(v3, v4, v9, v14, B2B_M(s14), B2B_M(s15));    \
    } while (0)

// message word i of a message whose words from kWords on are zero: a
// literal index, so the zero words fold into the additions
#define B2B_M(i) ((i) < kWords ? m[(i) < kWords ? (i) : 0] : 0ull)

// One final-block compression of the message m (words 0 .. kWords-1; the
// rest zero) with byte count t; writes the 8 digest words to out.
template <int kWords>
__device__ __forceinline__ void compress_final(const uint64_t (&m)[kWords], uint64_t t,
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

// the high half of a 64 x 64-bit product
__device__ __forceinline__ uint64_t umulhi64(uint64_t a, uint64_t b) {
#ifdef __CUDA_ARCH__
    return __umul64hi(a, b);
#else
    return (uint64_t)(((unsigned __int128)a * b) >> 64);
#endif
}

__device__ __forceinline__ uint32_t umulhi32(uint32_t a, uint32_t b) {
#ifdef __CUDA_ARCH__
    return __umulhi(a, b);
#else
    return (uint32_t)(((uint64_t)a * b) >> 32);
#endif
}

// bits 8b .. 8b+31 of hi:lo (b in 0..3)
__device__ __forceinline__ uint32_t funnel_bytes(uint32_t lo, uint32_t hi, int b) {
#ifdef __CUDA_ARCH__
    return __funnelshift_r(lo, hi, 8 * b);
#else
    return (uint32_t)((((uint64_t)hi << 32) | lo) >> (8 * b));
#endif
}

__device__ __forceinline__ int ctz64(uint64_t x) {
#ifdef __CUDA_ARCH__
    return __ffsll((long long)x) - 1;
#else
    return __builtin_ctzll(x);
#endif
}

// (rem * 2^32 + w) / 10^8 into w; returns the remainder (rem < 10^8).  The
// quotient is a multiply-high by ceil(2^90 / 10^8): exact for numerators
// below 2^90 / 10^8 > 2^63, and these are below 10^8 * 2^32 < 2^59.
__device__ __forceinline__ uint32_t div_1e8(uint32_t rem, uint32_t& w) {
    const uint64_t cur = ((uint64_t)rem << 32) | w;
    const uint32_t q = (uint32_t)(umulhi64(cur, 12379400392853802749ull) >> 26);
    w = q;
    return (uint32_t)cur - q * 100000000u;
}

// x < 10^4 -> its 4 decimal digits as bytes 0-9, most significant in byte 0
__device__ __forceinline__ uint32_t digits4(uint32_t x) {
    const uint32_t h = (x * 5243u) >> 19;                 // x / 100 (exact below 43,699)
    const uint32_t v = h | ((x - 100u * h) << 16);        // [x / 100, x % 100], 16-bit lanes
    const uint32_t t = ((v * 103u) >> 10) & 0x000F000Fu;  // each lane / 10 (exact below 179)
    return t | ((v - 10u * t) << 8);
}

// g < 10^8 -> its 8 decimal digits as bytes 0-9, most significant in byte 0
__device__ __forceinline__ uint64_t digits8(uint32_t g) {
    const uint32_t hi = umulhi32(g, 3518437209u) >> 13;  // g / 10^4
    return digits4(hi) | ((uint64_t)digits4(g - 10000u * hi) << 32);
}

// s[0..9] <- s[B..B+9] (zero past s[10]) where bit B of q is set
template <int B>
__device__ __forceinline__ void drop_words(uint32_t (&s)[11], int q) {
#pragma unroll
    for (int j = 0; j < 10; ++j) {
        const uint32_t up = j + B < 11 ? s[(j + B) % 11] : 0u;
        s[j] = (q & B) ? up : s[j];
    }
}

// Decimal string of a canonical element (4 words of 32 bits, < 2^128),
// left-aligned into message words m[0..4], little-endian bytes; returns the
// digit count (1 for the value 0).  Registers only: every array index is a
// literal once the loops unroll.
__device__ __forceinline__ int decimal_message(const zk::Fe& v, uint64_t (&m)[5]) {
    // base-10^8 groups, least significant first.  A value below 2^128 is
    // below 2^101.4 after one division by 10^8, 2^74.8 after two, 2^48.2
    // after three and 2^21.6 after four, so each division starts at the
    // highest word that can still be nonzero, with that word as remainder.
    uint32_t w0 = v.w[0], w1 = v.w[1], w2 = v.w[2], w3 = v.w[3];
    uint32_t g[5];
    uint32_t r = div_1e8(0, w3);
    r = div_1e8(r, w2);
    r = div_1e8(r, w1);
    g[0] = div_1e8(r, w0);  // w3 < 2^5.4 now
    r = div_1e8(w3, w2);
    r = div_1e8(r, w1);
    g[1] = div_1e8(r, w0);  // w2 < 2^10.8
    r = div_1e8(w2, w1);
    g[2] = div_1e8(r, w0);  // w1 < 2^16.2
    g[3] = div_1e8(w1, w0);
    g[4] = w0;  // < 2^21.6 < 10^8
    // the 40-byte zero-padded string: digit word j holds group 4 - j
    uint64_t d[5];
#pragma unroll
    for (int j = 0; j < 5; ++j) d[j] = digits8(g[4 - j]);
    // leading zero digits to drop: the first nonzero digit byte (39 for 0,
    // whose string is the last "0")
    int k = 39;
#pragma unroll
    for (int j = 4; j >= 0; --j) {
        if (d[j] != 0) k = 8 * j + (ctz64(d[j]) >> 3);
    }
    // the string as 10 words of 32 bits (and a zero word past its end),
    // shifted down by k bytes: whole words by a barrel of selects, then the
    // remaining bytes by funnel shifts
    uint32_t s[11];
#pragma unroll
    for (int j = 0; j < 5; ++j) {
        const uint64_t a = d[j] + 0x3030303030303030ull;
        s[2 * j] = (uint32_t)a;
        s[2 * j + 1] = (uint32_t)(a >> 32);
    }
    s[10] = 0;
    drop_words<8>(s, k >> 2);
    drop_words<4>(s, k >> 2);
    drop_words<2>(s, k >> 2);
    drop_words<1>(s, k >> 2);
#pragma unroll
    for (int j = 0; j < 5; ++j) {
        m[j] = funnel_bytes(s[2 * j], s[2 * j + 1], k & 3)
             | ((uint64_t)funnel_bytes(s[2 * j + 1], s[2 * j + 2], k & 3) << 32);
    }
    return 40 - k;
}

}  // namespace

// canon: [n, 8] int64 limbs (canonical, not Montgomery), 16-byte aligned;
// out: [n, 64] bytes.  A block hashes blockDim.x elements, one a thread:
// their limbs come in as one bulk copy, each digest goes back over its
// element's place in the tile, and the tile leaves as one bulk copy.
extern "C" __global__ void __launch_bounds__(kLeafThreads) leaf_kernel(
    const int64_t* __restrict__ canon, uint8_t* __restrict__ out, int n) {
    extern __shared__ longlong2 leaf_smem[];
    uint64_t* bar = reinterpret_cast<uint64_t*>(leaf_smem);
    int64_t* tile = reinterpret_cast<int64_t*>(leaf_smem + 1);
    const int e = threadIdx.x;
    const int base = blockIdx.x * blockDim.x;
    const int count = n - base < (int)blockDim.x ? n - base : (int)blockDim.x;
    const uint32_t bytes = (uint32_t)count * tiles::kRecordBytes;
    if (e == 0) tiles::bar_init(bar);
    __syncthreads();
    if (e == 0) {
        tiles::bar_expect(bar, bytes);
        tiles::load_async(tile, canon + 8 * (size_t)base, bytes, bar);
    }
    tiles::bar_wait(bar, 0);
    if (e < count) {
        const int rot = tiles::rotation(e);
        uint64_t m[5];
        const int len = decimal_message(tiles::load_fe<false>(tile + 8 * e, rot), m);
        uint64_t h[8];
        compress_final<5>(m, (uint64_t)len, h);
        tiles::store_words(tile + 8 * e, h, rot);
    }
    tiles::fence_async();
    __syncthreads();
    if (e == 0) {
        tiles::store_async(out + 64 * (size_t)base, tile, bytes);
        tiles::store_wait_all();
    }
}

// word A, B, C or D (literal indices) for lane q = 0, 1, 2 or 3 of a group
#define B2B_PICK(q, A, B, C, D) ((q) == 0 ? (A) : (q) == 1 ? (B) : (q) == 2 ? (C) : (D))

// one round of compress_lanes: the column step, rows b, c, d turned by 1,
// 2, 3 lanes, the diagonal step, and the rows turned back
#define B2B_ROUND4(s0, s1, s2, s3, s4, s5, s6, s7, s8, s9, s10, s11, s12, s13, s14, s15) \
    do {                                                                            \
        B2B_G(a, b, c, d, B2B_PICK(q, m[s0], m[s2], m[s4], m[s6]),                  \
              B2B_PICK(q, m[s1], m[s3], m[s5], m[s7]));                             \
        b = __shfl_sync(mask, b, q + 1, 4);                                         \
        c = __shfl_sync(mask, c, q + 2, 4);                                         \
        d = __shfl_sync(mask, d, q + 3, 4);                                         \
        B2B_G(a, b, c, d, B2B_PICK(q, m[s8], m[s10], m[s12], m[s14]),               \
              B2B_PICK(q, m[s9], m[s11], m[s13], m[s15]));                          \
        b = __shfl_sync(mask, b, q + 3, 4);                                         \
        c = __shfl_sync(mask, c, q + 2, 4);                                         \
        d = __shfl_sync(mask, d, q + 1, 4);                                         \
    } while (0)

// One final-block compression of the 128-byte message at msg (t = 128)
// over the 4 lanes q = 0..3 of a group, the SIMD form of BLAKE2b: lane q
// holds state words q, 4 + q, 8 + q and 12 + q and runs one of the four G
// mixes of each step, so the dependent chain is a quarter of
// compress_final's.  Each lane holds the whole message in registers and
// picks its words with selects that do not wait on the state.  Every lane
// of `mask` calls it; returns digest words q (lo) and 4 + q (hi).
__device__ __forceinline__ void compress_lanes(const longlong2* msg, int q, unsigned mask,
                                               uint64_t& lo, uint64_t& hi) {
    uint64_t m[16];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
        const longlong2 v = msg[k];
        m[2 * k] = (uint64_t)v.x;
        m[2 * k + 1] = (uint64_t)v.y;
    }
    const uint64_t iv_q = B2B_PICK(q, B2B_IV0, B2B_IV1, B2B_IV2, B2B_IV3);
    const uint64_t iv_4q = B2B_PICK(q, B2B_IV4, B2B_IV5, B2B_IV6, B2B_IV7);
    const uint64_t h_q = q == 0 ? B2B_H0 : iv_q;
    uint64_t a = h_q, b = iv_4q, c = iv_q;
    uint64_t d = iv_4q ^ (q == 0 ? 128ull : 0ull) ^ (q == 2 ? ~0ull : 0ull);

    B2B_ROUND4(0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15);
    B2B_ROUND4(14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3);
    B2B_ROUND4(11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4);
    B2B_ROUND4(7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8);
    B2B_ROUND4(9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13);
    B2B_ROUND4(2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9);
    B2B_ROUND4(12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11);
    B2B_ROUND4(13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10);
    B2B_ROUND4(6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5);
    B2B_ROUND4(10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0);
    B2B_ROUND4(0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15);
    B2B_ROUND4(14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3);

    lo = h_q ^ a ^ c;
    hi = iv_4q ^ b ^ d;
}

// in: [m, 64] digests of one level, natural order; out: the next `levels`
// levels one after another ([m / 2, 64], then [m / 4, 64], ...).  Block b
// takes children [b, b + 1) * 2^span_log2 of in (the last block fewer; a
// multiple of 2^levels in every block) and hashes its share of each level
// from the one below, with one barrier between levels: the first level
// from device memory (a thread's two children are 128 contiguous bytes),
// the others from shared memory, where the odd levels go to region X and
// the even ones to region Y (node::smem_bytes).  Each level's share leaves
// as one bulk store; before a level overwrites its region, the store that
// left from there two levels before has read it.  A level of at least a
// quarter as many parents as threads runs one thread a parent (its threads
// taking parents p, p + blockDim.x, ...); a narrower one four lanes a
// parent (compress_lanes), in the warps that hold a parent.
extern "C" __global__ void __launch_bounds__(node::kMaxThreads, node::kMinBlocks) node_kernel(
    const uint8_t* __restrict__ in, uint8_t* __restrict__ out, int m, int span_log2,
    int levels) {
    extern __shared__ longlong2 node_smem[];
    uint8_t* region_x = reinterpret_cast<uint8_t*>(node_smem);
    uint8_t* region_y = region_x + (1 << span_log2) / 2 * tiles::kRecordBytes;
    const int t = threadIdx.x;
    const int threads = blockDim.x;
    const int base = blockIdx.x << span_log2;
    const int count = m - base < (1 << span_log2) ? m - base : 1 << span_log2;

    const uint8_t* src = in + 64 * (int64_t)base;  // the level below, device memory first
    int64_t level_at = 0;  // digests of out before level j
    for (int j = 1; j <= levels; ++j) {
        uint8_t* dst = j & 1 ? region_x : region_y;
        const int parents = count >> j;
        if ((threads & 3) == 0 && 4 * parents <= threads) {
            if ((t & ~31) < 4 * parents) {  // a warp that holds a parent
                const int g = t >> 2, q = t & 3;
                const int lanes = threads - (t & ~31) < 32 ? threads - (t & ~31) : 32;
                const unsigned mask = lanes == 32 ? 0xFFFFFFFFu : (1u << lanes) - 1;
                const int p = g < parents ? g : parents - 1;  // spare groups hash a copy
                uint64_t lo, hi;
                compress_lanes(reinterpret_cast<const longlong2*>(src + 128 * p), q, mask, lo,
                               hi);
                if (g < parents) {
                    uint64_t* o = reinterpret_cast<uint64_t*>(dst + 64 * p);
                    o[q] = lo;
                    o[4 + q] = hi;
                }
            }
        } else {
            for (int p = t; p < parents; p += threads) {
                const longlong2* c = reinterpret_cast<const longlong2*>(src + 128 * p);
                uint64_t msg[16];
#pragma unroll
                for (int k = 0; k < 8; ++k) {
                    const longlong2 v = j == 1 ? tiles::chunk<true>(c + k) : c[k];
                    msg[2 * k] = (uint64_t)v.x;
                    msg[2 * k + 1] = (uint64_t)v.y;
                }
                uint64_t h[8];
                compress_final<16>(msg, 128ULL, h);
                tiles::store_words(dst + 64 * p, h, 0);
            }
        }
        tiles::fence_async();
        // the next level writes where the store of the level before this
        // one left from: that store must have read it
        if (t == 0) tiles::store_wait_read<0>();
        __syncthreads();
        if (t == 0 && parents) {
            tiles::store_async(out + 64 * (level_at + (base >> j)), dst,
                               (uint32_t)parents * tiles::kRecordBytes);
        }
        level_at += m >> j;
        src = dst;
    }
    // the block's shared memory may go once the stores have read it
    if (t == 0) tiles::store_wait_read<0>();
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
    compress_final<16>(m, (uint64_t)t[i], h);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
        const size_t at = (size_t)k * n + i;
        oh[at] = (int64_t)(h[k] >> 32);
        ol[at] = (int64_t)(h[k] & 0xFFFFFFFFull);
    }
}

#ifdef __CUDACC__
#include <cuda_runtime.h>

// the per-card state of the launchers is kept for kMaxDevices cards
constexpr int kMaxDevices = 16;

extern "C" int compress_launch(const void* mh, const void* ml, const void* t, void* oh,
                               void* ol, int n, void* stream) {
    const int threads = 128;
    compress_kernel<<<(n + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
        (const int64_t*)mh, (const int64_t*)ml, (const int64_t*)t, (int64_t*)oh,
        (int64_t*)ol, n);
    return (int)cudaGetLastError();
}

extern "C" int leaf_launch(const void* canon, void* out, int n, void* stream) {
    const int smem = (int)sizeof(longlong2) + kLeafThreads * tiles::kRecordBytes;
    leaf_kernel<<<(n + kLeafThreads - 1) / kLeafThreads, kLeafThreads, smem,
                  (cudaStream_t)stream>>>((const int64_t*)canon, (uint8_t*)out, n);
    return (int)cudaGetLastError();
}

// 0 < m < 2^31 children; 1 <= levels <= span_log2 <= node::kMaxSpanLog2;
// 1 <= threads <= node::kMaxThreads
extern "C" int node_launch(const void* in, void* out, int m, int span_log2, int levels,
                           int threads, void* stream) {
    static bool ready[kMaxDevices] = {};
    int dev = 0;
    cudaGetDevice(&dev);
    dev = dev < kMaxDevices ? dev : kMaxDevices - 1;
    if (!ready[dev]) {  // the first launch on this card: room for the largest span
        cudaFuncSetAttribute(node_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             node::smem_bytes(node::kMaxSpanLog2));
        ready[dev] = true;
    }
    const int blocks = (int)(((int64_t)m + (1 << span_log2) - 1) >> span_log2);
    node_kernel<<<blocks, threads, node::smem_bytes(span_log2), (cudaStream_t)stream>>>(
        (const uint8_t*)in, (uint8_t*)out, m, span_log2, levels);
    return (int)cudaGetLastError();
}
#endif
