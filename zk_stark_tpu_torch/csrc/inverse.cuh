// The inverse of one field element in Montgomery form, on one thread, two
// ways: Fermat's a^(p-2) by a fixed addition chain (inv_fermat, the
// counterpart of mont_inv_fermat, zk_stark_tpu/ops/limbs.py:366), and a
// binary extended Euclid (inv_binary).  Both return the canonical residue
// x^-1 * R (x * R in), and 0 for 0.
//
// Both are one thread's chain of dependent steps: the addition chain is
// 156 dependent products (~250 cycles each on the H100), the Euclid ~91
// data-dependent rounds of 32-bit word operations (at most 128) and two
// products.  On one thread of an H100 the chain took 17.7 us and the
// Euclid 8.8 us with its carries in C, 7.5 with PTX carry chains
// (tools/kernel_shape_probe.py root_inverse, which holds each against
// Python integers), so csrc/batch_inv.cu inverts its block's total with
// inv_binary.

#pragma once

#include <stdint.h>

#include "field.cuh"

namespace zk {

// x^(2^k) by k dependent squarings
__device__ __forceinline__ Fe square_n(Fe x, int k) {
#pragma unroll 1
    for (int i = 0; i < k; ++i) x = mont_mul(x, x);
    return x;
}

// x^(p-2) = x^-1 (and 0 for 0) by a fixed addition chain.  p - 2 =
// 406 * 2^119 + (2^119 - 1): the head 406 = 0b110010110 from x^3, then
// 17 runs of seven ones, each 7 squarings and one product by x^(2^7 - 1).
// 132 squarings and 24 products (the JAX package's 4-bit windows take 169).
__device__ __forceinline__ Fe inv_fermat(const Fe& x) {
    const Fe o2 = mont_mul(mont_mul(x, x), x);         // x^(2^2 - 1)
    const Fe o3 = mont_mul(square_n(o2, 1), x);        // x^(2^3 - 1)
    const Fe o6 = mont_mul(square_n(o3, 3), o3);       // x^(2^6 - 1)
    const Fe o7 = mont_mul(square_n(o6, 1), x);        // x^(2^7 - 1)
    Fe acc = mont_mul(square_n(o2, 3), x);             // x^0b11001
    acc = mont_mul(square_n(acc, 2), x);               // x^0b1100101
    acc = mont_mul(square_n(acc, 1), x);               // x^0b11001011
    acc = square_n(acc, 1);                            // x^406
#pragma unroll 1
    for (int run = 0; run < 17; ++run) acc = mont_mul(square_n(acc, 7), o7);
    return acc;
}

// trailing zeros of a nonzero word
__device__ __forceinline__ int ctz32(uint32_t x) {
#ifdef __CUDA_ARCH__
    return __ffs((int)x) - 1;
#else
    return __builtin_ctz(x);
#endif
}

// the low word of (hi:lo) >> z, 0 <= z < 32
__device__ __forceinline__ uint32_t shift_right2(uint32_t lo, uint32_t hi, int z) {
#ifdef __CUDA_ARCH__
    return __funnelshift_r(lo, hi, (uint32_t)z);
#else
    return z ? (lo >> z) | (hi << (32 - z)) : lo;
#endif
}

// the high word of (hi:lo) << z, 0 <= z < 32
__device__ __forceinline__ uint32_t shift_left2(uint32_t lo, uint32_t hi, int z) {
#ifdef __CUDA_ARCH__
    return __funnelshift_l(lo, hi, (uint32_t)z);
#else
    return z ? (hi << z) | (lo >> (32 - z)) : hi;
#endif
}

// a >>= its trailing zeros (a nonzero); returns their count
__device__ __forceinline__ int strip_zeros(Fe& a) {
    int z = 0;
    while (a.w[0] == 0) {  // a whole word of zeros: rare (2^-32 a round)
        a.w[0] = a.w[1];
        a.w[1] = a.w[2];
        a.w[2] = a.w[3];
        a.w[3] = 0;
        z += 32;
    }
    const int s = ctz32(a.w[0]);
    a.w[0] = shift_right2(a.w[0], a.w[1], s);
    a.w[1] = shift_right2(a.w[1], a.w[2], s);
    a.w[2] = shift_right2(a.w[2], a.w[3], s);
    a.w[3] >>= s;
    return z + s;
}

// (a, top) <<= z: a 160-bit value of 4 words and a top word
__device__ __forceinline__ void shift_left5(Fe& a, uint32_t& top, int z) {
    while (z >= 32) {
        top = a.w[3];
        a.w[3] = a.w[2];
        a.w[2] = a.w[1];
        a.w[1] = a.w[0];
        a.w[0] = 0;
        z -= 32;
    }
    top = shift_left2(a.w[3], top, z);
    a.w[3] = shift_left2(a.w[2], a.w[3], z);
    a.w[2] = shift_left2(a.w[1], a.w[2], z);
    a.w[1] = shift_left2(a.w[0], a.w[1], z);
    a.w[0] <<= z;
}

// r = a - b over 4 words; nonzero on a borrow.  On the card one carry
// chain whose borrow leaves as a mask (field.cuh: no addition reads a
// subtraction's flag); 15 % faster an inversion than the C form
// (tools/kernel_shape_probe.py root_inverse)
__device__ __forceinline__ uint32_t sub4_borrow(Fe& r, const Fe& a, const Fe& b) {
#ifdef __CUDA_ARCH__
    uint32_t m;
    asm("sub.cc.u32 %0, %5, %9;\n\t"
        "subc.cc.u32 %1, %6, %10;\n\t"
        "subc.cc.u32 %2, %7, %11;\n\t"
        "subc.cc.u32 %3, %8, %12;\n\t"
        "subc.u32 %4, 0, 0;"
        : "=r"(r.w[0]), "=r"(r.w[1]), "=r"(r.w[2]), "=r"(r.w[3]), "=r"(m)
        : "r"(a.w[0]), "r"(a.w[1]), "r"(a.w[2]), "r"(a.w[3]),
          "r"(b.w[0]), "r"(b.w[1]), "r"(b.w[2]), "r"(b.w[3]));
    return m;
#else
    return sub4(r, a, b);
#endif
}

// (r, r4) += (s, s4): 160-bit values of 4 words and a top word
__device__ __forceinline__ void add5(Fe& r, uint32_t& r4, const Fe& s, uint32_t s4) {
#ifdef __CUDA_ARCH__
    asm("add.cc.u32 %0, %0, %5;\n\t"
        "addc.cc.u32 %1, %1, %6;\n\t"
        "addc.cc.u32 %2, %2, %7;\n\t"
        "addc.cc.u32 %3, %3, %8;\n\t"
        "addc.u32 %4, %4, %9;"
        : "+r"(r.w[0]), "+r"(r.w[1]), "+r"(r.w[2]), "+r"(r.w[3]), "+r"(r4)
        : "r"(s.w[0]), "r"(s.w[1]), "r"(s.w[2]), "r"(s.w[3]), "r"(s4));
#else
    r4 += s4 + add4(r, r, s);
#endif
}

// R^2 mod p, as Montgomery form of R
__device__ __forceinline__ Fe r2_fe() {
    return Fe{{0x0E778236u, 0x5BD53A7Fu, 0x1A6AEDC2u, 0xAAF4AD9Au}};
}

// the end of inv_binary's rounds: r (< 2p, its top word r4) with p - (r
// mod p) = x^-1 * 2^k mod p, 128 <= k <= 256 -> x^-1 * R^2 mod p
__device__ __forceinline__ Fe inverse_from_rounds(Fe r, uint32_t r4, int k) {
    Fe d;
    const uint32_t borrow = sub4_borrow(d, r, p_fe());
    if (r4 || !borrow) r = d;
    sub4_borrow(r, p_fe(), r);
    const int t = 256 - k;  // 0 <= t <= 128
    Fe pow2{{0u, 0u, 0u, 0u}};
    if (t == 128) {
        pow2 = Fe{{0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0x347FFFFFu}};  // R mod p
    } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) pow2.w[j] = (t >> 5) == j ? 1u << (t & 31) : 0u;
    }
    return mont_mul(mont_mul(r, r2_fe()), pow2);
}

// x^-1 * R^2 mod p for x in [0, p) (0 for 0): the Montgomery form of the
// inverse of the element x stands for.  Kaliski's almost Montgomery inverse
// (IEEE Trans. Computers 44(8), 1995), its halvings taken in runs:
//
//   u = p, v = x, r = 0, s = 1, k = 0; strip v's trailing zeros (k += them)
//   while v != 0 (u and v odd):
//     u > v:  u -= v, r += s, then u >>= z, s <<= z, k += z (z = u's zeros)
//     else:   v -= u, s += r, then v >>= z, r <<= z, k += z (z = 1 if v = 0)
//   r = p - (r mod p)  =  x^-1 * 2^k mod p, 128 <= k <= 256
//
// the same states as the algorithm's one halving a round.  A round
// branches on the comparison: one path of selects through both cases took
// 1.5x as long (tools/kernel_shape_probe.py root_inverse).  r and s stay
// below 2p < 2^129, so they carry a fifth word.  Then two fixed products:
// mont_mul(mont_mul(r, R^2), 2^(256-k)) = x^-1 * 2^(k + 256 + 256 - k -
// 256) = x^-1 * R^2 (2^128 as R mod p).  The rounds depend on x (~91 on
// random elements, 128 at most, for R mod p among others): a caller with a
// secret operand wants inv_fermat.
__device__ __forceinline__ Fe inv_binary(const Fe& x) {
    if ((x.w[0] | x.w[1] | x.w[2] | x.w[3]) == 0) return x;
    Fe u = p_fe(), v = x;
    Fe r{{0u, 0u, 0u, 0u}}, s{{1u, 0u, 0u, 0u}};
    uint32_t r4 = 0, s4 = 0;
    int k = strip_zeros(v);
#pragma unroll 1
    for (;;) {
        Fe du, dv;
        sub4_borrow(du, u, v);
        if (sub4_borrow(dv, v, u)) {  // u > v
            u = du;
            add5(r, r4, s, s4);
            const int z = strip_zeros(u);
            shift_left5(s, s4, z);
            k += z;
        } else {
            v = dv;
            add5(s, s4, r, r4);
            if ((v.w[0] | v.w[1] | v.w[2] | v.w[3]) == 0) {  // u = v = 1
                shift_left5(r, r4, 1);
                k += 1;
                break;
            }
            const int z = strip_zeros(v);
            shift_left5(r, r4, z);
            k += z;
        }
    }
    return inverse_from_rounds(r, r4, k);
}

}  // namespace zk
