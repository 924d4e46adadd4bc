// GF(p) arithmetic for the kernels, p = 1 + 407 * 2^119, Montgomery R = 2^128.
//
// Device counterpart of mont_mul_planes, redc_planes, add_mod_planes and
// sub_mod_planes (zk_stark_tpu/ops/ntt_pallas.py:43-145).  The TPU kernels
// hold an element as 8 limbs of 16 bits because the VPU multiplies 32x32
// bits only into 32; Hopper multiplies 32x32 into 64, so an element here is
// 4 words of 32 bits and the product is a schoolbook product over those
// words with a reduction that uses p's shape (mont_mul).  The result is the
// canonical residue a*b*R^-1 mod p in [0, p) for both limb widths (same R,
// one conditional subtraction), so the kernels agree with the 16-bit tensor
// code bit for bit.
//
// At module boundaries an element is int64[8] holding 16-bit limbs;
// load_fe / store_fe repack.

#pragma once

#include <stddef.h>
#include <stdint.h>

namespace zk {

struct Fe {
    uint32_t w[4];
};

// word k of p, little-endian: p = 0xCB800000_00000000_00000000_00000001.
// A constexpr function rather than a table, so that in unrolled loops the
// multiplies by the zero words fold away.
__host__ __device__ __forceinline__ constexpr uint32_t kP(int k) {
    return k == 0 ? 1u : (k == 3 ? 0xCB800000u : 0u);
}

__device__ __forceinline__ Fe load_fe(const int64_t* limbs) {
    Fe r;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        r.w[k] = (uint32_t)limbs[2 * k] | ((uint32_t)limbs[2 * k + 1] << 16);
    }
    return r;
}

__device__ __forceinline__ void store_fe(int64_t* limbs, const Fe& a) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        limbs[2 * k] = (int64_t)(a.w[k] & 0xFFFFu);
        limbs[2 * k + 1] = (int64_t)(a.w[k] >> 16);
    }
}

// r = a + b, returns the carry out
__device__ __forceinline__ uint32_t add4(Fe& r, const Fe& a, const Fe& b) {
    uint64_t c = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        uint64_t s = (uint64_t)a.w[k] + b.w[k] + c;
        r.w[k] = (uint32_t)s;
        c = s >> 32;
    }
    return (uint32_t)c;
}

// r = a - b, returns the borrow out (0 or 1)
__device__ __forceinline__ uint32_t sub4(Fe& r, const Fe& a, const Fe& b) {
    uint64_t br = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        uint64_t d = (uint64_t)a.w[k] - b.w[k] - br;
        r.w[k] = (uint32_t)d;
        br = (d >> 32) & 1u;
    }
    return (uint32_t)br;
}

__device__ __forceinline__ Fe p_fe() {
    Fe p;
#pragma unroll
    for (int k = 0; k < 4; ++k) p.w[k] = kP(k);
    return p;
}

// a value v = (top, r) < 2p -> v mod p
__device__ __forceinline__ Fe reduce_once(const Fe& r, uint32_t top) {
    Fe d;
    uint32_t borrow = sub4(d, r, p_fe());
    return (top | (borrow ^ 1u)) ? d : r;
}

__device__ __forceinline__ Fe add_mod(const Fe& a, const Fe& b) {
    Fe s;
    uint32_t c = add4(s, a, b);
    return reduce_once(s, c);
}

__device__ __forceinline__ Fe sub_mod(const Fe& a, const Fe& b) {
    Fe d, dp;
    uint32_t borrow = sub4(d, a, b);
    add4(dp, d, p_fe());
    return borrow ? dp : d;
}

// kC = 407 * 2^23, p's top word: 407 * 2^119 = kC * 2^96, so p = 1 + kC * 2^96
static constexpr uint32_t kC = 0xCB800000u;

// Montgomery product a*b*R^-1 mod p, reduced through p's shape.
//
// (407 * 2^119)^2 == 0 mod R, so -p^-1 mod R = 407 * 2^119 - 1 and the
// whole 128-bit Montgomery quotient of T = a*b is
//     q = (xs * 2^96 - T) mod R,   xs = (T mod 2^32) * kC mod 2^32
// (xs = ((407 * T) mod 2^9) << 23).  Then q*p = q + kC*q*2^96, and
//     (T + q*p) / R = T_hi + eps + ((xs + kC*q) >> 32)
// with eps the borrow of the subtraction that made q (T + q = T_hi * R +
// xs * 2^96 + eps * R).  So the reduction is one 32-bit product (xs), a
// 128-bit subtraction (q) and a 128 x 32-bit product by kC with the adds
// of T_hi, in place of CIOS's four rounds.  The result is below 2p (129
// bits), and one conditional subtraction of p leaves the canonical
// residue: the same value as any other Montgomery product with R = 2^128.
//
// On the card the 4x4-word schoolbook product is PTX carry chains: each
// row's high halves and then its low halves of a[j]*b[i] are two chains of
// multiply-adds (madc.hi.cc / madc.lo.cc; the high chain starts the row's
// new top word, the low chain's last carry lands in it, so no carry is
// ever moved to a register on its own), 35 instructions for the 256-bit
// T, then 19 for the reduction and 10 for the subtraction: 64 in all
// (tools/measure.py mont_mul_ops counts them from this block).  The borrow
// eps leaves its subtraction chain as a mask (subc e, 0, 0) and joins the
// sum through hi(kC * q0) + eps, which cannot overflow (hi < kC): a carry
// flag set by a subtraction is never read by an addition.  The host
// compiler (the CPU tests) takes the #else branch: the same algorithm in
// C, word by word.
__device__ __forceinline__ Fe mont_mul(const Fe& a, const Fe& b) {
    Fe r;
#ifdef __CUDA_ARCH__
    // mont_mul PTX begin
    asm("{\n\t"
        ".reg .u32 t0, t1, t2, t3, t4, t5, t6, t7, xs, q0, q1, q2, q3, e, h0, u0, u1, u2, u3, u4, z;\n\t"
        ".reg .pred lt;\n\t"
        "mul.lo.u32 t0, %4, %8;\n\t"
        "mul.lo.u32 t1, %5, %8;\n\t"
        "mul.lo.u32 t2, %6, %8;\n\t"
        "mul.lo.u32 t3, %7, %8;\n\t"
        "mad.hi.cc.u32 t1, %4, %8, t1;\n\t"
        "madc.hi.cc.u32 t2, %5, %8, t2;\n\t"
        "madc.hi.cc.u32 t3, %6, %8, t3;\n\t"
        "madc.hi.u32 t4, %7, %8, 0;\n\t"
        "mad.hi.cc.u32 t2, %4, %9, t2;\n\t"
        "madc.hi.cc.u32 t3, %5, %9, t3;\n\t"
        "madc.hi.cc.u32 t4, %6, %9, t4;\n\t"
        "madc.hi.u32 t5, %7, %9, 0;\n\t"
        "mad.lo.cc.u32 t1, %4, %9, t1;\n\t"
        "madc.lo.cc.u32 t2, %5, %9, t2;\n\t"
        "madc.lo.cc.u32 t3, %6, %9, t3;\n\t"
        "madc.lo.cc.u32 t4, %7, %9, t4;\n\t"
        "addc.u32 t5, t5, 0;\n\t"
        "mad.hi.cc.u32 t3, %4, %10, t3;\n\t"
        "madc.hi.cc.u32 t4, %5, %10, t4;\n\t"
        "madc.hi.cc.u32 t5, %6, %10, t5;\n\t"
        "madc.hi.u32 t6, %7, %10, 0;\n\t"
        "mad.lo.cc.u32 t2, %4, %10, t2;\n\t"
        "madc.lo.cc.u32 t3, %5, %10, t3;\n\t"
        "madc.lo.cc.u32 t4, %6, %10, t4;\n\t"
        "madc.lo.cc.u32 t5, %7, %10, t5;\n\t"
        "addc.u32 t6, t6, 0;\n\t"
        "mad.hi.cc.u32 t4, %4, %11, t4;\n\t"
        "madc.hi.cc.u32 t5, %5, %11, t5;\n\t"
        "madc.hi.cc.u32 t6, %6, %11, t6;\n\t"
        "madc.hi.u32 t7, %7, %11, 0;\n\t"
        "mad.lo.cc.u32 t3, %4, %11, t3;\n\t"
        "madc.lo.cc.u32 t4, %5, %11, t4;\n\t"
        "madc.lo.cc.u32 t5, %6, %11, t5;\n\t"
        "madc.lo.cc.u32 t6, %7, %11, t6;\n\t"
        "addc.u32 t7, t7, 0;\n\t"
        "mul.lo.u32 xs, t0, 0xCB800000;\n\t"
        "sub.cc.u32 q0, 0, t0;\n\t"
        "subc.cc.u32 q1, 0, t1;\n\t"
        "subc.cc.u32 q2, 0, t2;\n\t"
        "subc.cc.u32 q3, xs, t3;\n\t"
        "subc.u32 e, 0, 0;\n\t"
        "mul.hi.u32 h0, q0, 0xCB800000;\n\t"
        "sub.u32 h0, h0, e;\n\t"
        "mad.lo.cc.u32 u0, q1, 0xCB800000, t4;\n\t"
        "madc.lo.cc.u32 u1, q2, 0xCB800000, t5;\n\t"
        "madc.lo.cc.u32 u2, q3, 0xCB800000, t6;\n\t"
        "addc.cc.u32 u3, t7, 0;\n\t"
        "addc.u32 u4, 0, 0;\n\t"
        "mad.lo.cc.u32 z, q0, 0xCB800000, xs;\n\t"
        "addc.cc.u32 u0, u0, h0;\n\t"
        "madc.hi.cc.u32 u1, q1, 0xCB800000, u1;\n\t"
        "madc.hi.cc.u32 u2, q2, 0xCB800000, u2;\n\t"
        "madc.hi.cc.u32 u3, q3, 0xCB800000, u3;\n\t"
        "addc.u32 u4, u4, 0;\n\t"
        "sub.cc.u32 %0, u0, 1;\n\t"
        "subc.cc.u32 %1, u1, 0;\n\t"
        "subc.cc.u32 %2, u2, 0;\n\t"
        "subc.cc.u32 %3, u3, 0xCB800000;\n\t"
        "subc.u32 u4, u4, 0;\n\t"
        "setp.ne.u32 lt, u4, 0;\n\t"
        "selp.u32 %0, u0, %0, lt;\n\t"
        "selp.u32 %1, u1, %1, lt;\n\t"
        "selp.u32 %2, u2, %2, lt;\n\t"
        "selp.u32 %3, u3, %3, lt;\n\t"
        "}"
        : "=r"(r.w[0]), "=r"(r.w[1]), "=r"(r.w[2]), "=r"(r.w[3])
        : "r"(a.w[0]), "r"(a.w[1]), "r"(a.w[2]), "r"(a.w[3]),
          "r"(b.w[0]), "r"(b.w[1]), "r"(b.w[2]), "r"(b.w[3]));
    // mont_mul PTX end
#else
    // T = a*b, row by row
    uint32_t t[8] = {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
    for (int i = 0; i < 4; ++i) {
        uint64_t c = 0;
        for (int j = 0; j < 4; ++j) {
            const uint64_t s = (uint64_t)a.w[j] * b.w[i] + t[i + j] + c;
            t[i + j] = (uint32_t)s;
            c = s >> 32;
        }
        t[i + 4] = (uint32_t)c;
    }
    // q = xs * 2^96 - T_lo mod R, eps its borrow
    const uint32_t xs = t[0] * kC;
    uint32_t q[4];
    uint64_t br = 0;
    for (int k = 0; k < 4; ++k) {
        const uint64_t d = (uint64_t)(k == 3 ? xs : 0u) - t[k] - br;
        q[k] = (uint32_t)d;
        br = (d >> 32) & 1u;
    }
    // u = T_hi + eps + ((xs + kC * q) >> 32): 5 words
    uint64_t lo = (uint64_t)q[0] * kC + xs;  // its low word is 0
    uint64_t c = (lo >> 32) + br;
    uint32_t u[5];
    for (int k = 0; k < 4; ++k) {
        const uint64_t next = k < 3 ? (uint64_t)q[k + 1] * kC : 0u;
        const uint64_t s = (uint64_t)t[4 + k] + (uint32_t)next + c;
        u[k] = (uint32_t)s;
        c = (s >> 32) + (next >> 32);
    }
    u[4] = (uint32_t)c;
    for (int k = 0; k < 4; ++k) r.w[k] = u[k];
    r = reduce_once(r, u[4]);
#endif
    return r;
}

// a*R^-1 mod p: Montgomery form -> canonical
__device__ __forceinline__ Fe redc(const Fe& a) {
    Fe one;
    one.w[0] = 1u;
    one.w[1] = one.w[2] = one.w[3] = 0u;
    return mont_mul(a, one);
}

}  // namespace zk
