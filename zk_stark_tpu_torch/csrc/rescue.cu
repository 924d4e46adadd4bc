// The batched Rescue-XLIX permutation: every round of every state in one
// launch.
//
// Replaces: _permutation_kernel (zk_stark_tpu/ops/rescue_ops.py:163), the
// XLA kernel that the JAX package tuned for the TPU (limb planes
// [8, m*rows, 128], batches padded to 128 lanes), with its column twin
// _permutation_kernel_cols (:101) that runs on XLA-CPU.  Both compute, per
// round r: x^alpha, the MDS product, + c[2rm .. 2rm+m), x^alpha_inv (a
// fixed-window chain), the MDS product, + c[2rm+m .. 2rm+2m).
//
// Here one thread owns one state: its m = 2 registers stay in registers as
// 4 words of 32 bits for all rounds, and device memory sees each state once
// in and once out.  At block start the threads stage the MDS matrix and the
// 2*N*m round constants (1.8 KB at N = 27) into shared memory, where every
// thread reads the same address (a broadcast).  alpha and alpha_inv are
// runtime arguments (128-bit words and a bit count): alpha by
// square-and-multiply over its bits, alpha_inv by 4-bit windows read
// straight from its words (a window never straddles a word), most
// significant first.  The window table a^1..a^15 of both registers is
// indexed by a runtime digit, so it lives in shared memory (a register
// array indexed at runtime would go to local memory): [m][15][4 words]
// [blockDim] words, the threads of a warp on neighbouring words, 480 B a
// thread.  Exponents of at most 8 bits skip the table, as
// limbs.mont_pow_windowed does.
//
// Bound: operations.  A hash of the default instance is 27 rounds of
// 2*2 (x^3) + 2*169 (x^alpha_inv) + 2*4 (MDS) = 9,450 dependent Montgomery
// products for 64 bytes in and 64 out (int64 limbs of 2 registers).  Each
// thread runs two independent product chains (the registers), so a warp
// has little instruction-level parallelism of its own and the SM needs many
// warps in flight: 64 threads a block and 32 KB of shared memory a block
// (6 blocks, 12 warps an SM) at the default instance.

#include <stdint.h>

#include "field.cuh"

using zk::Fe;

// the number of registers (the state width m) the kernel is built for
constexpr int kM = 2;
// window width of the inverse S-box and its table entries a^1..a^15
constexpr int kWindow = 4;
constexpr int kTable = (1 << kWindow) - 1;
// exponents of at most this many bits go by square-and-multiply
constexpr int kPowUnrollBits = 8;

// an exponent < 2^128: little-endian words and its bit length
struct Exp {
    uint32_t w[4];
    int bits;
};

namespace {

__device__ __forceinline__ uint32_t exp_bit(const Exp& e, int b) {
    return (e.w[b >> 5] >> (b & 31)) & 1u;
}

// digit q (from the least significant) of 4 bits
__device__ __forceinline__ uint32_t exp_digit(const Exp& e, int q) {
    const int b = kWindow * q;
    return (e.w[b >> 5] >> (b & 31)) & ((1u << kWindow) - 1u);
}

// R mod p = 2^128 - p: Montgomery one
__device__ __forceinline__ Fe mont_one() {
    Fe r;
    r.w[0] = r.w[1] = r.w[2] = 0xFFFFFFFFu;
    r.w[3] = 0x347FFFFFu;
    return r;
}

// x^e, square-and-multiply, most significant bit first
__device__ __forceinline__ Fe pow_sqm(const Fe& x, const Exp& e) {
    if (e.bits == 0) return mont_one();
    Fe acc = x;
    for (int b = e.bits - 2; b >= 0; --b) {
        acc = zk::mont_mul(acc, acc);
        if (exp_bit(e, b)) acc = zk::mont_mul(acc, x);
    }
    return acc;
}

// word w of table entry a^(k+1) of register j, this thread's slot
__device__ __forceinline__ uint32_t& tab_word(uint32_t* tab, int j, int k, int w) {
    return tab[((j * kTable + k) * 4 + w) * blockDim.x + threadIdx.x];
}

__device__ __forceinline__ void tab_store(uint32_t* tab, int j, int k, const Fe& v) {
#pragma unroll
    for (int w = 0; w < 4; ++w) tab_word(tab, j, k, w) = v.w[w];
}

__device__ __forceinline__ Fe tab_load(uint32_t* tab, int j, int k) {
    Fe v;
#pragma unroll
    for (int w = 0; w < 4; ++w) v.w[w] = tab_word(tab, j, k, w);
    return v;
}

// s[j] <- s[j]^e for every register, by 4-bit windows (e.bits > 8)
__device__ __forceinline__ void pow_window(Fe s[kM], const Exp& e, uint32_t* tab) {
    Fe t[kM];
#pragma unroll
    for (int j = 0; j < kM; ++j) {
        t[j] = s[j];
        tab_store(tab, j, 0, t[j]);
    }
    for (int k = 1; k < kTable; ++k) {
#pragma unroll
        for (int j = 0; j < kM; ++j) {
            t[j] = zk::mont_mul(t[j], s[j]);
            tab_store(tab, j, k, t[j]);
        }
    }
    const int ndig = (e.bits + kWindow - 1) / kWindow;
    const uint32_t d0 = exp_digit(e, ndig - 1);  // nonzero: the top bit is set
#pragma unroll
    for (int j = 0; j < kM; ++j) s[j] = tab_load(tab, j, (int)d0 - 1);
    for (int q = ndig - 2; q >= 0; --q) {
#pragma unroll
        for (int sq = 0; sq < kWindow; ++sq) {
#pragma unroll
            for (int j = 0; j < kM; ++j) s[j] = zk::mont_mul(s[j], s[j]);
        }
        const uint32_t d = exp_digit(e, q);
        if (d) {
#pragma unroll
            for (int j = 0; j < kM; ++j) s[j] = zk::mont_mul(s[j], tab_load(tab, j, (int)d - 1));
        }
    }
}

__device__ __forceinline__ Fe const_fe(const uint32_t* consts, int c) {
    Fe v;
#pragma unroll
    for (int w = 0; w < 4; ++w) v.w[w] = consts[4 * c + w];
    return v;
}

// s <- MDS s; the matrix is constants 0 .. m*m (row-major)
__device__ __forceinline__ void mds_mul(Fe s[kM], const uint32_t* consts) {
    Fe out[kM];
#pragma unroll
    for (int j = 0; j < kM; ++j) {
        out[j] = zk::mont_mul(const_fe(consts, j * kM), s[0]);
#pragma unroll
        for (int i = 1; i < kM; ++i) {
            out[j] = zk::add_mod(out[j], zk::mont_mul(const_fe(consts, j * kM + i), s[i]));
        }
    }
#pragma unroll
    for (int j = 0; j < kM; ++j) s[j] = out[j];
}

// s[j] += round constant c0 + j
__device__ __forceinline__ void add_constants(Fe s[kM], const uint32_t* consts, int c0) {
#pragma unroll
    for (int j = 0; j < kM; ++j) s[j] = zk::add_mod(s[j], const_fe(consts, kM * kM + c0 + j));
}

}  // namespace

// state, out: [n_states, m, 8] int64 limbs (Montgomery); mds: [m, m, 8];
// rc: [2 * n_rounds * m, 8] (at least).  Dynamic shared memory:
// 4 * (m*m + 2*n_rounds*m) + m * 15 * 4 * blockDim.x words.
extern "C" __global__ void rescue_kernel(
    const int64_t* __restrict__ state, int64_t* __restrict__ out,
    const int64_t* __restrict__ mds, const int64_t* __restrict__ rc,
    int n_states, int n_rounds, Exp alpha, Exp alpha_inv) {
    extern __shared__ uint32_t rescue_smem[];
    const int n_consts = kM * kM + 2 * n_rounds * kM;
    uint32_t* consts = rescue_smem;
    uint32_t* tab = rescue_smem + 4 * n_consts;
    for (int c = threadIdx.x; c < n_consts; c += blockDim.x) {
        const Fe v = zk::load_fe(c < kM * kM ? mds + 8 * c : rc + 8 * (c - kM * kM));
#pragma unroll
        for (int w = 0; w < 4; ++w) consts[4 * c + w] = v.w[w];
    }
    __syncthreads();

    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n_states) return;
    Fe s[kM];
#pragma unroll
    for (int j = 0; j < kM; ++j) s[j] = zk::load_fe(state + 8 * ((size_t)i * kM + j));

    for (int r = 0; r < n_rounds; ++r) {
#pragma unroll
        for (int j = 0; j < kM; ++j) s[j] = pow_sqm(s[j], alpha);
        mds_mul(s, consts);
        add_constants(s, consts, 2 * r * kM);
        if (alpha_inv.bits > kPowUnrollBits) {
            pow_window(s, alpha_inv, tab);
        } else {
#pragma unroll
            for (int j = 0; j < kM; ++j) s[j] = pow_sqm(s[j], alpha_inv);
        }
        mds_mul(s, consts);
        add_constants(s, consts, 2 * r * kM + kM);
    }
#pragma unroll
    for (int j = 0; j < kM; ++j) zk::store_fe(out + 8 * ((size_t)i * kM + j), s[j]);
}

#ifdef __CUDACC__
#include <cuda_runtime.h>

static Exp make_exp(const uint32_t* words, int bits) {
    Exp e;
    for (int k = 0; k < 4; ++k) e.w[k] = words[k];
    e.bits = bits;
    return e;
}

// m must be kM (the wrapper raises otherwise); alpha, alpha_inv: host
// arrays of 4 little-endian words.  Returns cudaGetLastError().
extern "C" int rescue_launch(const void* state, void* out, const void* mds,
                             const void* rc, int n_states, int m, int n_rounds,
                             const uint32_t* alpha, int alpha_bits,
                             const uint32_t* alpha_inv, int alpha_inv_bits,
                             void* stream) {
    if (m != kM) return (int)cudaErrorInvalidValue;
    const int threads = 64;
    const int smem = 4 * (int)sizeof(uint32_t) * (kM * kM + 2 * n_rounds * kM) +
                     kM * kTable * 4 * (int)sizeof(uint32_t) * threads;
    cudaError_t e = cudaFuncSetAttribute(
        rescue_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    rescue_kernel<<<(n_states + threads - 1) / threads, threads, smem, (cudaStream_t)stream>>>(
        (const int64_t*)state, (int64_t*)out, (const int64_t*)mds, (const int64_t*)rc,
        n_states, n_rounds, make_exp(alpha, alpha_bits), make_exp(alpha_inv, alpha_inv_bits));
    return (int)cudaGetLastError();
}
#endif
