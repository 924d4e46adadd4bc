// The batched Rescue-XLIX permutation: every round of every state in one
// launch.
//
// Replaces: _permutation_kernel (zk_stark_tpu/ops/rescue_ops.py:163), the
// XLA kernel that the JAX package tuned for the TPU (limb planes
// [8, m*rows, 128], batches padded to 128 lanes), with its column twin
// _permutation_kernel_cols (:101) that runs on XLA-CPU.  Both compute, per
// round r: x^alpha, the MDS product, + c[2rm .. 2rm+m), x^alpha_inv, the
// MDS product, + c[2rm+m .. 2rm+2m).
//
// Here m neighbouring threads own one state, one register each, in
// registers as 4 words of 32 bits for all rounds; device memory sees each
// state once in and once out.  The state width m is a template parameter,
// instantiated for m = 2 .. kMaxM (the JAX kernel takes any m; rescue_launch
// refuses any other), and a block holds the largest multiple of m
// threads not above 128 (ops/rescue_ops.py launch_plan).  A thread runs its
// register's S-boxes alone: the product (field.cuh) is one block of
// carry-chained PTX, and the compiler does not interleave two of them in
// one thread, so a thread holding both registers ran their chains one
// after the other.  The MDS
// product needs every register of the state: each thread writes its
// register to shared memory, the block meets at a barrier, and each reads
// its neighbours' (two buffers in turn, so a write never meets a read of
// the exchange before).  At block start the threads stage the MDS matrix,
// the 2*N*m round constants (1.8 KB at N = 27 and m = 2, with the matrix
// 7.8 KB at m = 8) and both exponent chains into shared memory, where
// every thread reads the same address.
//
// Each S-box runs an exponent chain worked out on the host
// (ops/rescue_ops.py exponent_chain) and passed as a kernel argument: a
// short program of steps "acc <- (src) ; acc <- acc^(2^k) ; acc <- acc *
// slot[j] ; slot[i] <- acc", the same for every thread, with slot 0 = x.
// For the default instance's 128-bit alpha_inv it is a sliding window
// over the digits {85, 135, 171}: 156 products (the 4-bit fixed window of
// the plain version: 169), and 3 slots.  The slots are indexed at runtime,
// so they live in shared memory, word-planar ([slot][word][blockDim]
// words, the threads of a warp on neighbouring words): 64 B a thread, and
// 32 B for the exchange (the fixed window's table took 480 B a state).
//
// Bound: operations.  A hash of the default instance is 27 rounds of
// 2*2 (x^3) + 2*156 (x^alpha_inv) + 2*4 (MDS) = 8,748 Montgomery products
// (field.cuh: 64 instructions each) and 216 modular additions for 64
// bytes in and 64 out (int64 limbs of 2 registers); at width m, 27 rounds
// of m * (2 + 156) + 2 * m * m products.  At 256 or 2^14
// states the batch does not fill the card and the time is one thread's
// chain of products.

#include <stdint.h>

#include "field.cuh"

using zk::Fe;

// the widest state (registers, and so threads a state) instantiated
constexpr int kMaxM = 8;
// slots of an exponent chain, and its most steps (ops/rescue_ops.py
// KERNEL_SLOTS, KERNEL_MAX_STEPS)
constexpr int kSlots = 4;
constexpr int kMaxSteps = 96;
// a step's fields: bits 0-7 squarings, 8-11 source slot, 12-15 multiplier
// slot, 16-19 destination slot; kNone for none, kOne (source only) for the
// Montgomery one
constexpr uint32_t kNone = 0xF;
constexpr uint32_t kOne = 0xE;

// an exponent chain (ops/rescue_ops.py exponent_chain), passed by value and
// staged into shared memory at block start
struct Chain {
    int len;
    uint32_t step[kMaxSteps];
};

namespace {

// R mod p = 2^128 - p: Montgomery one
__device__ __forceinline__ Fe mont_one() {
    Fe r;
    r.w[0] = r.w[1] = r.w[2] = 0xFFFFFFFFu;
    r.w[3] = 0x347FFFFFu;
    return r;
}

// entry k (a slot, or an exchange buffer) of thread t in a word-planar table
__device__ __forceinline__ void planar_store(uint32_t* tab, int k, int t, const Fe& v) {
#pragma unroll
    for (int w = 0; w < 4; ++w) tab[(k * 4 + w) * blockDim.x + t] = v.w[w];
}

__device__ __forceinline__ Fe planar_load(const uint32_t* tab, int k, int t) {
    Fe v;
#pragma unroll
    for (int w = 0; w < 4; ++w) v.w[w] = tab[(k * 4 + w) * blockDim.x + t];
    return v;
}

// s <- s^e, e given by its chain's steps; the slots are this thread's
__device__ __forceinline__ Fe pow_chain(Fe s, const uint32_t* steps, int len, uint32_t* tab) {
    const int me = threadIdx.x;
    planar_store(tab, 0, me, s);
    for (int i = 0; i < len; ++i) {
        const uint32_t st = steps[i];
        const uint32_t src = (st >> 8) & 0xFu, mul = (st >> 12) & 0xFu, dst = (st >> 16) & 0xFu;
        if (src == kOne) {
            s = mont_one();
        } else if (src != kNone) {
            s = planar_load(tab, (int)src, me);
        }
        for (uint32_t q = st & 0xFFu; q > 0; --q) s = zk::mont_mul(s, s);
        if (mul != kNone) s = zk::mont_mul(s, planar_load(tab, (int)mul, me));
        if (dst != kNone) planar_store(tab, (int)dst, me, s);
    }
    return s;
}

__device__ __forceinline__ Fe const_fe(const uint32_t* consts, int c) {
    Fe v;
#pragma unroll
    for (int w = 0; w < 4; ++w) v.w[w] = consts[4 * c + w];
    return v;
}

// register j of MDS s, the state's registers exchanged through buffer
// `buf` of `xch` (a barrier between the write and the reads); the matrix
// is constants 0 .. M*M (row-major)
template <int M>
__device__ __forceinline__ Fe mds_row(const Fe& s, int j, const uint32_t* consts,
                                      uint32_t* xch, int buf) {
    planar_store(xch, buf, threadIdx.x, s);
    __syncthreads();
    const int first = threadIdx.x - j;  // the thread of the state's register 0
    Fe out = zk::mont_mul(const_fe(consts, j * M), planar_load(xch, buf, first));
#pragma unroll
    for (int i = 1; i < M; ++i) {
        out = zk::add_mod(out, zk::mont_mul(const_fe(consts, j * M + i),
                                            planar_load(xch, buf, first + i)));
    }
    return out;
}

}  // namespace

// state, out: [n_states, m, 8] int64 limbs (Montgomery); mds: [m, m, 8];
// rc: [2 * n_rounds * m, 8] (at least).  Thread t holds register t % m of
// state t / m; blockDim.x is a multiple of m.  Threads past the last state
// compute on the last state's registers and store nothing (every thread
// meets every barrier).  Dynamic shared memory: 4 * (m*m + 2*n_rounds*m)
// + 2 * kMaxSteps + (kSlots + 2) * 4 * blockDim.x words: the constants,
// both chains' steps, the slots and the exchange buffers.
template <int M>
__global__ void rescue_kernel(
    const int64_t* __restrict__ state, int64_t* __restrict__ out,
    const int64_t* __restrict__ mds, const int64_t* __restrict__ rc,
    int n_states, int n_rounds, Chain alpha, Chain alpha_inv) {
    extern __shared__ uint32_t rescue_smem[];
    const int n_consts = M * M + 2 * n_rounds * M;
    uint32_t* consts = rescue_smem;
    uint32_t* steps_a = rescue_smem + 4 * n_consts;
    uint32_t* steps_ai = steps_a + kMaxSteps;
    uint32_t* tab = steps_ai + kMaxSteps;
    uint32_t* xch = tab + kSlots * 4 * blockDim.x;
    for (int c = threadIdx.x; c < n_consts; c += blockDim.x) {
        const Fe v = zk::load_fe(c < M * M ? mds + 8 * c : rc + 8 * (c - M * M));
#pragma unroll
        for (int w = 0; w < 4; ++w) consts[4 * c + w] = v.w[w];
    }
    for (int i = threadIdx.x; i < alpha.len; i += blockDim.x) steps_a[i] = alpha.step[i];
    for (int i = threadIdx.x; i < alpha_inv.len; i += blockDim.x) steps_ai[i] = alpha_inv.step[i];
    __syncthreads();

    const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const int j = (int)(t % M);
    const long long i = t / M < n_states ? t / M : n_states - 1;
    Fe s = zk::load_fe(state + 8 * (i * M + j));
    int buf = 0;
    for (int r = 0; r < n_rounds; ++r) {
        s = pow_chain(s, steps_a, alpha.len, tab);
        s = mds_row<M>(s, j, consts, xch, buf);
        s = zk::add_mod(s, const_fe(consts, M * M + 2 * r * M + j));
        buf ^= 1;
        s = pow_chain(s, steps_ai, alpha_inv.len, tab);
        s = mds_row<M>(s, j, consts, xch, buf);
        s = zk::add_mod(s, const_fe(consts, M * M + 2 * r * M + M + j));
        buf ^= 1;
    }
    if (t / M < n_states) zk::store_fe(out + 8 * (i * M + j), s);
}

#ifdef __CUDACC__
#include <cuda_runtime.h>

static Chain make_chain(const uint32_t* steps, int len) {
    Chain c;
    c.len = len;
    for (int k = 0; k < len; ++k) c.step[k] = steps[k];
    return c;
}

template <int M>
static int launch(const void* state, void* out, const void* mds, const void* rc, int n_states,
                  int n_rounds, const Chain& alpha, const Chain& alpha_inv, int threads,
                  void* stream) {
    if (threads % M) return (int)cudaErrorInvalidValue;
    const int smem = (4 * (M * M + 2 * n_rounds * M) + 2 * kMaxSteps) * (int)sizeof(uint32_t) +
                     (kSlots + 2) * 4 * (int)sizeof(uint32_t) * threads;
    cudaError_t e = cudaFuncSetAttribute(
        rescue_kernel<M>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    const long long total = (long long)n_states * M;
    rescue_kernel<M><<<(int)((total + threads - 1) / threads), threads, smem,
                       (cudaStream_t)stream>>>(
        (const int64_t*)state, (int64_t*)out, (const int64_t*)mds, (const int64_t*)rc,
        n_states, n_rounds, alpha, alpha_inv);
    return (int)cudaGetLastError();
}

// m from 2 to kMaxM (the wrapper raises outside); alpha, alpha_inv: host
// arrays of chain steps (at most kMaxSteps each); threads a block, a
// multiple of m (the wrapper's launch_plan).  Returns cudaGetLastError().
extern "C" int rescue_launch(const void* state, void* out, const void* mds,
                             const void* rc, int n_states, int m, int n_rounds,
                             const uint32_t* alpha, int alpha_len,
                             const uint32_t* alpha_inv, int alpha_inv_len, int threads,
                             void* stream) {
    if (alpha_len > kMaxSteps || alpha_inv_len > kMaxSteps) return (int)cudaErrorInvalidValue;
    const Chain a = make_chain(alpha, alpha_len), ai = make_chain(alpha_inv, alpha_inv_len);
    switch (m) {
        case 2: return launch<2>(state, out, mds, rc, n_states, n_rounds, a, ai, threads, stream);
        case 3: return launch<3>(state, out, mds, rc, n_states, n_rounds, a, ai, threads, stream);
        case 4: return launch<4>(state, out, mds, rc, n_states, n_rounds, a, ai, threads, stream);
        case 5: return launch<5>(state, out, mds, rc, n_states, n_rounds, a, ai, threads, stream);
        case 6: return launch<6>(state, out, mds, rc, n_states, n_rounds, a, ai, threads, stream);
        case 7: return launch<7>(state, out, mds, rc, n_states, n_rounds, a, ai, threads, stream);
        case 8: return launch<8>(state, out, mds, rc, n_states, n_rounds, a, ai, threads, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}
#endif
