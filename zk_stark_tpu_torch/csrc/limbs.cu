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
// Bound: device memory.  A full-shape product reads 2 x 64 B and writes
// 64 B (128 B with one broadcast operand) against 64 integer instructions
// (field.cuh): at 3.35 TB/s, 192 B take 57 ps and 64 instructions 2 ps at
// the card's issue rate.  So the design is about moving bytes:
//
// * Persistent blocks of kThreads threads walk tiles of up to kTile
//   elements (kPerThread a thread), double-buffered in shared memory
//   (csrc/tiles.cuh): while a block computes one tile, the bulk copy
//   engine fetches its next one, and the finished tile leaves as one bulk
//   store.  Every operand that is the output's own shape and contiguous
//   comes so ("tiled"); the output is always contiguous, so every result
//   leaves so.
// * A single broadcast element ("single") is read once by each thread.
// * Any other operand ("general": strided, broadcast along some
//   dimensions, up to 4 of them) is read by its thread as 4 loads of 16
//   bytes an element, all of the thread's loads issued before its
//   arithmetic.  Its element offset comes from the sizes and element
//   strides of the collapsed leading dimensions (ops/limbs.py kernel_plan)
//   in 32-bit index arithmetic: a division by a dimension's size is a
//   multiply-high by the reciprocal kernel_plan computed (magic, shift),
//   never a 64-bit software division.
//
// Small calls (a sign's are 4096 elements) get smaller tiles, so that they
// spread over the SMs instead of filling 16 blocks.  The wrapper guarantees
// 16-byte alignment (it copies an operand that starts mid-element) and
// fewer than 2^31 elements.

#include <stdint.h>

#include "field.cuh"
#include "inverse.cuh"
#include "tiles.cuh"

namespace limbs {

enum Op { kMul, kAdd, kSub, kRedc };
// how an operand is read: its tiles by bulk copy; one element for every
// output element; or element by element through the index plan
enum Mode { kTiled, kSingle, kGeneral };

constexpr int kThreads = 128;
constexpr int kPerThread = 2;
constexpr int kTile = kThreads * kPerThread;
constexpr int kStages = 2;
// the stages' mbarriers, padded so that the tiles start 128-byte aligned
constexpr int kBarrierBytes = 128;
// the smallest tile a small call is cut into
constexpr int kMinTile = 32;

// one launch: sizes and element strides of 4 leading dimensions, the
// innermost last (a call of ndim dimensions uses the last ndim; the
// outermost takes what is left of the index), and for every dimension but
// the outermost the reciprocal of its size
struct Plan {
    int32_t n, ndim, tile, mode_a, mode_b;
    uint32_t size[4], magic[4], shift[4];
    int64_t sa[4], sb[4];
};

__host__ __device__ inline int mode(int ndim, const int64_t* s) {
    bool single = true;
    for (int d = 4 - ndim; d < 4; ++d) single = single && s[d] == 0;
    if (single) return kSingle;
    return ndim == 1 && s[3] == 8 ? kTiled : kGeneral;
}

// div[d] = magic | shift << 32 (ops/limbs.py divider)
__host__ __device__ inline Plan make_plan(int64_t n, int ndim, const int64_t* size,
                                          const int64_t* sa, const int64_t* sb,
                                          const int64_t* div, int tile) {
    Plan p;
    p.n = (int32_t)n;
    p.ndim = ndim;
    p.tile = tile;
    for (int d = 0; d < 4; ++d) {
        p.size[d] = (uint32_t)size[d];
        p.magic[d] = (uint32_t)(div[d] & 0xFFFFFFFF);
        p.shift[d] = (uint32_t)(div[d] >> 32);
        p.sa[d] = sa[d];
        p.sb[d] = sb[d];
    }
    p.mode_a = mode(ndim, sa);
    p.mode_b = mode(ndim, sb);
    return p;
}

// shared memory of a block: the mbarriers, then per stage the tiles of the
// tiled operands and of the output
__host__ __device__ inline int staged_arrays(const Plan& p, bool binary) {
    return 1 + (p.mode_a == kTiled) + (binary && p.mode_b == kTiled);
}

__host__ __device__ inline int smem_bytes(int tile, int arrays) {
    return kBarrierBytes + kStages * arrays * tile * tiles::kRecordBytes;
}

__device__ __forceinline__ uint32_t umulhi(uint32_t a, uint32_t b) {
#ifdef __CUDA_ARCH__
    return __umulhi(a, b);
#else
    return (uint32_t)(((uint64_t)a * b) >> 32);
#endif
}

// the element offsets in a and b of output element i (< 2^31)
__device__ __forceinline__ void offsets(uint32_t i, const Plan& p, int64_t& oa, int64_t& ob) {
    oa = 0;
    ob = 0;
#pragma unroll
    for (int d = 3; d > 0; --d) {
        if (d == 4 - p.ndim) break;  // the outermost dimension
        const uint32_t q = (umulhi(i, p.magic[d]) + i) >> p.shift[d];
        const uint32_t r = i - q * p.size[d];
        oa += (int64_t)r * p.sa[d];
        ob += (int64_t)r * p.sb[d];
        i = q;
    }
    oa += (int64_t)i * p.sa[4 - p.ndim];
    ob += (int64_t)i * p.sb[4 - p.ndim];
}

template <int OP>
__device__ __forceinline__ zk::Fe apply(const zk::Fe& x, const zk::Fe& y) {
    if constexpr (OP == kMul) return zk::mont_mul(x, y);
    if constexpr (OP == kAdd) return zk::add_mod(x, y);
    if constexpr (OP == kSub) return zk::sub_mod(x, y);
    return zk::redc(x);
}

template <int OP>
__device__ __forceinline__ void elementwise(const int64_t* __restrict__ a,
                                            const int64_t* __restrict__ b,
                                            int64_t* __restrict__ out, const Plan& p,
                                            unsigned char* smem) {
    constexpr bool kBinary = OP != kRedc;
    const int t = threadIdx.x;
    const int threads = blockDim.x;
    const bool tiled_a = p.mode_a == kTiled;
    const bool tiled_b = kBinary && p.mode_b == kTiled;
    const bool staged = tiled_a || tiled_b;
    const int arrays = 1 + tiled_a + tiled_b;
    const int ntiles = (p.n + p.tile - 1) / p.tile;
    const int tile_limbs = 8 * p.tile;
    uint64_t* full = reinterpret_cast<uint64_t*>(smem);  // one mbarrier a stage
    int64_t* stages = reinterpret_cast<int64_t*>(smem + kBarrierBytes);
    // stage s holds [a][b][out], each present array tile_limbs long
    auto array = [&](int s, int k) { return stages + (s * arrays + k) * tile_limbs; };

    zk::Fe single_a{}, single_b{};
    if (p.mode_a == kSingle) single_a = tiles::load_fe<true>(a, 0);
    if (kBinary && p.mode_b == kSingle) single_b = tiles::load_fe<true>(b, 0);

    // thread 0: the tiled operands of this block's i-th tile into stage s
    auto fetch = [&](int i, int s) {
        const int tile = blockIdx.x + i * gridDim.x;
        if (tile >= ntiles) return;
        const int base = tile * p.tile;
        const int count = p.n - base < p.tile ? p.n - base : p.tile;
        const uint32_t bytes = (uint32_t)count * tiles::kRecordBytes;
        tiles::bar_expect(full + s, bytes * (tiled_a + tiled_b));
        if (tiled_a) tiles::load_async(array(s, 0), a + 8 * (int64_t)base, bytes, full + s);
        if (tiled_b) tiles::load_async(array(s, tiled_a), b + 8 * (int64_t)base, bytes, full + s);
    };
    if (t == 0 && staged) {
        for (int s = 0; s < kStages; ++s) tiles::bar_init(full + s);
    }
    __syncthreads();
    if (t == 0 && staged) {
        for (int s = 0; s < kStages; ++s) fetch(s, s);
    }

    for (int i = 0;; ++i) {
        const int tile = blockIdx.x + i * gridDim.x;
        if (tile >= ntiles) break;
        const int s = i % kStages;
        const int base = tile * p.tile;
        const int count = p.n - base < p.tile ? p.n - base : p.tile;
        if (staged) tiles::bar_wait(full + s, (uint32_t)(i / kStages) & 1u);

        // every load of the thread's elements, then the arithmetic
        zk::Fe x[kPerThread], y[kPerThread] = {};
#pragma unroll
        for (int j = 0; j < kPerThread; ++j) {
            const int e = t + j * threads;
            if (e >= count) continue;
            const int rot = tiles::rotation(e);
            int64_t oa = 0, ob = 0;
            if (p.mode_a == kGeneral || (kBinary && p.mode_b == kGeneral))
                offsets((uint32_t)(base + e), p, oa, ob);
            x[j] = tiled_a ? tiles::load_fe<false>(array(s, 0) + 8 * e, rot)
                 : p.mode_a == kSingle ? single_a
                 : tiles::load_fe<true>(a + oa, 0);
            if (kBinary) {
                y[j] = tiled_b ? tiles::load_fe<false>(array(s, tiled_a) + 8 * e, rot)
                     : p.mode_b == kSingle ? single_b
                     : tiles::load_fe<true>(b + ob, 0);
            }
        }
        zk::Fe r[kPerThread];
#pragma unroll
        for (int j = 0; j < kPerThread; ++j) {
            if (t + j * threads < count) r[j] = apply<OP>(x[j], y[j]);
        }

        // the output tile of this stage is free once the store that left
        // from it kStages tiles ago has read it
        if (t == 0) tiles::store_wait_read<kStages - 1>();
        __syncthreads();  // stage s's operand tiles are read: refill them
        if (t == 0 && staged) fetch(i + kStages, s);
        int64_t* o = array(s, arrays - 1);
#pragma unroll
        for (int j = 0; j < kPerThread; ++j) {
            const int e = t + j * threads;
            if (e < count) tiles::store_fe(o + 8 * e, r[j], tiles::rotation(e));
        }
        tiles::fence_async();
        __syncthreads();
        if (t == 0) {
            tiles::store_async(out + 8 * (int64_t)base, o,
                               (uint32_t)count * tiles::kRecordBytes);
        }
    }
    if (t == 0) tiles::store_wait_all();
}

constexpr int kInvThreads = 128;

}  // namespace limbs

// out[i] = a[i]^(p-2) (Montgomery form in and out): the counterpart of
// mont_inv_fermat (zk_stark_tpu/ops/limbs.py:366, XLA-fused).  One thread
// an element, all in registers (inverse.cuh inv_fermat).  Bound: the
// chain's 156 dependent products (64 instructions each, field.cuh) against
// 128 bytes an element, so operations.  No path calls it: batch_inv has its
// own kernel (csrc/batch_inv.cu).
extern "C" __global__ void __launch_bounds__(limbs::kInvThreads)
    limbs_inv_kernel(const int64_t* __restrict__ a, int64_t* __restrict__ out, int64_t n) {
    const int64_t stride = (int64_t)blockDim.x * gridDim.x;
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
        const zk::Fe x = tiles::load_fe<true>(a + 8 * i, 0);
        tiles::store_fe(out + 8 * i, zk::inv_fermat(x), 0);
    }
}

// a, b: int64 limbs read as the plan says; out: [n, 8] contiguous.
// out = a * b * R^-1, a + b, a - b (mod p), or a * R^-1 (b unused).
#define LIMBS_KERNEL(NAME, OP)                                                          \
    extern "C" __global__ void __launch_bounds__(limbs::kThreads)                       \
        NAME(const int64_t* __restrict__ a, const int64_t* __restrict__ b,              \
             int64_t* __restrict__ out, limbs::Plan plan) {                             \
        extern __shared__ longlong2 limbs_smem[];                                       \
        limbs::elementwise<OP>(a, b, out, plan,                                         \
                               reinterpret_cast<unsigned char*>(limbs_smem));           \
    }
LIMBS_KERNEL(limbs_mont_mul_kernel, limbs::kMul)
LIMBS_KERNEL(limbs_add_mod_kernel, limbs::kAdd)
LIMBS_KERNEL(limbs_sub_mod_kernel, limbs::kSub)
LIMBS_KERNEL(limbs_redc_kernel, limbs::kRedc)
#undef LIMBS_KERNEL

#ifdef __CUDACC__
#include <cuda_runtime.h>

namespace {

// kMaxDevices cards at most: the per-card values below are kept by ordinal
constexpr int kMaxDevices = 16;

int device() {
    int dev = 0;
    cudaGetDevice(&dev);
    return dev < kMaxDevices ? dev : kMaxDevices - 1;
}

int sm_count() {
    static int sms[kMaxDevices] = {};
    const int dev = device();
    if (sms[dev] == 0) cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    return sms[dev];
}

// a tile of kTile elements, or for a call of fewer than kTile elements an
// SM a smaller one (a multiple of kMinTile): about one tile an SM
int tile_for(int64_t n) {
    const int64_t sms = sm_count();
    if (n >= (int64_t)limbs::kTile * sms) return limbs::kTile;
    int64_t t = (n + sms - 1) / sms;
    t = (t + limbs::kMinTile - 1) / limbs::kMinTile * limbs::kMinTile;
    return (int)(t < limbs::kTile ? t : limbs::kTile);
}

// the persistent grid: as many blocks as fit on the card at once (each
// kernel's occupancy at the full tile, by the number of staged arrays),
// never more than there are tiles
template <int OP>
int launch(void (*kernel)(const int64_t*, const int64_t*, int64_t*, limbs::Plan),
           const void* a, const void* b, void* out, int64_t n, int ndim, const int64_t* size,
           const int64_t* sa, const int64_t* sb, const int64_t* div, void* stream) {
    constexpr bool kBinary = OP != limbs::kRedc;
    static int occupancy[kMaxDevices][3] = {};
    int* per_sm = occupancy[device()];
    if (per_sm[0] == 0) {  // the first launch on this card
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             limbs::smem_bytes(limbs::kTile, 3));
        for (int k = 0; k < 3; ++k) {
            cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &per_sm[k], kernel, limbs::kThreads, limbs::smem_bytes(limbs::kTile, k + 1));
            if (per_sm[k] < 1) per_sm[k] = 1;
        }
    }
    const limbs::Plan p = limbs::make_plan(n, ndim, size, sa, sb, div, tile_for(n));
    const int arrays = limbs::staged_arrays(p, kBinary);
    const int64_t ntiles = (n + p.tile - 1) / p.tile;
    const int64_t cap = (int64_t)sm_count() * per_sm[arrays - 1];
    const int blocks = (int)(ntiles < cap ? ntiles : cap);
    kernel<<<blocks, limbs::kThreads, limbs::smem_bytes(p.tile, arrays), (cudaStream_t)stream>>>(
        (const int64_t*)a, (const int64_t*)b, (int64_t*)out, p);
    return (int)cudaGetLastError();
}

}  // namespace

// 0 < n < 2^31 elements (a grid of no blocks is an invalid launch: the
// wrapper returns before it); 1 <= ndim <= 4; s: sizes, a / b: element
// strides, d: reciprocals (magic | shift << 32) of 4 dimensions
#define LIMBS_BINARY_LAUNCH(NAME, KERNEL, OP)                                             \
    extern "C" int NAME(const void* a, const void* b, void* out, int64_t n, int ndim,     \
                        int64_t s0, int64_t s1, int64_t s2, int64_t s3, int64_t a0,       \
                        int64_t a1, int64_t a2, int64_t a3, int64_t b0, int64_t b1,       \
                        int64_t b2, int64_t b3, int64_t d0, int64_t d1, int64_t d2,       \
                        int64_t d3, void* stream) {                                       \
        const int64_t size[4] = {s0, s1, s2, s3}, sa[4] = {a0, a1, a2, a3};              \
        const int64_t sb[4] = {b0, b1, b2, b3}, div[4] = {d0, d1, d2, d3};               \
        return launch<OP>(KERNEL, a, b, out, n, ndim, size, sa, sb, div, stream);         \
    }
LIMBS_BINARY_LAUNCH(limbs_mont_mul_launch, limbs_mont_mul_kernel, limbs::kMul)
LIMBS_BINARY_LAUNCH(limbs_add_mod_launch, limbs_add_mod_kernel, limbs::kAdd)
LIMBS_BINARY_LAUNCH(limbs_sub_mod_launch, limbs_sub_mod_kernel, limbs::kSub)
#undef LIMBS_BINARY_LAUNCH

extern "C" int limbs_redc_launch(const void* a, void* out, int64_t n, int ndim, int64_t s0,
                                 int64_t s1, int64_t s2, int64_t s3, int64_t a0, int64_t a1,
                                 int64_t a2, int64_t a3, int64_t d0, int64_t d1, int64_t d2,
                                 int64_t d3, void* stream) {
    const int64_t size[4] = {s0, s1, s2, s3}, sa[4] = {a0, a1, a2, a3};
    const int64_t div[4] = {d0, d1, d2, d3};
    return launch<limbs::kRedc>(limbs_redc_kernel, a, a, out, n, ndim, size, sa, sa, div,
                                stream);
}

// a, out: [n, 8] contiguous and 16-byte aligned, 0 < n < 2^31
extern "C" int limbs_inv_launch(const void* a, void* out, int64_t n, void* stream) {
    const int64_t blocks = (n + limbs::kInvThreads - 1) / limbs::kInvThreads;
    const int64_t cap = (int64_t)sm_count() * (2048 / limbs::kInvThreads);
    limbs_inv_kernel<<<(int)(blocks < cap ? blocks : cap), limbs::kInvThreads, 0,
                       (cudaStream_t)stream>>>((const int64_t*)a, (int64_t*)out, n);
    return (int)cudaGetLastError();
}
#endif
