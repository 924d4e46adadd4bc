// Three forms of the NTT stage kernel, for the stage-variant probe.
//
// Replaces: kernel_a (tools/ntt_variant_probe.py:50), kernel_b (:77) and
// kernel_c (:104), launched by make_call (:183) through pl.pallas_call
// (:221).  The TPU probe isolates the non-arithmetic cost of the stage
// kernel: all three run every DIT stage of c transforms whose rows arrive
// bit-reversed and write natural order, so they compute one function (the
// NTT of the un-permuted rows), and differ only in where the stage
// twiddles come from and in how the first three stages are done.  The same
// three questions, asked of this card's stage kernel (ntt.cu):
//
//   a  the twiddles of ntt.cu: one [n/2] table root^k read from device
//      memory at j << (log2n - 1 - s) in every stage;
//   b  a stage-major table of n - 1 words, stage s's 2^s twiddles
//      contiguous from offset 2^s - 1, copied into shared memory once per
//      block, so every stage reads its twiddles at unit stride from there;
//   c  a's twiddles, but each thread first takes 8 consecutive rows into
//      registers and runs the stages h = 1, 2, 4 there: no shared-memory
//      round trip and no barrier for those stages (the TPU's select form
//      within 8-row groups); the stages from h = 8 run as in a.
//
// Layout (the port's): x, y are [n, c, 8] int64 Montgomery limbs, element
// i of transform b at (i*c + b)*8; one block per transform, the transform
// in shared memory (n <= 4096: 64 KB, b's table another 64 KB).
//
// Bound: at the probe's n = c = 1024, 2^20 elements in and out at 64 B
// (134 MB, 0.040 ms at 3.35 TB/s) against 10 * 512 * 1024 butterflies
// (0.017 ms at the SM issue rate): bytes bound all three.  What the three
// times say is how much of ntt.cu's distance from that bound is twiddle
// reads (a against b) and how much the early stages' shared-memory round
// trips and barriers (a against c).

#include <stdint.h>

#include "ntt_stages.cuh"

__device__ __forceinline__ void load_rows(Fe4* sh, const int64_t* xb, int n, int c) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
        sh[i] = to4(zk::load_fe(xb + 8LL * i * c));
    }
}

__device__ __forceinline__ void store_rows(int64_t* yb, const Fe4* sh, int n, int c) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
        zk::store_fe(yb + 8LL * i * c, from4(sh[i]));
    }
}

// tw: [n/2, 4] words root^k
extern "C" __global__ void ntt_variant_a(const int64_t* __restrict__ x,
                                         int64_t* __restrict__ y,
                                         const uint32_t* __restrict__ tw,
                                         int log2n, int c) {
    extern __shared__ Fe4 sh[];
    const int n = 1 << log2n;
    load_rows(sh, x + 8LL * blockIdx.x, n, c);
    __syncthreads();
    stages_shared(sh, reinterpret_cast<const Fe4*>(tw), log2n, 0, 1, FlatLayout{});
    store_rows(y + 8LL * blockIdx.x, sh, n, c);
}

// tws: [n - 1, 4] words, stage s's twiddle j (root^(j * n / 2^(s+1)), j < 2^s)
// at 2^s - 1 + j
extern "C" __global__ void ntt_variant_b(const int64_t* __restrict__ x,
                                         int64_t* __restrict__ y,
                                         const uint32_t* __restrict__ tws,
                                         int log2n, int c) {
    extern __shared__ Fe4 sh[];
    const int n = 1 << log2n;
    Fe4* shtw = sh + n;
    const Fe4* tws4 = reinterpret_cast<const Fe4*>(tws);
    load_rows(sh, x + 8LL * blockIdx.x, n, c);
    for (int i = threadIdx.x; i < n - 1; i += blockDim.x) shtw[i] = tws4[i];
    __syncthreads();
    for (int s = 0; s < log2n; ++s) {
        const int h = 1 << s;
        for (int b = threadIdx.x; b < n / 2; b += blockDim.x) {
            const int j = b & (h - 1);
            const int i0 = ((b >> s) << (s + 1)) + j;
            const int i1 = i0 + h;
            const Fe e = from4(sh[i0]);
            const Fe t = zk::mont_mul(from4(sh[i1]), from4(shtw[h - 1 + j]));
            sh[i0] = to4(zk::add_mod(e, t));
            sh[i1] = to4(zk::sub_mod(e, t));
        }
        __syncthreads();
    }
    store_rows(y + 8LL * blockIdx.x, sh, n, c);
}

// tw as in a; n >= 8
extern "C" __global__ void ntt_variant_c(const int64_t* __restrict__ x,
                                         int64_t* __restrict__ y,
                                         const uint32_t* __restrict__ tw,
                                         int log2n, int c) {
    extern __shared__ Fe4 sh[];
    const int n = 1 << log2n;
    const int64_t* xb = x + 8LL * blockIdx.x;
    const Fe4* tw4 = reinterpret_cast<const Fe4*>(tw);
    for (int g = threadIdx.x; g < n / 8; g += blockDim.x) {
        Fe v[8];
#pragma unroll
        for (int r = 0; r < 8; ++r) v[r] = zk::load_fe(xb + 8LL * (8 * g + r) * c);
#pragma unroll
        for (int s = 0; s < 3; ++s) {
            const int h = 1 << s;
#pragma unroll
            for (int q = 0; q < 4; ++q) {  // the 4 butterflies of 8 rows
                const int j = q & (h - 1);
                const int i0 = ((q >> s) << (s + 1)) + j;
                const Fe e = v[i0];
                const Fe t = zk::mont_mul(v[i0 + h], from4(tw4[j << (log2n - 1 - s)]));
                v[i0] = zk::add_mod(e, t);
                v[i0 + h] = zk::sub_mod(e, t);
            }
        }
#pragma unroll
        for (int r = 0; r < 8; ++r) sh[8 * g + r] = to4(v[r]);
    }
    __syncthreads();
    stages_shared(sh, tw4, log2n, 3, 1, FlatLayout{});
    store_rows(y + 8LL * blockIdx.x, sh, n, c);
}

#ifdef __CUDACC__
#include <cuda_runtime.h>

typedef void (*VariantKernel)(const int64_t*, int64_t*, const uint32_t*, int, int);

static int launch(VariantKernel kernel, int smem_elements, const void* x, void* y,
                  const void* tw, int log2n, int c, void* stream) {
    const int n = 1 << log2n;
    const int smem = smem_elements * (int)sizeof(Fe4);
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    const int threads = n / 2 < 256 ? n / 2 : 256;
    kernel<<<c, threads, smem, (cudaStream_t)stream>>>(
        (const int64_t*)x, (int64_t*)y, (const uint32_t*)tw, log2n, c);
    return (int)cudaGetLastError();
}

// c transforms of 2^log2n points each; every entry point returns
// cudaGetLastError().
extern "C" int ntt_variant_a_launch(const void* x, void* y, const void* tw,
                                    int log2n, int c, void* stream) {
    return launch(ntt_variant_a, 1 << log2n, x, y, tw, log2n, c, stream);
}

extern "C" int ntt_variant_b_launch(const void* x, void* y, const void* tws,
                                    int log2n, int c, void* stream) {
    return launch(ntt_variant_b, 2 * (1 << log2n) - 1, x, y, tws, log2n, c, stream);
}

extern "C" int ntt_variant_c_launch(const void* x, void* y, const void* tw,
                                    int log2n, int c, void* stream) {
    return launch(ntt_variant_c, 1 << log2n, x, y, tw, log2n, c, stream);
}
#endif
