// Whole radix-2 NTT of one transform in shared memory, with an optional
// four-step twiddle multiplied in before the store.
//
// Replaces: _ntt_stages_kernel (zk_stark_tpu/ops/ntt_pallas.py:180), launched
// by _ntt_planes_call (:311), in both its modes.  The TPU kernel runs the
// log2 n butterfly stages of bit-reversed rows held in VMEM, with limb planes
// [8, n, c] so that 128 transforms fill the vector lanes; with fuse_tw
// (:266-268) it multiplies each transform by the four-step tile
// root^(k1*i2) after the last stage.  The four-step glue around it
// (_four_step_pallas :408, ntt_mont_pallas :449) and the recursive split of
// long columns (_planes_long_ntt :369) are in ops/ntt.py.
//
// Here one thread block owns one transform of n <= 2^12 points: it loads the
// input bit-reversed into shared memory (16 bytes per element as 4 words of
// 32 bits: 64 KB at n = 4096, above the 48 KB default, hence the attribute
// set before the launch), runs all stages between __syncthreads(), and
// writes back in natural order.  The grid is three batch dimensions;
// element i of transform (bx, by, bz) lives at element offset
// bx*sx + by*sy + bz*sz + i*se of its tensor, for the input and the output
// separately.  So the four-step split (two launches) and the three-pass
// split beyond 2^24 points (three launches) read columns and write
// transposed rows straight from and to device memory, with no transpose
// pass between launches (an element is 64 contiguous bytes, two full
// 32-byte sectors, whatever the stride); the third grid index is the batch
// column where a transform is addressed by two indices of its own.  In the
// fused mode (ft != nullptr), element k of transform bx is multiplied by
// ft[bx * n + k] before the store: the four-step twiddle costs no pass of
// its own, nor does the inner twiddle of the three-pass split.

// Bound: each stage does n/2 Montgomery products (~16 32x32->64 multiplies
// plus carries each) and 2 modular add/sub on data that never leaves shared
// memory; device memory sees the input and output once (64 B each per
// element as int64 limbs) plus the 16-byte twiddles.  A four-step transform
// of 2^20 points moves 134 MB (input and output once), 0.040 ms at
// 3.35 TB/s, against ~1.2e9 integer instructions, 0.036 ms at the SM issue
// rate: bytes bound it, and the 1024 blocks of a pass fill every SM.  On an
// H100 80GB HBM3 at 700 W (chip_smoke.py) the two passes take 0.44 ms, ~10x
// the bound: each thread loads its strided elements one by one and a block
// holds one 16 KB transform.  At n <= 4096 with one transform a single block
// runs on 1 SM of 132, so the time is latency- and issue-bound on that SM.

#include <stdint.h>

#include "ntt_stages.cuh"

// element offsets of transform (bx, by, bz) and of element i within it
struct Strides {
    long long bx, by, bz, e;
};

// x, y: int64 limbs (Montgomery) laid out by the strides; tw: [n/2, 4]
// uint32 words of root^k (Montgomery), k < n/2, stage s using
// root^(j * n / 2^(s+1)); ft: nullptr, or [gridDim.x, n, 4] words.
extern "C" __global__ void ntt_stages_kernel(
    const int64_t* __restrict__ x, int64_t* __restrict__ y,
    const uint32_t* __restrict__ tw, const uint32_t* __restrict__ ft,
    int log2n, Strides in, Strides out) {
    extern __shared__ Fe4 sh[];
    const int n = 1 << log2n;
    const long long bx = blockIdx.x, by = blockIdx.y, bz = blockIdx.z;
    const int64_t* xb = x + 8 * (bx * in.bx + by * in.by + bz * in.bz);
    int64_t* yb = y + 8 * (bx * out.bx + by * out.by + bz * out.bz);

    for (int i = threadIdx.x; i < n; i += blockDim.x) {
        sh[bit_reverse((unsigned)i, log2n)] = to4(zk::load_fe(xb + 8 * (i * in.e)));
    }
    __syncthreads();
    stages_shared(sh, reinterpret_cast<const Fe4*>(tw), log2n, 0);

    const Fe4* ft4 = ft ? reinterpret_cast<const Fe4*>(ft) + bx * n : nullptr;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
        Fe v = from4(sh[i]);
        if (ft4) v = zk::mont_mul(v, from4(ft4[i]));
        zk::store_fe(yb + 8 * (i * out.e), v);
    }
}

#ifdef __CUDACC__
#include <cuda_runtime.h>

static int launch(const void* x, void* y, const void* tw, const void* ft,
                  int log2n, int gx, int gy, int gz, Strides in, Strides out,
                  void* stream) {
    const int n = 1 << log2n;
    const int smem = n * (int)sizeof(Fe4);
    cudaError_t e = cudaFuncSetAttribute(
        ntt_stages_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    const int threads = n / 2 < 256 ? n / 2 : 256;
    ntt_stages_kernel<<<dim3(gx, gy, gz), threads, smem, (cudaStream_t)stream>>>(
        (const int64_t*)x, (int64_t*)y, (const uint32_t*)tw,
        (const uint32_t*)ft, log2n, in, out);
    return (int)cudaGetLastError();
}

// Plain mode: gx * gy * gz transforms; returns cudaGetLastError().
extern "C" int ntt_launch(const void* x, void* y, const void* tw, int log2n,
                          int gx, int gy, int gz, long long in_bx, long long in_by,
                          long long in_bz, long long in_e, long long out_bx,
                          long long out_by, long long out_bz, long long out_e,
                          void* stream) {
    return launch(x, y, tw, nullptr, log2n, gx, gy, gz,
                  Strides{in_bx, in_by, in_bz, in_e},
                  Strides{out_bx, out_by, out_bz, out_e}, stream);
}

// Fused-twiddle mode (the first pass of a four-step split, and the second
// of the three-pass split): as ntt_launch, then element k of transform
// (bx, by, bz) times ft[bx, k].
extern "C" int ntt_tw_launch(const void* x, void* y, const void* tw,
                             const void* ft, int log2n, int gx, int gy, int gz,
                             long long in_bx, long long in_by, long long in_bz,
                             long long in_e, long long out_bx, long long out_by,
                             long long out_bz, long long out_e, void* stream) {
    return launch(x, y, tw, ft, log2n, gx, gy, gz,
                  Strides{in_bx, in_by, in_bz, in_e},
                  Strides{out_bx, out_by, out_bz, out_e}, stream);
}
#endif
