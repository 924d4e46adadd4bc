// Tiles of 64-byte records in shared memory, moved by the Hopper bulk copy
// engine: what csrc/limbs.cu, csrc/fold.cu and csrc/blake2b.cu's leaf and
// node kernels share.
//
// A record is one field element (8 int64 limbs of 16 bits) or one 64-byte
// digest: 4 chunks of 16 bytes.  One thread copies a whole tile of records
// between device and shared memory with cp.async.bulk (no registers, no
// address arithmetic per chunk; a load completes on an mbarrier, a store in
// a bulk group), so the device-memory traffic is whole 16-byte-aligned
// lines whatever the record's layout.  Each thread then reads its own
// record's 4 chunks from shared memory as 16-byte vectors.
//
// Banks: the 8 threads of one phase of a 16-byte shared-memory access read
// records 64 bytes apart, so chunk c of all 8 falls into two 16-byte bank
// groups (a 4-way conflict).  A thread therefore walks its record's chunks
// starting at chunk rot = (e >> 1) & 3 (e its record's index in the tile):
// the 8 threads then hit 8 different bank groups, and the words are put
// back in order with selects.
//
// The host compiler (the CPU tests) takes the #else branches: the copies
// are memcpy by the issuing thread and an mbarrier wait is __syncthreads(),
// so the tiling, the tails and the order of the barriers run on the CPU;
// only the card runs the asynchronous copies themselves.

#pragma once

#include <stdint.h>
#include <string.h>

#include "field.cuh"

namespace tiles {

constexpr int kRecordBytes = 64;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
#ifdef __CUDA_ARCH__
    return (uint32_t)__cvta_generic_to_shared(p);
#else
    (void)p;
    return 0;
#endif
}

// thread 0: an mbarrier that completes a phase on one arrival and its bytes
__device__ __forceinline__ void bar_init(uint64_t* bar) {
#ifdef __CUDA_ARCH__
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
#else
    *bar = 0;
#endif
}

// thread 0: this phase of bar completes when `bytes` have arrived
__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
#ifdef __CUDA_ARCH__
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
                 "r"(bytes)
                 : "memory");
#else
    (void)bar;
    (void)bytes;
#endif
}

// every thread: wait for the phase of bar with this parity (0 for its
// first phase, 1 for the second, ...).  On the host the copies are done
// already, and the wait is the barrier that publishes them.
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
#ifdef __CUDA_ARCH__
    asm volatile(
        "{\n\t"
        ".reg .pred done;\n\t"
        "WAIT:\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n\t"
        "@!done bra WAIT;\n\t"
        "}" ::"r"(smem_addr(bar)),
        "r"(parity)
        : "memory");
#else
    (void)bar;
    (void)parity;
    __syncthreads();
#endif
}

// thread 0: copy `bytes` (a multiple of 16, both addresses 16-byte aligned)
// from device memory to shared memory; completes on bar
__device__ __forceinline__ void load_async(void* dst, const void* src, uint32_t bytes,
                                           uint64_t* bar) {
#ifdef __CUDA_ARCH__
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
            "r"(smem_addr(dst)),
        "l"(src), "r"(bytes), "r"(smem_addr(bar))
        : "memory");
#else
    (void)bar;
    memcpy(dst, src, bytes);
#endif
}

// every thread that wrote shared memory a bulk store will read: make its
// writes visible to the copy engine (then a __syncthreads())
__device__ __forceinline__ void fence_async() {
#ifdef __CUDA_ARCH__
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
#endif
}

// thread 0: copy `bytes` from shared memory to device memory, as one bulk group
__device__ __forceinline__ void store_async(void* dst, const void* src, uint32_t bytes) {
#ifdef __CUDA_ARCH__
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(dst),
                 "r"(smem_addr(src)), "r"(bytes)
                 : "memory");
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
#else
    memcpy(dst, src, bytes);
#endif
}

// thread 0: wait until at most N bulk stores still read their shared memory
template <int N>
__device__ __forceinline__ void store_wait_read() {
#ifdef __CUDA_ARCH__
    asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(N) : "memory");
#endif
}

// thread 0: wait for every bulk store (before the block's shared memory goes)
__device__ __forceinline__ void store_wait_all() {
#ifdef __CUDA_ARCH__
    asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
#endif
}

// (x0, x1, x2, x3) <- (x_r, x_r+1, x_r+2, x_r+3), indices mod 4, with selects
template <class T>
__device__ __forceinline__ void rotate4(T& x0, T& x1, T& x2, T& x3, int r) {
    if (r & 1) {
        const T t = x0;
        x0 = x1;
        x1 = x2;
        x2 = x3;
        x3 = t;
    }
    if (r & 2) {
        T t = x0;
        x0 = x2;
        x2 = t;
        t = x1;
        x1 = x3;
        x3 = t;
    }
}

__device__ __forceinline__ int rotation(int e) { return (e >> 1) & 3; }

// 16 bytes of a record in shared (kGlobal false) or device memory
template <bool kGlobal>
__device__ __forceinline__ longlong2 chunk(const longlong2* p) {
#ifdef __CUDA_ARCH__
    if (kGlobal) return __ldg(p);
#endif
    return *p;
}

// a field element from its 8 limbs at p (16-byte aligned), chunk k holding
// limbs 2k and 2k + 1 (word k); the chunks read from chunk rot on
template <bool kGlobal>
__device__ __forceinline__ zk::Fe load_fe(const int64_t* p, int rot) {
    const longlong2* c = reinterpret_cast<const longlong2*>(p);
    uint32_t u[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        const longlong2 v = chunk<kGlobal>(c + ((j + rot) & 3));
        u[j] = (uint32_t)v.x | ((uint32_t)v.y << 16);
    }
    // u[j] is word (j + rot) & 3
    rotate4(u[0], u[1], u[2], u[3], (4 - rot) & 3);
    return zk::Fe{{u[0], u[1], u[2], u[3]}};
}

// a field element's 8 limbs to p in shared memory, from chunk rot on
__device__ __forceinline__ void store_fe(int64_t* p, const zk::Fe& a, int rot) {
    longlong2* c = reinterpret_cast<longlong2*>(p);
    uint32_t u[4] = {a.w[0], a.w[1], a.w[2], a.w[3]};
    rotate4(u[0], u[1], u[2], u[3], rot);  // u[j] is word (j + rot) & 3
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        longlong2 v;
        v.x = (long long)(u[j] & 0xFFFFu);
        v.y = (long long)(u[j] >> 16);
        c[(j + rot) & 3] = v;
    }
}

// 8 little-endian 64-bit words (a digest) to p in shared memory, from chunk
// rot on
__device__ __forceinline__ void store_words(void* p, const uint64_t h[8], int rot) {
    longlong2* c = reinterpret_cast<longlong2*>(p);
    longlong2 v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        v[k].x = (long long)h[2 * k];
        v[k].y = (long long)h[2 * k + 1];
    }
    rotate4(v[0], v[1], v[2], v[3], rot);
#pragma unroll
    for (int j = 0; j < 4; ++j) c[(j + rot) & 3] = v[j];
}

}  // namespace tiles
