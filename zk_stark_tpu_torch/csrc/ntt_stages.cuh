// The pieces the NTT stage kernels share (ntt.cu, ntt_variants.cu): an
// element in shared memory as 4 words of 32 bits; a block's tile of
// neighbouring transforms (Strides, Tile, tile_index, tile_at, tile_base)
// and its layout in shared memory (TileLayout); the walks that load a tile
// into shared memory and store it back in 16-byte chunks (load_chunks,
// load_tile, store_tile); and the radix-2 DIT butterfly stages of the
// transforms a block holds (stage_shared, stages_shared).

#pragma once

#include <stdint.h>

#include "field.cuh"

using zk::Fe;

struct alignas(16) Fe4 {
    uint32_t w[4];
};

__device__ __forceinline__ Fe from4(const Fe4& v) {
    Fe r;
#pragma unroll
    for (int k = 0; k < 4; ++k) r.w[k] = v.w[k];
    return r;
}

__device__ __forceinline__ Fe4 to4(const Fe& v) {
    Fe4 r;
#pragma unroll
    for (int k = 0; k < 4; ++k) r.w[k] = v.w[k];
    return r;
}

__device__ __forceinline__ unsigned bit_reverse(unsigned i, int log2n) {
#ifdef __CUDA_ARCH__
    return __brev(i) >> (32 - log2n);
#else
    unsigned r = 0;
    for (int b = 0; b < log2n; ++b) r |= ((i >> b) & 1u) << (log2n - 1 - b);
    return r;
#endif
}

// element offsets of transform (bx, by, bz) and of element i within it
struct Strides {
    long long bx, by, bz, e;
};

// a block's tile: 2^log2_count transforms along grid index dim (0, 1, 2 for
// x, y, z) of extent transforms in all; input and output chunks walked
// transform-major (1) or element-major (0)
struct Tile {
    int dim, log2_count, extent, in_tmajor, out_tmajor;
};

__device__ __forceinline__ long long dim_stride(const Strides& s, int dim) {
    return dim == 0 ? s.bx : (dim == 1 ? s.by : s.bz);
}

// transform t and element i of the tile's chunk e (of 16-byte chunks / 4)
__device__ __forceinline__ void tile_index(int e, bool tmajor, int log2n, int log2_count,
                                           int& t, int& i) {
    if (tmajor) {
        t = e & ((1 << log2_count) - 1);
        i = e >> log2_count;
    } else {
        t = e >> log2n;
        i = e & ((1 << log2n) - 1);
    }
}

// The tile of the block at grid position (bx, by, bz), counted in tiles
// along tile.dim and in transforms along the other two: its first
// transform's grid indices and how many transforms it holds (the last tile
// along tile.dim may hold fewer).
struct TileAt {
    long long ix, iy, iz;
    int count;
};

__device__ __forceinline__ TileAt tile_at(const Tile& tile, long long bx, long long by,
                                          long long bz) {
    // the tile's first transform (scalars, not an array indexed by
    // tile.dim, which would live in local memory)
    const int sx = tile.dim == 0 ? tile.log2_count : 0;
    const int sy = tile.dim == 1 ? tile.log2_count : 0;
    const int sz = tile.dim == 2 ? tile.log2_count : 0;
    TileAt a;
    a.ix = bx << sx;
    a.iy = by << sy;
    a.iz = bz << sz;
    const long long left = tile.extent - (tile.dim == 0 ? a.ix : (tile.dim == 1 ? a.iy : a.iz));
    a.count = left < (1 << tile.log2_count) ? (int)left : 1 << tile.log2_count;
    return a;
}

// the limbs of the tile's first transform in a tensor laid out by s
template <class T>
__device__ __forceinline__ T* tile_base(T* p, const Strides& s, const TileAt& a) {
    return p + 8 * (a.ix * s.bx + a.iy * s.by + a.iz * s.bz);
}

// Where element q of transform t of a block lives in shared memory (in
// elements of 16 bytes): transforms at a stride of n + 1 elements, and from
// n = 64 on the low three bits of q XOR-ed with its top three.  An element
// spans 4 of the 32 banks, so 8 elements that a quarter of a warp touches
// at once should differ in their index mod 8: the pad separates the same q
// of neighbouring transforms, the XOR the bit-reversed scatter of 8
// neighbouring q (which differ in their top bits only), while neighbouring q
// (the butterflies of a stage, the natural-order store) keep distinct low
// bits.
struct TileLayout {
    int log2n;
    __device__ __forceinline__ int operator()(int t, int q) const {
        const int swz = log2n >= 6 ? (q >> (log2n - 3)) & 7 : 0;
        return t * ((1 << log2n) + 1) + (q ^ swz);
    }
};

// Loads chunks [c0, c1) of a tile of `count` transforms into shared memory
// (`words`, 4 a 16-byte element, laid out by `at`) with their rows
// bit-reversed: the tile's 16-byte chunks, walked transform-major or
// element-major (tile_index), neighbouring threads on neighbouring chunks.
// chunk(c, t, i) reads chunk c (quarter c & 3 of element i of transform t:
// limbs 2k and 2k+1), which the thread repacks to word k.  load_tile takes
// the whole tile.
template <class Chunk>
__device__ __forceinline__ void load_chunks(uint32_t* words, int c0, int c1, int log2n,
                                            int log2_count, bool tmajor, int count,
                                            TileLayout at, Chunk chunk) {
    for (int c = c0 + threadIdx.x; c < c1; c += blockDim.x) {
        int t, i;
        tile_index(c >> 2, tmajor, log2n, log2_count, t, i);
        if (t >= count) continue;
        const longlong2 v = chunk(c, t, i);
        words[4 * at(t, (int)bit_reverse((unsigned)i, log2n)) + (c & 3)] =
            (uint32_t)v.x | ((uint32_t)v.y << 16);
    }
}

template <class Chunk>
__device__ __forceinline__ void load_tile(uint32_t* words, int log2n, int log2_count,
                                          bool tmajor, int count, TileLayout at, Chunk chunk) {
    load_chunks(words, 0, (1 << log2n) << (log2_count + 2), log2n, log2_count, tmajor, count, at,
                chunk);
}

// Stores the tile's `count` transforms from shared memory in natural order,
// chunk by chunk as load_tile walks them: chunk c of element i of
// transform t to yv[4 * (t * out_t + i * out_e) + (c & 3)], yv the tile's
// first transform as 16-byte chunks (indexing chunks, not int64 limbs,
// keeps the stores 16 bytes wide).
__device__ __forceinline__ void store_tile(longlong2* yv, long long out_t, long long out_e,
                                           const uint32_t* words, int log2n, int log2_count,
                                           bool tmajor, int count, TileLayout at) {
    const int chunks = (1 << log2n) << (log2_count + 2);
    for (int c = threadIdx.x; c < chunks; c += blockDim.x) {
        int t, i;
        tile_index(c >> 2, tmajor, log2n, log2_count, t, i);
        if (t >= count) continue;
        const uint32_t w = words[4 * at(t, i) + (c & 3)];
        longlong2 v;
        v.x = (long long)(w & 0xFFFFu);
        v.y = (long long)(w >> 16);
        yv[4 * (t * out_t + i * out_e) + (c & 3)] = v;
    }
}

// Where stage s's twiddle j, root^(j * n / 2^(s+1)), lies in the [n/2]
// table root^k (ntt.cu's): j << (log2n - 1 - s).
struct RootIndex {
    int log2n;
    __device__ __forceinline__ int operator()(int s, int j) const { return j << (log2n - 1 - s); }
};

// Stage s of the ``count`` transforms in sh (laid out by ``at``), without
// the barrier after it: it pairs i0 and i0 + 2^s and multiplies the odd one
// by its twiddle, tw4[index(s, j)].  The butterflies of all the transforms
// are one block-stride loop.
template <class Index>
__device__ __forceinline__ void stage_shared(Fe4* sh, const Fe4* __restrict__ tw4, int log2n,
                                             int s, int count, TileLayout at, Index index) {
    const int half = 1 << (log2n - 1);
    const int h = 1 << s;
    for (int b = threadIdx.x; b < count * half; b += blockDim.x) {
        const int t = b >> (log2n - 1);
        const int bb = b & (half - 1);
        const int j = bb & (h - 1);
        const int i0 = ((bb >> s) << (s + 1)) + j;
        const int p0 = at(t, i0), p1 = at(t, i0 + h);
        const Fe e = from4(sh[p0]);
        const Fe v = zk::mont_mul(from4(sh[p1]), from4(tw4[index(s, j)]));
        sh[p0] = to4(zk::add_mod(e, v));
        sh[p1] = to4(zk::sub_mod(e, v));
    }
}

// Stages s0 .. log2n-1, each followed by a barrier: the input of stage 0 is
// in bit-reversed order, the output of the last in natural order.
template <class Index>
__device__ __forceinline__ void stages_shared(Fe4* sh, const Fe4* __restrict__ tw4, int log2n,
                                              int s0, int count, TileLayout at, Index index) {
    for (int s = s0; s < log2n; ++s) {
        stage_shared(sh, tw4, log2n, s, count, at, index);
        __syncthreads();
    }
}
