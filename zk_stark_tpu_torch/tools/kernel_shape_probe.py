"""Probe the block shapes and the time split of the redesigned kernels.

Measures, on the card, what the choices in ``ops/ntt.py`` (``TILE_ELEMS``,
``BLOCK_THREADS``) and ``ops/rescue_ops.py`` (``KERNEL_THREADS``) rest on,
and where a pass of ``csrc/ntt.cu`` spends its time:

- ``ntt_tiles``: ``ntt_kernel`` at 4096, 2^20, 2^24 and 2^25 points with
  other tile sizes and block widths (each result bit for bit the default's);
- ``ntt_split``: each pass of those transforms in three builds of
  ``csrc/ntt.cu``: as it is, with its stages removed (loads and stores
  only), and with its device-memory loads and stores removed (stages only);
- ``rescue_blocks``: the Rescue kernel at 256, 2^14 and 2^20 states in
  blocks of 32 to 256 threads (each result bit for bit the default's);
- ``carry_flag``: what ``addc`` reads after ``sub.cc`` (the reason
  ``csrc/field.cuh`` never lets an addition read a subtraction's flag);
- ``node_trees``: the node kernel's trees (``ops/blake2b.py``
  ``tree_kernel``) of 2^12 and 2^20 leaves at other most-levels-a-launch
  (``TREE_LEVELS``, 8 to 11) and block widths (``NODE_THREADS``, 64 to
  256), whole and launch by launch, queued (each result bit for bit the
  default's);
- ``node_builds``: ``csrc/blake2b.cu`` as it is and in builds whose
  launch bounds ask for other block widths and blocks an SM (the register
  cap) or whose narrow levels run four lanes a parent below other widths,
  or never: each build's registers and spills, its 2^12- and 2^20-leaf
  trees (the latter also launch by launch) and one level of 2^19 parents,
  queued;
- ``node_level``: one level of 2^19 parents (``node_kernel``'s form) in
  blocks of 2^8 to 2^11 children and 128 or 256 threads, queued;
- ``root_inverse``: the inversion of one element on one thread, by the
  addition chain (``csrc/inverse.cuh`` ``inv_fermat``), by the binary
  extended Euclid (``inv_binary``, what ``csrc/batch_inv.cu`` inverts its
  total with) and by the same with each round one path of selects through
  both cases in place of its branch, or with its subtractions and
  additions in C in place of PTX carry chains: each first held against
  Python integers on 0, 1, p-1, p-2, R mod p and 16,384 random elements
  (one thread an element), then timed as a chain of 1 and of 65
  dependent inversions in one launch (the difference over 64 is the
  latency of one);
- ``batch_inv_shapes``: ``batch_inv_kernel`` at 1024, 4096 and 2^18
  elements with blocks of 64 to 1024 threads and 1 to 8 elements a thread
  (``ops/limbs.py`` ``BATCH_INV_THREADS``, ``BATCH_INV_PER_THREAD``;
  at 1024 and 4096 only the shapes one block holds), each result bit for
  bit the default's, queued;
- ``batch_inv_builds``: ``csrc/batch_inv.cu`` as it is and in builds
  whose launch bounds allow other register counts, whose block total is
  inverted by the addition chain, or not at all (a wrong result: the time
  of everything but the root), or whose scans branch around the products
  of the lanes with nothing to multiply: each build's registers and
  spills and its time at 1, 284, 1024 and 2^18 elements in the default
  shape, queued;
- ``montmul_chains``: ``csrc/montmul_chain.cu`` built with 1, 2 and 4
  elements' chains a thread (``kChains``): each build's registers and
  spills, its compiled instructions a product (multiply-adds and the
  rest) and its time at k = 32 and 1024 on 2^18 elements (each result bit
  for bit the package's build's);
- ``variant_c_builds``: the stage-variant probe's c at 1024 transforms of
  1024 points in builds whose launch bounds ask for 2, 3 and 4 blocks of
  512 threads an SM;
- ``variant_d_builds``: the stage-variant probe's d at 1024 transforms of
  1024 points, built to stream a tile in at most 1, 2 or 4 slices, with
  256, 512 and 1024 threads a block.

    python -m zk_stark_tpu_torch.tools.kernel_shape_probe [SECTION ...]

runs on the card (and raises without one) and prints one line a
measurement, then one JSON object.  The variant builds go to
``zk_stark_tpu_torch/build/`` like every other library.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import shutil
import subprocess
import sys

import torch

from ..field import Field
from ..models.rescue_prime import RescuePrime
from ..ops import _build
from ..ops import blake2b as B
from ..ops import limbs as L
from ..ops import montmul_chain as MC
from ..ops import ntt as N
from ..ops import ntt_variants as V
from ..ops import rescue_ops as R
from . import measure as M

NTT_SIZES = (1 << 12, 1 << 20, 1 << 24, 1 << 25)
#: (TILE_ELEMS, BLOCK_THREADS) pairs beside the default
TILES = ((1 << 10, 256), (1 << 10, 512), (1 << 11, 256), (1 << 11, 512), (1 << 12, 512),
         (1 << 12, 1024), (1 << 13, 1024))
#: (TREE_LEVELS, NODE_THREADS) pairs of the node trees, the default among them
TREE_SHAPES = tuple((k, t) for k in (8, 9, 10, 11) for t in (64, 128, 256))
TREE_SIZES = (1 << 12, 1 << 20)
_BOUNDS = "constexpr int kMaxThreads = 256;\nconstexpr int kMinBlocks = 3;"
_NARROW = "(threads & 3) == 0 && 4 * parents <= threads"
#: builds of csrc/blake2b.cu beside the source as it is: name -> (threads a
#: block, the text that replaces _BOUNDS or _NARROW).  The launch bounds
#: (node::kMaxThreads, kMinBlocks) set the register cap, from 128 registers
#: a thread (256 x 2) to 64 (256 x 4); the narrow-level test sets which
#: levels run four lanes a parent (at most 64, 32, 16 or 8 parents of 256
#: threads, or none)
NODE_BUILDS = {
    "bounds 256 x 2": (256, _BOUNDS, "constexpr int kMaxThreads = 256;\nconstexpr int kMinBlocks = 2;"),
    "bounds 256 x 4": (256, _BOUNDS, "constexpr int kMaxThreads = 256;\nconstexpr int kMinBlocks = 4;"),
    "bounds 128 x 6": (128, _BOUNDS, "constexpr int kMaxThreads = 128;\nconstexpr int kMinBlocks = 6;"),
    "bounds 128 x 7": (128, _BOUNDS, "constexpr int kMaxThreads = 128;\nconstexpr int kMinBlocks = 7;"),
    "four lanes at most 32 parents": (256, _NARROW, "(threads & 3) == 0 && 8 * parents <= threads"),
    "four lanes at most 16 parents": (256, _NARROW, "(threads & 3) == 0 && 16 * parents <= threads"),
    "four lanes at most 8 parents": (256, _NARROW, "(threads & 3) == 0 && 32 * parents <= threads"),
    "one lane a parent": (256, _NARROW, "false"),
}
#: children a block takes for one level of 2^19 parents, and its threads
LEVEL_SPANS = tuple((k, t) for k in (8, 9, 10, 11) for t in (128, 256))
RESCUE_SIZES = (256, 1 << 14, 1 << 20)
RESCUE_THREADS = (32, 64, 128, 256)

_STAGES = ("    stages_shared(sh, reinterpret_cast<const Fe4*>(tw), log2n, 0, count, at, "
           "RootIndex{log2n});\n")
_LOAD = """        return *reinterpret_cast<const longlong2*>(
            xb + 8 * (t * in_t + i * in.e) + 2 * (c & 3));"""
_STORE = ("    store_tile(reinterpret_cast<longlong2*>(yb), out_t, out.e, words, log2n, "
          "tile.log2_count,\n               tile.out_tmajor, count, at);")
_CARRY = r"""
#include <stdint.h>
extern "C" __global__ void carry_kernel(uint32_t* out, uint32_t a, uint32_t b) {
    uint32_t d, r, m;
    asm volatile("sub.cc.u32 %0, %2, %3;\n\taddc.u32 %1, 0, 0;" : "=r"(d), "=r"(r) : "r"(a), "r"(b));
    asm volatile("sub.cc.u32 %0, %2, %3;\n\tsubc.u32 %1, 0, 0;" : "=r"(d), "=r"(m) : "r"(a), "r"(b));
    out[0] = r;
    out[1] = m;
}
extern "C" int carry_launch(void* out, uint32_t a, uint32_t b) {
    carry_kernel<<<1, 1>>>((uint32_t*)out, a, b);
    return (int)cudaGetLastError();
}
"""


#: the root inversion's probe kernels (csrc/inverse.cuh): one thread's
#: chain of `reps` dependent inversions, and one thread an element
_ROOT = r"""
#include <stdint.h>
#include <cuda_runtime.h>
#include "inverse.cuh"
// inv_binary's rounds as one path of selects through both cases, no branch
// on the comparison (its additions and subtractions in C)
__device__ zk::Fe select(bool c, const zk::Fe& x, const zk::Fe& y) {
    zk::Fe r;
    for (int j = 0; j < 4; ++j) r.w[j] = c ? x.w[j] : y.w[j];
    return r;
}
__device__ zk::Fe inv_binary_selects(const zk::Fe& x) {
    if ((x.w[0] | x.w[1] | x.w[2] | x.w[3]) == 0) return x;
    zk::Fe u = zk::p_fe(), v = x, r{{0u, 0u, 0u, 0u}}, s{{1u, 0u, 0u, 0u}};
    uint32_t r4 = 0, s4 = 0;
    int k = zk::strip_zeros(v);
    for (;;) {
        zk::Fe du, dv;
        zk::sub4(du, u, v);
        const bool gt = zk::sub4(dv, v, u) != 0;
        zk::Fe a = select(gt, du, dv), big = select(gt, r, s), small = select(gt, s, r);
        uint32_t big4 = gt ? r4 : s4, small4 = gt ? s4 : r4;
        big4 += small4 + zk::add4(big, big, small);
        const bool done = (a.w[0] | a.w[1] | a.w[2] | a.w[3]) == 0;
        const int z = done ? 1 : zk::strip_zeros(a);
        zk::shift_left5(small, small4, z);
        k += z;
        u = select(gt, a, u);
        v = select(gt, v, a);
        r = select(gt, big, small);
        s = select(gt, small, big);
        r4 = gt ? big4 : small4;
        s4 = gt ? small4 : big4;
        if (done) break;
    }
    return zk::inverse_from_rounds(r, r4, k);
}
// inv_binary's rounds with their subtractions and additions in C (64-bit
// arithmetic, field.cuh sub4 / add4) in place of PTX carry chains
__device__ zk::Fe inv_binary_c(const zk::Fe& x) {
    if ((x.w[0] | x.w[1] | x.w[2] | x.w[3]) == 0) return x;
    zk::Fe u = zk::p_fe(), v = x, r{{0u, 0u, 0u, 0u}}, s{{1u, 0u, 0u, 0u}};
    uint32_t r4 = 0, s4 = 0;
    int k = zk::strip_zeros(v);
    for (;;) {
        zk::Fe du, dv;
        zk::sub4(du, u, v);
        if (zk::sub4(dv, v, u)) {
            u = du;
            r4 += s4 + zk::add4(r, r, s);
            const int z = zk::strip_zeros(u);
            zk::shift_left5(s, s4, z);
            k += z;
        } else {
            v = dv;
            s4 += r4 + zk::add4(s, s, r);
            if ((v.w[0] | v.w[1] | v.w[2] | v.w[3]) == 0) {
                zk::shift_left5(r, r4, 1);
                k += 1;
                break;
            }
            const int z = zk::strip_zeros(v);
            zk::shift_left5(r, r4, z);
            k += z;
        }
    }
    return zk::inverse_from_rounds(r, r4, k);
}
__device__ zk::Fe inv(const zk::Fe& x, int method) {
    return method == 0 ? zk::inv_fermat(x) : method == 1 ? zk::inv_binary(x)
         : method == 2 ? inv_binary_selects(x) : inv_binary_c(x);
}
extern "C" __global__ void root_chain_kernel(const int64_t* a, int64_t* out, int reps, int method) {
    zk::Fe x = zk::load_fe(a);
    for (int r = 0; r < reps; ++r) x = inv(x, method);
    zk::store_fe(out, x);
}
extern "C" __global__ void root_each_kernel(const int64_t* a, int64_t* out, int64_t n, int method) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) zk::store_fe(out + 8 * i, inv(zk::load_fe(a + 8 * i), method));
}
extern "C" int root_chain_launch(const void* a, void* out, int reps, int method, void* stream) {
    root_chain_kernel<<<1, 1, 0, (cudaStream_t)stream>>>((const int64_t*)a, (int64_t*)out, reps,
                                                         method);
    return (int)cudaGetLastError();
}
extern "C" int root_each_launch(const void* a, void* out, int64_t n, int method, void* stream) {
    root_each_kernel<<<(int)((n + 127) / 128), 128, 0, (cudaStream_t)stream>>>(
        (const int64_t*)a, (int64_t*)out, n, method);
    return (int)cudaGetLastError();
}
"""
#: the root inversions the probe times: name -> its code in _ROOT
ROOT_METHODS = {"addition chain": 0, "binary extended Euclid": 1,
                "binary extended Euclid, selects": 2,
                "binary extended Euclid, C carries": 3}
#: the root inversions' chains: 1 and ROOT_REPS + 1 (odd: the result is the
#: inverse) dependent inversions in a launch
ROOT_REPS = 64
ROOT_RANDOM = 1 << 14
#: the batch inversion's sizes and (threads, elements a thread) shapes
BATCH_INV_SIZES = (1 << 10, 1 << 12, 1 << 18)
BATCH_INV_SHAPES = tuple((t, k) for t in (64, 128, 256, 512, 1024) for k in (1, 2, 4, 8))


_BINV_BOUNDS = "constexpr int kMaxThreads = 1024;"
_BINV_ROOT = "*root = zk::inv_binary(wp);"
_BINV_SCAN = """        pre = zk::mont_mul(pre, lane >= d ? up : one());
        suf = zk::mont_mul(suf, lane + d < width ? down : one());"""
_BINV_SCAN_BRANCHES = """        if (lane >= d) pre = zk::mont_mul(pre, up);
        if (lane + d < width) suf = zk::mont_mul(suf, down);"""
#: builds of csrc/batch_inv.cu beside the source as it is: name -> (the
#: text replaced, its replacement, whether the result stays right)
BATCH_INV_BUILDS = {
    "launch bounds 256": (_BINV_BOUNDS, "constexpr int kMaxThreads = 256;", True),
    "launch bounds 512": (_BINV_BOUNDS, "constexpr int kMaxThreads = 512;", True),
    "root by the addition chain": (_BINV_ROOT, "*root = zk::inv_fermat(wp);", True),
    "root not inverted": (_BINV_ROOT, "*root = wp;", False),
    "scan with branches": (_BINV_SCAN, _BINV_SCAN_BRANCHES, True),
}
BATCH_INV_BUILD_SIZES = (1, 284, 1024, 1 << 18)
#: the chained product's builds (elements' chains a thread, kChains), its
#: elements and chain lengths (chip_smoke.py phase 8's)
CHAIN_COUNTS = (1, 2, 4)
CHAIN_N, CHAIN_KS = 1 << 18, (32, 1024)
#: each build's masked tail, held against the plain chain
CHAIN_RAGGED_N, CHAIN_RAGGED_K = (1 << 12) + 3, 33
#: variant d's builds (most slices a tile, launch bounds) and threads a
#: block, at the probe's 1024 transforms of 1024 points
D_BUILDS = ((1, "1024"), (2, "1024"), (4, "1024"), (4, "512, 3"), (4, "512, 4"))
D_THREADS = (256, 512, 1024)
#: variant c's blocks of 512 threads an SM that its launch bounds ask for
C_BLOCKS = (2, 3, 4)


def _build_variant(name: str, source: str) -> ctypes.CDLL:
    """Compile ``source`` (beside copies of the csrc headers) like the
    package's libraries and load it; its ptxas report is in ``lib.ptxas``
    (empty if it was built before)."""
    key = hashlib.sha256(source.encode() + " ".join(_build.NVCC_FLAGS).encode()).hexdigest()[:16]
    work = _build.BUILD / f"probe_{name}_{key}"
    so = work / f"lib{name}.so"
    log = ""
    if not so.exists():
        work.mkdir(parents=True, exist_ok=True)
        for header in _build.CSRC.glob("*.cuh"):
            shutil.copy(header, work / header.name)
        (work / f"{name}.cu").write_text(source)
        done = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(so),
                               str(work / f"{name}.cu")],
                              check=True, capture_output=True, text=True, timeout=600)
        log = done.stdout + done.stderr
    lib = ctypes.CDLL(str(so))
    lib.ptxas = log
    lib.path = so
    return lib


def _random(n: int, gen: torch.Generator, dev) -> torch.Tensor:
    x = torch.randint(0, 1 << 16, (n, L.NLIMB), dtype=L.DTYPE, generator=gen)
    x[:, -1] %= L.P_LIMBS[-1]
    return x.to(dev)


def _reps(n: int) -> dict:
    return dict(reps=5, runs=3) if n >= 1 << 24 else dict(reps=20, runs=5)


def ntt_tiles(dev, gen) -> list:
    F = Field()
    default = (N.TILE_ELEMS, N.BLOCK_THREADS)
    rows = []
    try:
        for n in NTT_SIZES:
            x = _random(n, gen, dev)
            root = F.primitive_nth_root(n).value
            ref = N.ntt_kernel(x, root)
            for tile, threads in (default,) + TILES:
                N.TILE_ELEMS, N.BLOCK_THREADS = tile, threads
                if not torch.equal(N.ntt_kernel(x, root), ref):
                    raise RuntimeError(f"ntt_tiles: tile {tile}, {threads} threads differ at n={n}")
                ms = M.time_ms(lambda: N.ntt_kernel(x, root), **_reps(n))
                rows.append(dict(n=n, tile=tile, threads=threads, ms=ms))
                print(f"ntt n={n} tile={tile} threads={threads}: {ms:.4f} ms", flush=True)
                N.TILE_ELEMS, N.BLOCK_THREADS = default
            del x, ref
    finally:
        N.TILE_ELEMS, N.BLOCK_THREADS = default
    return rows


def ntt_split(dev, gen) -> list:
    src = (_build.CSRC / "ntt.cu").read_text()
    for piece in (_STAGES, _LOAD, _STORE):
        if piece not in src:
            raise RuntimeError("ntt_split: csrc/ntt.cu no longer has the statement to remove")
    variants = {
        "memory_only": src.replace(_STAGES, "").replace("    if (ft) {", "    if (ft && tile.extent < 0) {"),
        "stages_only": src.replace(_LOAD, "        longlong2 v; v.x = c; v.y = t + i; return v;")
                          .replace(_STORE, "    if (tile.extent < 0) " + _STORE.strip()),
    }
    libs = {"full": _build.load("ntt")}
    libs.update({k: _build_variant(f"ntt_{k}", v) for k, v in variants.items()})
    F = Field()
    rows = []
    for n in NTT_SIZES:
        x = _random(n, gen, dev)
        dst = torch.empty_like(x)
        root = F.primitive_nth_root(n).value
        for p in N.kernel_passes(n, 1, root):
            tw, ft = N.pass_tables(p, str(dev))
            blk = N.block_shape(p)
            ptrs = [x.data_ptr(), dst.data_ptr(), tw.data_ptr()] + ([] if ft is None else [ft.data_ptr()])
            row = dict(n=n, m=p.m, grid=p.grid, block=list(blk))
            for name, lib in libs.items():
                fn = getattr(lib, p.kernel.symbol)
                fn.argtypes, fn.restype = p.kernel.argtypes, ctypes.c_int

                def call():
                    rc = fn(*ptrs, p.m.bit_length() - 1, *p.grid, *p.ins, *p.outs, blk.dim,
                            blk.log2_count, blk.threads, int(blk.in_tmajor), int(blk.out_tmajor),
                            _build.stream_ptr(x.device))
                    if rc:
                        raise RuntimeError(f"ntt_split: {name} failed to launch: error {rc}")

                row[name] = M.time_ms(call, **_reps(n))
            rows.append(row)
            print(f"ntt n={n} pass m={p.m}: full {row['full']:.4f} ms, loads and stores only "
                  f"{row['memory_only']:.4f}, stages only {row['stages_only']:.4f}", flush=True)
        del x, dst
    return rows


def rescue_blocks(dev, gen) -> list:
    rp = RescuePrime(Field())
    mds, rc = rp._device_constants(dev)
    a_steps, a_len = R._steps(rp.alpha)
    ai_steps, ai_len = R._steps(rp.alpha_inv)
    rows = []
    for n in RESCUE_SIZES:
        x = _random(n, gen, dev)
        state = torch.stack([x, torch.zeros_like(x)], dim=1)
        ref = R.permutation_kernel(state, mds, rc, rp.N, rp.alpha, rp.alpha_inv)
        out = torch.empty_like(state)
        for threads in RESCUE_THREADS:
            def call():
                R.RESCUE_KERNEL(state.data_ptr(), out.data_ptr(), mds.data_ptr(), rc.data_ptr(),
                                n, rp.m, rp.N, a_steps, a_len, ai_steps, ai_len, threads,
                                _build.stream_ptr(state.device))
            call()
            if not torch.equal(out, ref):
                raise RuntimeError(f"rescue_blocks: {threads} threads differ at n={n}")
            ms = M.time_ms(call, reps=3 if n >= 1 << 20 else 20, runs=3)
            rows.append(dict(n=n, threads=threads, ms=ms))
            print(f"rescue n={n} threads={threads}: {ms:.4f} ms", flush=True)
    return rows


def node_trees(dev, gen) -> list:
    default = (B.TREE_LEVELS, B.NODE_THREADS)
    rows = []
    try:
        for n in TREE_SIZES:
            leaves = B.leaf_kernel(L.redc_kernel(_random(n, gen, dev)))
            ref = B.tree_kernel(leaves)
            for k, threads in TREE_SHAPES:
                B.TREE_LEVELS, B.NODE_THREADS = k, threads
                inner = B.tree_kernel(leaves)
                if not torch.equal(inner, ref):
                    raise RuntimeError(f"node_trees: {k} levels, {threads} threads differ at n={n}")
                ms = M.time_ms(lambda: B.tree_kernel(leaves), queued=True)
                launch_ms = []
                for level, levels in B.tree_launches(n):
                    src = leaves if level == 0 else inner[B.level_start(n, level)]
                    dst = inner[B.level_start(n, level + 1)]
                    launch_ms.append(M.time_ms(
                        lambda: B.NODE_KERNEL(src.data_ptr(), dst.data_ptr(), n >> level, levels,
                                              levels, threads, _build.stream_ptr(dev)),
                        queued=True))
                plan = [levels for _, levels in B.tree_launches(n)]
                rows.append(dict(n=n, tree_levels=k, threads=threads, plan=plan, ms=ms,
                                 launch_ms=launch_ms))
                print(f"node tree n={n} levels a launch <= {k} {plan} threads={threads}: {ms:.5f} "
                      f"ms queued, launches {', '.join(f'{t:.5f}' for t in launch_ms)}", flush=True)
                B.TREE_LEVELS, B.NODE_THREADS = default
            del leaves, ref
    finally:
        B.TREE_LEVELS, B.NODE_THREADS = default
    return rows


def _kernel_report(log: str, kernel: str) -> str:
    """ptxas's registers and spills of ``kernel`` in a build's report."""
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if line.rstrip().endswith(f"'{kernel}' for 'sm_90a'"):
            return " ".join(x.split(":", 1)[-1].strip() for x in lines[i + 1:i + 3])
    return "not rebuilt"


def node_builds(dev, gen) -> list:
    src = (_build.CSRC / "blake2b.cu").read_text()
    for piece in (_BOUNDS, _NARROW):
        if piece not in src:
            raise RuntimeError(f"node_builds: csrc/blake2b.cu no longer has {piece!r}")
    stream = _build.stream_ptr(dev)
    inputs = {n: B.leaf_kernel(L.redc_kernel(_random(n, gen, dev))) for n in TREE_SIZES}
    refs = {n: B.tree_kernel(leaves) for n, leaves in inputs.items()}
    wide = inputs[1 << 20]
    wide_ref = B.node_kernel(wide)
    rows = []
    builds = {"as it is": (B.NODE_THREADS, _BOUNDS, _BOUNDS), **NODE_BUILDS}
    for name, (threads, old, new) in builds.items():
        tag = hashlib.sha256(name.encode()).hexdigest()[:8]
        lib = _build_variant(f"blake2b_{tag}", src.replace(old, new))
        fn = lib.node_launch
        fn.argtypes, fn.restype = B.NODE_KERNEL.argtypes, ctypes.c_int

        def launch(src_t, dst_t, m, span_log2, levels):
            rc = fn(src_t.data_ptr(), dst_t.data_ptr(), m, span_log2, levels, threads, stream)
            if rc:
                raise RuntimeError(f"node_builds: {name} failed to launch: error {rc}")

        def tree(n, inner):
            for level, k in B.tree_launches(n):
                src_t = inputs[n] if level == 0 else inner[B.level_start(n, level)]
                launch(src_t, inner[B.level_start(n, level + 1)], n >> level, k, k)

        row = dict(build=name, threads=threads, ptxas=_kernel_report(lib.ptxas, "node_kernel"))
        for n in TREE_SIZES:
            inner = torch.empty_like(refs[n])
            tree(n, inner)
            if not torch.equal(inner, refs[n]):
                raise RuntimeError(f"node_builds: {name} differs at n={n}")
            row[f"tree_{n}_ms"] = M.time_ms(lambda: tree(n, inner), queued=True)
        level = torch.empty_like(wide_ref)

        def one_level():  # as node_kernel asks for it
            rc = fn(wide.data_ptr(), level.data_ptr(), wide.shape[0], B.LEVEL_SPAN_LOG2, 1,
                    min(threads, B.LEVEL_THREADS), stream)
            if rc:
                raise RuntimeError(f"node_builds: {name} failed to launch one level: error {rc}")

        one_level()
        if not torch.equal(level, wide_ref):
            raise RuntimeError(f"node_builds: {name} differs on one level")
        row["level_ms"] = M.time_ms(one_level, queued=True)
        n = 1 << 20
        inner = torch.empty_like(refs[n])
        row["tree_launch_ms"] = []
        for lvl, k in B.tree_launches(n):
            src_t = inputs[n] if lvl == 0 else refs[n][B.level_start(n, lvl)]
            row["tree_launch_ms"].append(M.time_ms(
                lambda: launch(src_t, inner[B.level_start(n, lvl + 1)], n >> lvl, k, k),
                queued=True))
        rows.append(row)
        print(f"node build {name}, {threads} threads ({row['ptxas']}): tree 4096 "
              f"{row['tree_4096_ms']:.5f} ms, tree 1048576 {row['tree_1048576_ms']:.5f} ms "
              f"(launches {', '.join(f'{t:.5f}' for t in row['tree_launch_ms'])}), one level "
              f"of 524288 parents {row['level_ms']:.5f} ms", flush=True)
    return rows


def node_level(dev, gen) -> list:
    wide = B.leaf_kernel(L.redc_kernel(_random(1 << 20, gen, dev)))
    ref = B.node_kernel(wide)
    out = torch.empty_like(ref)
    rows = []
    for span_log2, threads in LEVEL_SPANS:
        def call():
            B.NODE_KERNEL(wide.data_ptr(), out.data_ptr(), wide.shape[0], span_log2, 1, threads,
                          _build.stream_ptr(dev))
        call()
        if not torch.equal(out, ref):
            raise RuntimeError(f"node_level: span 2^{span_log2}, {threads} threads differ")
        ms = M.time_ms(call, queued=True)
        rows.append(dict(span_log2=span_log2, threads=threads, ms=ms))
        print(f"node one level of 524288 parents, blocks of 2^{span_log2} children and {threads} "
              f"threads: {ms:.5f} ms queued", flush=True)
    return rows


def carry_flag(dev) -> list:
    lib = _build_variant("carry", _CARRY)
    lib.carry_launch.argtypes = [ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint32]
    out = torch.zeros(2, dtype=torch.int32, device=dev)
    rows = []
    for a, b in ((0, 1), (1, 0), (5, 5)):
        if lib.carry_launch(out.data_ptr(), a, b):
            raise RuntimeError("carry_flag: launch failed")
        r, m = (int(v) & 0xFFFFFFFF for v in out.cpu())
        rows.append(dict(a=a, b=b, borrow=int(a < b), addc_reads=r, subc_mask=m))
        print(f"carry flag: {a} - {b} (borrow {int(a < b)}): addc reads {r}, subc 0,0 gives "
              f"{m:#x}", flush=True)
    return rows


def euclid_rounds(x: int) -> int:
    """Rounds of inverse.cuh's inv_binary for a stored value 0 < x < p
    (a model of its loop)."""
    u, v, rounds = L.P, x >> ((x & -x).bit_length() - 1), 0
    while v:
        rounds += 1
        if u > v:
            u -= v
            u >>= (u & -u).bit_length() - 1
        else:
            v -= u
            v = v >> ((v & -v).bit_length() - 1) if v else 0
    return rounds


def root_inverse(dev, gen) -> list:
    lib = _build_variant("root_inverse", _ROOT)
    lib.root_chain_launch.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    lib.root_each_launch.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int64, ctypes.c_int]
                                     + [ctypes.c_void_p])
    stream = _build.stream_ptr(dev)
    r2 = L.R_INT * L.R_INT % L.P
    x = torch.cat([L.from_numpy(L.ints_to_limbs([0, 1, L.P - 1, L.P - 2, L.R_INT]), dev),
                   _random(ROOT_RANDOM, gen, dev)])
    want = [pow(int(v), -1, L.P) * r2 % L.P if v else 0 for v in L.limbs_to_ints(x)]
    rows = []
    for name, method in ROOT_METHODS.items():
        out = torch.empty_like(x)
        if lib.root_each_launch(x.data_ptr(), out.data_ptr(), x.shape[0], method, stream):
            raise RuntimeError(f"root_inverse: {name} failed to launch")
        if [int(v) for v in L.limbs_to_ints(out)] != want:
            raise RuntimeError(f"root_inverse: {name} differs from Python integers")
        one = torch.empty_like(x[:1])
        times = {}
        for reps in (1, ROOT_REPS + 1):
            def call():
                if lib.root_chain_launch(x[5:6].data_ptr(), one.data_ptr(), reps, method, stream):
                    raise RuntimeError(f"root_inverse: {name} failed to launch")
            times[reps] = M.time_ms(call, queued=True)
            if reps > 1 and [int(v) for v in L.limbs_to_ints(one)] != want[5:6]:
                raise RuntimeError(f"root_inverse: {name}'s chain differs")
        ms = (times[ROOT_REPS + 1] - times[1]) / ROOT_REPS
        # the chain alternates between the element and its inverse
        rounds = (euclid_rounds(int(L.limbs_to_ints(x[5:6])[0])) + euclid_rounds(want[5])) / 2
        rows.append(dict(method=name, ms=ms, one_launch_ms=times[1],
                         chain_ms=times[ROOT_REPS + 1], euclid_rounds=rounds))
        print(f"root inverse, {name}: bit-exact on 0, 1, p-1, p-2, R mod p and {ROOT_RANDOM} "
              f"random elements; {ms * 1e3:.3f} us an inversion on one thread ({ROOT_REPS + 1} in "
              f"a launch {times[ROOT_REPS + 1]:.5f} ms, one {times[1]:.5f} ms; the Euclid's "
              f"rounds {rounds})", flush=True)
    return rows


def batch_inv_shapes(dev, gen) -> list:
    rows = []
    stream = _build.stream_ptr(dev)

    def launch(src_t, out, n, totals, inv_totals, blocks, threads, per_thread):
        L.BATCH_INV_KERNEL(src_t.data_ptr(), None if out is None else out.data_ptr(), n,
                           None if totals is None else totals.data_ptr(),
                           None if inv_totals is None else inv_totals.data_ptr(),
                           blocks, threads, per_thread, stream)

    for n in BATCH_INV_SIZES:
        x = _random(n, gen, dev)
        x[0] = 0
        ref = L.batch_inv_kernel(x)
        for threads, k in BATCH_INV_SHAPES:
            if n <= 1 << 12 and threads * k < n:
                continue
            if not torch.equal(L.batch_inv_grid(x, launch, threads, k), ref):
                raise RuntimeError(f"batch_inv_shapes: {threads} x {k} differs at n={n}")
            ms = M.time_ms(lambda: L.batch_inv_grid(x, launch, threads, k), queued=True)
            rows.append(dict(n=n, threads=threads, per_thread=k, capacity=threads * k, ms=ms))
            print(f"batch_inv n={n} threads={threads} per_thread={k} (C = {threads * k}): "
                  f"{ms:.5f} ms queued", flush=True)
    return rows


def batch_inv_builds(dev, gen) -> list:
    src = (_build.CSRC / "batch_inv.cu").read_text()
    for piece in (_BINV_BOUNDS, _BINV_ROOT, _BINV_SCAN):
        if piece not in src:
            raise RuntimeError(f"batch_inv_builds: csrc/batch_inv.cu no longer has {piece!r}")
    stream = _build.stream_ptr(dev)
    inputs = {n: _random(n, gen, dev) for n in BATCH_INV_BUILD_SIZES}
    refs = {n: L.batch_inv_kernel(x) for n, x in inputs.items()}
    rows = []
    builds = {"as it is": (_BINV_BOUNDS, _BINV_BOUNDS, True), **BATCH_INV_BUILDS}
    for name, (old, new, exact) in builds.items():
        tag = hashlib.sha256(name.encode()).hexdigest()[:8]
        lib = _build_variant(f"batch_inv_{tag}", src.replace(old, new))
        fn = lib.batch_inv_launch
        fn.argtypes, fn.restype = L.BATCH_INV_KERNEL.argtypes, ctypes.c_int

        def launch(src_t, out, n, totals, inv_totals, blocks, threads, per_thread):
            rc = fn(src_t.data_ptr(), None if out is None else out.data_ptr(), n,
                    None if totals is None else totals.data_ptr(),
                    None if inv_totals is None else inv_totals.data_ptr(), blocks, threads,
                    per_thread, stream)
            if rc:
                raise RuntimeError(f"batch_inv_builds: {name} failed to launch: error {rc}")

        row = dict(build=name, ptxas=_kernel_report(
            lib.ptxas, f"batch_inv_kernel_k{L.BATCH_INV_PER_THREAD}"))
        for n, x in inputs.items():
            if exact and not torch.equal(L.batch_inv_grid(x, launch), refs[n]):
                raise RuntimeError(f"batch_inv_builds: {name} differs at n={n}")
            row[f"n={n}"] = M.time_ms(lambda: L.batch_inv_grid(x, launch), queued=True)
        rows.append(row)
        print(f"batch_inv build {name} ({row['ptxas']}): "
              + ", ".join(f"{k} {v:.5f} ms" for k, v in row.items() if k.startswith("n=")),
              flush=True)
    return rows


def montmul_chains(dev, gen) -> list:
    """csrc/montmul_chain.cu built with 1, 2 and 4 chains a thread: each
    build's registers and spills, its compiled instructions a product by
    pipe, and its time at k = 32 and 1024 on 2^18 elements (each result
    bit for bit the package's build's; 4099 elements at k = 33, a multiple
    of no chain count, bit for bit the plain chain's)."""
    src = (_build.CSRC / "montmul_chain.cu").read_text()
    piece = f"constexpr int kChains = {MC.CHAINS};"
    if piece not in src:
        raise RuntimeError("montmul_chains: csrc/montmul_chain.cu no longer has its kChains")
    stream = _build.stream_ptr(dev)
    x = _random(CHAIN_N, gen, dev)
    y = torch.empty_like(x)
    refs = {k: MC.mont_mul_chain_kernel(x, k) for k in CHAIN_KS}
    # an n that is a multiple of no chain count: each build's masked tail
    ragged = x[:CHAIN_RAGGED_N]
    ragged_ref = MC.mont_mul_chain_plain(ragged, CHAIN_RAGGED_K)
    rows = []
    for chains in CHAIN_COUNTS:
        lib = _build_variant(f"montmul_chain_c{chains}",
                             src.replace(piece, f"constexpr int kChains = {chains};"))
        fn = lib.montmul_chain_launch
        fn.argtypes, fn.restype = MC.MONTMUL_CHAIN_KERNEL.argtypes, ctypes.c_int

        def call(k, n=CHAIN_N):
            rc = fn(x.data_ptr(), y.data_ptr(), n, k, stream)
            if rc:
                raise RuntimeError(f"montmul_chains: {chains} chains failed to launch: error {rc}")

        call(CHAIN_RAGGED_K, CHAIN_RAGGED_N)
        if not torch.equal(y[:CHAIN_RAGGED_N], ragged_ref):
            raise RuntimeError(f"montmul_chains: {chains} chains differ from the plain chain at "
                               f"n={CHAIN_RAGGED_N}")
        mix = M.sass_mix(lib.path, "montmul_chain_kernel", 33 * chains)
        row = dict(chains=chains, ptxas=M.ptxas_report(lib.ptxas, "montmul_chain_kernel"),
                   sass_ops=mix["ops"], sass_imad=mix["imad"], sass_other=mix["other"])
        for k in CHAIN_KS:
            call(k)
            if not torch.equal(y, refs[k]):
                raise RuntimeError(f"montmul_chains: {chains} chains differ at k={k}")
            row[f"k={k}"] = M.time_ms(lambda: call(k), **(dict(reps=5, runs=3) if k > 32 else {}))
        rows.append(row)
        print(f"montmul_chain {chains} chains a thread ({row['ptxas']}; SASS a product "
              f"{mix['ops']:.2f}: {mix['imad']:.2f} IMAD, {mix['other']:.2f} other): "
              + ", ".join(f"{k} {row[f'k={k}']:.4f} ms" for k in CHAIN_KS), flush=True)
    return rows


def variant_d_builds(dev, gen) -> list:
    """The stage-variant probe's d (ops/ntt_variants.py) at 1024 transforms
    of 1024 points, built streaming each tile in 1, 2 or 4 slices at most
    (kMaxSlices: one slice is a whole raw tile a slot, 160 KB of shared
    memory and one block an SM; four, 64 KB and three) and with launch
    bounds that ask for 3 or 4 blocks of 512 threads an SM, with 256, 512
    and 1024 threads a block where the bounds allow (each result bit for
    bit ntt_kernel's)."""
    src = (_build.CSRC / "ntt_variants.cu").read_text()
    piece, bounds_piece = "constexpr int kMaxSlices = 4;", "__launch_bounds__(1024) ntt_variant_d("
    if piece not in src or bounds_piece not in src:
        raise RuntimeError("variant_d_builds: csrc/ntt_variants.cu no longer has d's kMaxSlices "
                           "or launch bounds")
    n = c = 1024
    x = _random(n * c, gen, dev).reshape(n, c, L.NLIMB)
    root = Field().primitive_nth_root(n).value
    ref = N.ntt_kernel(x, root)
    (p,) = N.kernel_passes(n, c, root)
    tw = V.variant_table("d", root, n, str(dev))
    y = torch.empty_like(x)
    rows = []
    for slices, bounds in D_BUILDS:
        tag = hashlib.sha256(f"{slices} {bounds}".encode()).hexdigest()[:8]
        lib = _build_variant(f"ntt_variants_d{tag}",
                             src.replace(piece, f"constexpr int kMaxSlices = {slices};")
                                .replace(bounds_piece, f"__launch_bounds__({bounds}) ntt_variant_d("))
        fn = lib.ntt_variant_d_launch
        fn.argtypes, fn.restype = V.VARIANT_KERNELS["d"].argtypes, ctypes.c_int
        for threads in [t for t in D_THREADS if t <= int(bounds.split(",")[0])]:
            blk = V.variant_block("d", p)._replace(threads=threads)

            def call():
                rc = fn(x.data_ptr(), y.data_ptr(), tw.data_ptr(), n.bit_length() - 1, *p.grid,
                        *p.ins, *p.outs, blk.dim, blk.log2_count, threads, int(blk.in_tmajor),
                        int(blk.out_tmajor), _build.stream_ptr(dev))
                if rc:
                    raise RuntimeError(f"variant_d_builds: {slices} slices, {threads} threads "
                                       f"failed to launch: error {rc}")

            call()
            if not torch.equal(y, ref):
                raise RuntimeError(f"variant_d_builds: {slices} slices, {threads} threads differ")
            rows.append(dict(slices=slices, bounds=bounds, threads=threads, ms=M.time_ms(call),
                             ptxas=M.ptxas_report(lib.ptxas, "ntt_variant_d")))
            print(f"ntt_variant_d n={n} c={c} slices={slices} bounds ({bounds}) threads={threads} "
                  f"({rows[-1]['ptxas']}): {rows[-1]['ms']:.4f} ms", flush=True)
    return rows


def variant_c_builds(dev, gen) -> list:
    """The stage-variant probe's c at 1024 transforms of 1024 points in
    builds whose launch bounds ask for 2 (as it is: 64 registers), 3 and 4
    blocks of 512 threads an SM (42 and 32 registers): each build's
    registers and spills and its time (each result bit for bit
    ntt_kernel's)."""
    src = (_build.CSRC / "ntt_variants.cu").read_text()
    piece = "__launch_bounds__(1024) ntt_variant_c("
    if piece not in src:
        raise RuntimeError("variant_c_builds: csrc/ntt_variants.cu no longer has c's bounds")
    n = c = 1024
    x = _random(n * c, gen, dev).reshape(n, c, L.NLIMB)
    root = Field().primitive_nth_root(n).value
    ref = N.ntt_kernel(x, root)
    (p,) = N.kernel_passes(n, c, root)
    blk = V.variant_block("c", p)
    tw = V.variant_table("c", root, n, str(dev))
    y = torch.empty_like(x)
    rows = []
    for blocks in C_BLOCKS:
        bounds = "1024" if blocks == 2 else f"{blk.threads}, {blocks}"
        lib = _build_variant(f"ntt_variants_c{blocks}",
                             src.replace(piece, f"__launch_bounds__({bounds}) ntt_variant_c("))
        fn = lib.ntt_variant_c_launch
        fn.argtypes, fn.restype = V.VARIANT_KERNELS["c"].argtypes, ctypes.c_int

        def call():
            rc = fn(x.data_ptr(), y.data_ptr(), tw.data_ptr(), n.bit_length() - 1, *p.grid,
                    *p.ins, *p.outs, blk.dim, blk.log2_count, blk.threads, int(blk.in_tmajor),
                    int(blk.out_tmajor), _build.stream_ptr(dev))
            if rc:
                raise RuntimeError(f"variant_c_builds: bounds {bounds} failed to launch: {rc}")

        call()
        if not torch.equal(y, ref):
            raise RuntimeError(f"variant_c_builds: bounds {bounds} differ")
        rows.append(dict(bounds=bounds, ms=M.time_ms(call),
                         ptxas=M.ptxas_report(lib.ptxas, "ntt_variant_c")))
        print(f"ntt_variant_c n={n} c={c} launch bounds ({bounds}) ({rows[-1]['ptxas']}): "
              f"{rows[-1]['ms']:.4f} ms", flush=True)
    return rows


SECTIONS = {
    "carry_flag": lambda dev, gen: carry_flag(dev),
    "rescue_blocks": rescue_blocks,
    "ntt_tiles": ntt_tiles,
    "ntt_split": ntt_split,
    "node_trees": node_trees,
    "node_builds": node_builds,
    "node_level": node_level,
    "root_inverse": root_inverse,
    "batch_inv_shapes": batch_inv_shapes,
    "batch_inv_builds": batch_inv_builds,
    "montmul_chains": montmul_chains,
    "variant_c_builds": variant_c_builds,
    "variant_d_builds": variant_d_builds,
}


def run(device="cuda", sections=None) -> dict:
    """The named sections (all by default), one after another."""
    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("kernel_shape_probe: needs a CUDA card")
    gen = torch.Generator().manual_seed(17)
    out = {"card": M.card_line()}
    for name in sections or SECTIONS:
        out[name] = SECTIONS[name](dev, gen)
    return out


def main() -> int:
    print(json.dumps(run(sections=sys.argv[1:])))
    return 0


if __name__ == "__main__":
    sys.exit(main())
