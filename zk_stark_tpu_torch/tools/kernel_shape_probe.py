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
  ``csrc/field.cuh`` never lets an addition read a subtraction's flag).

    python -m zk_stark_tpu_torch.tools.kernel_shape_probe

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
from ..ops import limbs as L
from ..ops import ntt as N
from ..ops import rescue_ops as R
from . import measure as M

NTT_SIZES = (1 << 12, 1 << 20, 1 << 24, 1 << 25)
#: (TILE_ELEMS, BLOCK_THREADS) pairs beside the default
TILES = ((1 << 10, 256), (1 << 10, 512), (1 << 11, 256), (1 << 11, 512), (1 << 12, 512),
         (1 << 12, 1024), (1 << 13, 1024))
RESCUE_SIZES = (256, 1 << 14, 1 << 20)
RESCUE_THREADS = (32, 64, 128, 256)

_STAGES = "    stages_shared(sh, reinterpret_cast<const Fe4*>(tw), log2n, 0, count, at);\n"
_LOAD = """        const longlong2 v = *reinterpret_cast<const longlong2*>(
            xb + 8 * (t * in_t + i * in.e) + 2 * (c & 3));"""
_STORE = ("        *reinterpret_cast<longlong2*>(yb + 8 * (t * out_t + i * out.e) + "
          "2 * (c & 3)) = v;")
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


def _build_variant(name: str, source: str) -> ctypes.CDLL:
    """Compile ``source`` (beside copies of the csrc headers) like the
    package's libraries and load it."""
    key = hashlib.sha256(source.encode() + " ".join(_build.NVCC_FLAGS).encode()).hexdigest()[:16]
    work = _build.BUILD / f"probe_{name}_{key}"
    so = work / f"lib{name}.so"
    if not so.exists():
        work.mkdir(parents=True, exist_ok=True)
        for header in _build.CSRC.glob("*.cuh"):
            shutil.copy(header, work / header.name)
        (work / f"{name}.cu").write_text(source)
        subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(work / f"{name}.cu")],
                       check=True, capture_output=True, text=True, timeout=600)
    return ctypes.CDLL(str(so))


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
        "stages_only": src.replace(_LOAD, "        longlong2 v; v.x = c; v.y = t + i;")
                          .replace(_STORE, "        if (tile.extent < 0) " + _STORE.strip()),
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


def run(device="cuda") -> dict:
    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("kernel_shape_probe: needs a CUDA card")
    gen = torch.Generator().manual_seed(17)
    return {"card": M.card_line(), "carry_flag": carry_flag(dev),
            "rescue_blocks": rescue_blocks(dev, gen), "ntt_tiles": ntt_tiles(dev, gen),
            "ntt_split": ntt_split(dev, gen)}


def main() -> int:
    print(json.dumps(run()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
