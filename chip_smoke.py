"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught).  Every
limb call of the paths below runs csrc/limbs.cu; every plain version runs
its own tensor code, and the limb kernels' counts must not move while one
runs (run_plain):

1. the card's name and power limit (nvidia-smi);
2. build the CUDA kernels of zk_stark_tpu_torch/csrc in parallel (with
   each kernel's registers and spills from ptxas);
2b. the kernels' Montgomery product (csrc/field.cuh, through
   csrc/limbs.cu) on the card against Python integers: every pair of
   {0, 1, p-1, p-2} and seeded random pairs;
2c. the limb arithmetic (csrc/limbs.cu: Montgomery product, modular add,
   subtraction, REDC) at 1, 31, 257 and 4097 elements (partial last tiles)
   and 4096, 2^20 and 2^25, in seven operand layouts (full, against one
   element, [r, 1] x [1, c], strided slices, four unmergeable dimensions,
   limbs stored transposed and a view that starts mid-element: the two
   copies), every pair of {0, 1, p-1, p-2, R mod p} leading the inputs, bit
   for bit against the plain versions; at the last three sizes times
   beside the bytes bound, the plain
   version's at 2^25, the host time of a call against the tensor code's,
   and one profiled call of each op (one launch of its kernel, nothing
   else); then the inversion (mont_inv_fermat: a^(p-2) by a fixed
   addition chain, one thread an element) bit for bit against its plain
   version and Python integers on 0, 1, p-1, p-2, one element and 2^14
   random elements, timed at 1 and 2^14 beside its bound; then the batch
   inversion (csrc/batch_inv.cu: Montgomery's trick inside a block, the
   block's total inverted in place by a binary extended Euclid) at 1, 2,
   7, 8, the sign's 284, 512 and 1024, a block's capacity C and C + 1,
   the chain's 86,657, 2^17 and 2^18, and 2^20 elements, zeros first, in
   the middle and last (and all-zero inputs), bit for bit against
   batch_inv_plain and Python integers, one launch up to C and three
   above and no other limb launch (the limb phase's profile: nothing else
   on the card at 1024 and 2^18), an operand copied once when strided or
   misaligned; each size timed beside its bound;
3. each kernel against its plain PyTorch version on the card, bit for bit,
   with both times (CUDA events, median; the leaf, fold and node also
   queued): first the leaf on one value of every decimal length (against
   hashlib too; its ptxas stack frame must be 0 bytes), at the signature's
   shapes, then at the chain's (the four-step NTT, fused-twiddle mode, at
   2^18 and 2^20 against the flat plain transform, forward and inverse;
   leaf at 2^20), with each NTT pass's block shape; the fold at codeword
   lengths 2, 64, 514, 4096 and 2^20 (a one-element call, partial tiles),
   each also from a view that starts mid-element (copied once, counted),
   timed at the last two; the node kernel asked for one level at 2048 and
   2^19 parents (timed) and 1000 (its last block partly full);
3b. the node kernel's trees (tree_kernel) of 1, 2, 4, ..., 2^12 and 2^20
   leaves, every level bit for bit against the per-level plain loop, a
   random 2^12-leaf tree's layers against the host MerkleTree (hashlib);
   each tree's launches and queued time beside the sum of its levels each
   launched alone, and its bound;
4. the fixture-config signature with the deterministic rng: its sha256
   equals tests/fixtures/meta.json's, it verifies, tampered copies fail;
5. the RPSSS path: keygen -> sign -> verify at the default config
   (expansion 4, 64 checks, security 128), cold and then warm, with every
   kernel's launch count reset just before the warm sign and read just
   after it (the segments' graph replays count the launches they make;
   every kernel launched, but the elementwise inversion not at all, and
   the batch inversion once a call of batch_inv, whose sizes the cold
   sign recorded);
   the proof is 1,156,888 bytes, verifies, and a wrong document is
   rejected; the capture time and graph pool of each segment the cold
   sign and verify captured, the Python kernel calls and replays of the
   warm sign and verify (at most MAX_SIGN_CALLS calls beside the
   replays); then one more sign and verify under torch.profiler (stage
   host times, device busy time and idle share, device time by kernel,
   the kernels inside graph replays included, and how many of the
   counted launches the profiler saw; the node and fold kernels' device
   time beside the bound of the trees and folds the sign made);
6. the chain fixture (tests/fixtures/chain_meta.json, FRI 2^14) reproduced
   byte for byte on the card; it verifies and a wrong output is rejected;
7. the chain path: the Rescue-permutation chain of length 3200 (FRI 2^20):
   host trace, one cold prove, one warm prove with every kernel's launch
   count reset just before and read just after (and two more warm proves
   for the median time; the batch inversion three times a call of
   batch_inv, the elementwise inversion not at all), one cold verify (it
   captures the verifier's segments) and one warm, one verify against a
   wrong output that must be rejected; the proof is 3,430,752 bytes; the
   segments the cold prove captured and the warm prove's Python kernel
   calls and replays; then one more warm prove under torch.profiler;
7a. the segments: a default-config sign through replayed segments equals
   byte for byte the sign from the same rng with every segment's body
   called directly on the card; two signs of other documents interleaved
   with their verifies (each true, a wrong document rejected); phases 4
   and 6 again, now replaying (no new capture); then the caches cleared;
7d. (run right after 7a) the distributed engine (zk_stark_tpu_torch/parallel) over NCCL at
   world size 1 (a FileStore in a temporary directory): DistEngine ntt,
   intt, batch_inv, fold_round, combine and move on blocks bit for bit
   against the same rows of the single engine at 512, 4096 and 2^20 (a
   transform three all-to-alls), ntt_dist / intt_dist at the same sizes
   (one all-to-all each); both fixtures through the engine; the
   default-config sign and the chain prove at 3200 byte for byte against
   the single engine's from the same rng, each verified by the engine-free
   verifier; the warm distributed sign and chain prove with the launch
   counts, the Python kernel calls and the collectives (by kind, with the
   bytes they handed the rank and their largest result) reset just before
   and read just after (every kernel of the path launched, the elementwise
   inversion not at all, two segments replayed with their NCCL
   collectives inside, the collectives counted at every replay), beside
   the single engine's warm times and the card's name and power limit;
   then the group destroyed and the caches cleared;
7b. the long transforms: ntt_mont and intt_mont at 2^21, 2^22, 2^24 (the
   four-step) and 2^25 (the three-pass split), then one low-degree
   extension (fast_coset_evaluate: 2^23 coefficients on a 2^25-point
   coset), with the counts reset just before and read just after (exactly
   the passes kernel_passes plans); each size bit for bit against
   ntt_passes_plain with both roots, 2^25 also against the flat ntt_plain
   and, as a batch of two columns, against each column alone; the round
   trip returning the input; the extension at 4 coset points against
   evaluate_many (no NTT); times, bounds, peak device memory; the ntt
   kernel's registers and spills and each pass's block shape;
7c. the NTT stage-variant probe (tools/ntt_variant_probe.py) at 1024 x
   1024 natural rows: kernels a (ntt.cu's ntt_stages_kernel itself, its
   launches on the ntt kernel's count), b, c and d bit for bit against
   the plain transform of each column and ntt_kernel, each timed beside
   its bound, launches counted over the probe's run;
8. the hash-rate yardsticks: the chained Montgomery product (n = 2^18,
   k = 32, the JAX bench's calibration; also an n that is a multiple of
   no chain count, at k = 33) and the bare BLAKE2b compression (2^18
   messages: the bench's digest-twice message, and random words with
   random byte counts), each bit for bit against its plain version, the
   compressions on 64 samples against hashlib; each entry point driven
   with the counts reset just before and read just after; x^(k+1) checked
   at k = 32 and 1024; the time per product (k = 32 and 1024) and per
   compression (and, as a diagnostic, the compiled instructions per
   product from the SASS, split into multiply-adds and the rest, and the
   chain kernel's registers and spills);
9. the batched Rescue-Prime hash (RescuePrime.hash_batch_device, the JAX
   package's entry() workload) at 256 (entry()'s inputs), 2^14 and 2^20
   random inputs, launches counted; the kernel bit for bit against the
   plain version at 256 and 2^14, the host hash on all 256 and on 68
   sampled inputs at 2^20, hash(1) against the test vector; times, hashes
   per second and both ceilings (products of the kernel's exponent chains
   x measured time per product; the instructions counted from field.cuh's
   product, mont_mul_ops, and the additions, over the issue rate); the
   kernel's registers and spills and its launch plan at each size;
11. (run after 9, before 10) the arbitrary-domain toolkit and the Rescue
   widths: (a) with every count reset just before and read just after,
   evaluate_tree (ops/multipoint.py) at k = n = 4096 and 2^14 on random
   domains against host Horner on 64 sampled points, the interpolate ->
   evaluate round trip at full k, at 4096 the tree against evaluate_many
   and fast_evaluate_domain, fast_zerofier at 4096 monic, of degree 4096
   and zero on its domain (evaluate_many), fast_interpolate_domain at 2048
   (its tree branch) against host Lagrange (Polynomial.interpolate_domain,
   timed once); the launches of rows 1, 1b, X and I > 0 and of the leaf, node,
   fold and three-pass kernels 0; then evaluate_tree, interpolate_tree and
   evaluate_many at 4096 and 2^14 and interpolate_tree at 2048, each's
   launches in one call, peak device memory and time (CUDA events,
   median); (b) RescuePrime(m=3) and (m=4) hash_batch_device at 256, 2^14
   and 2^20 as phase 9 runs m = 2, m = 5 to 8 at 256 and 2^14 (the kernel
   bit for bit against permutation_plain at both), with each
   instantiation's registers and spills; (c) the FFT tier (ops/fft.py): the golden vector by fft and dft,
   and a 2^12-point random signal against numpy.fft within FFT_ATOL; (d) a
   warm default-config sign under a StageTimer (its report) and one verify
   inside device_trace (its Chrome trace holds the card's kernels); the
   rescue row of the kernel table gains by_width;
10. the numbers, the card line, the kernel table as one JSON line, and last
   the result line {"ok": true, "device": {...}}.

Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import contextlib
import gc
import hashlib
import json
import pathlib
import re
import shutil
import statistics
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

from zk_stark_tpu_torch import segments  # noqa: E402
from zk_stark_tpu_torch.carry import DetRng, chain_from_config, rpsss_from_config  # noqa: E402
from zk_stark_tpu_torch.field import Field  # noqa: E402
from zk_stark_tpu_torch.fri import FRI  # noqa: E402
from zk_stark_tpu_torch.merkle import MerkleTree  # noqa: E402
from zk_stark_tpu_torch.poly import Polynomial  # noqa: E402
from zk_stark_tpu_torch.models.rescue_chain import make_chain_stark  # noqa: E402
from zk_stark_tpu_torch.models.rescue_prime import RescuePrime  # noqa: E402
from zk_stark_tpu_torch.models.rpsss import RPSSS  # noqa: E402
from zk_stark_tpu_torch.proof_stream import ProofStream  # noqa: E402
from zk_stark_tpu_torch.stark import Stark, VerificationError  # noqa: E402
from zk_stark_tpu_torch.ops import _build  # noqa: E402
from zk_stark_tpu_torch.ops import blake2b as B  # noqa: E402
from zk_stark_tpu_torch.ops import fft as FFT  # noqa: E402
from zk_stark_tpu_torch.ops import fold as FO  # noqa: E402
from zk_stark_tpu_torch.ops import limbs as L  # noqa: E402
from zk_stark_tpu_torch.ops import montmul_chain as MC  # noqa: E402
from zk_stark_tpu_torch.ops import multipoint as M  # noqa: E402
from zk_stark_tpu_torch.ops import ntt as N  # noqa: E402
from zk_stark_tpu_torch.ops import ntt_variants as NV  # noqa: E402
from zk_stark_tpu_torch.ops import poly_ops as PO  # noqa: E402
from zk_stark_tpu_torch.ops import rescue_ops as R  # noqa: E402
from zk_stark_tpu_torch.parallel import collectives, multihost  # noqa: E402
from zk_stark_tpu_torch.parallel import dryrun as DR  # noqa: E402
from zk_stark_tpu_torch.parallel.engine import DEFAULT, dist_engine  # noqa: E402
from zk_stark_tpu_torch.tools import ntt_variant_probe  # noqa: E402
from zk_stark_tpu_torch.utils.profiling import StageTimer, device_trace  # noqa: E402
from zk_stark_tpu_torch.tools.measure import (  # noqa: E402
    ADD_SUB_OPS,
    HBM_BYTES_PER_S,
    MONT_MUL_OPS,
    bound_ms,
    card_line,
    int32_ops_per_s,
    ntt_bound,
    ptxas_report,
    sass_mix,
    time_ms,
)


#: 32-bit integer instructions per BLAKE2b compression (96 G mixes of 6
#: 64-bit adds, 4 xors and 4 rotates, 2 instructions each, plus
#: finalisation); products and additions: tools/measure.py
COMPRESS_OPS = 96 * 28 + 16
#: a leaf's compression: its message words 5-15 are zero, so 11 of the 16
#: words' 12 additions each (2 instructions) fold away
LEAF_COMPRESS_OPS = COMPRESS_OPS - 11 * 12 * 2
#: a leaf's decimal string (csrc/blake2b.cu decimal_message): 10 divisions
#: of 64 by 32 bits as multiply-highs (~8 each), 5 groups of 8 digits (~21
#: each), the digit count (~15) and the byte shift (~60)
DECIMAL_OPS = 10 * 8 + 5 * 21 + 15 + 60
#: the trees of phase 3b: 1, 2, 4, ..., 2^12 leaves (a sign's) and 2^20 (the
#: chain's codewords)
TREE_SIZES_LOG2 = 12
TREE_BIG = 1 << 20
#: the fold's codeword lengths in phase 3: a one-element call, partial
#: tiles, a sign's and the chain's; the last two timed
FOLD_SIZES = (2, 64, 514, 4096, 1 << 20)
FOLD_TIMED = (4096, 1 << 20)
#: the node kernel asked for one level: a sign's widest level, the chain's,
#: and one whose last block is partly full (checked, not timed)
NODE_LEVEL_PARENTS = (2048, 1 << 19, 1000)

MAIN_PROOF_BYTES = 1_156_888
#: the distributed engine's operations against the single engine's: a sign's
#: FRI domain, the default config's, the chain's
DIST_SIZES = (512, 4096, 1 << 20)
#: the chain of BASELINE.md config 5: omicron domain 2^18, FRI domain 2^20;
#: the JAX package's proof length for it (CHAIN_FULL_r04.json)
CHAIN_LENGTH = 3200
CHAIN_PROOF_BYTES = 3_430_752

#: the chained-product and compression yardsticks at the JAX bench's sizes
#: (bench.py:162, 199, 249)
CHAIN_N, CHAIN_K = 1 << 18, 32
#: a chain long enough that launch and ramp do not count: the sustained rate
CHAIN_K_LONG = 1024
#: an n that is a multiple of no chain count a thread (its last group
#: masked) and has more groups than the card holds threads at once (the
#: threads stride), checked at a k that runs the body's tail
CHAIN_RAGGED_N, CHAIN_RAGGED_K = (1 << 18) + (1 << 16) + 1, 33
COMPRESS_N = 1 << 18
#: random pairs of the product check (besides the 16 edge pairs)
PRODUCT_PAIRS = 1 << 14
#: entry()'s batch, bench_rescue_batch's, and the leaf count of a chain-3200
#: codeword
RESCUE_SIZES = (256, 1 << 14, 1 << 20)
RESCUE_HASH_1 = 244180265933090377212304188905974087294  # tests/test_rescue.py
#: the long-NTT phase's sizes: the JAX bench's sweep (bench.py
#: bench_ntt_sweep, 2^21 and 2^22: four-step here), the four-step's largest,
#: and one beyond it (the three-pass split)
LONG_NTT_SIZES = (1 << 21, 1 << 22, 1 << 24, 1 << 25)
#: the low-degree extension of a 2^23-row trace column at expansion 4
LDE_COEFFS, LDE_POINTS = 1 << 23, 1 << 25

#: the limb phase: element counts (a small call, the chain's codeword, the
#: long transforms' size), the operand layouts of limb_operands (REDC, unary,
#: takes those of one operand), and the values of which every pair is held
LIMB_SIZES = (1 << 12, 1 << 20, 1 << 25)
LIMB_LAYOUTS = ("full", "scalar", "outer", "slice", "permuted", "transposed", "misaligned")
UNARY_LAYOUTS = ("full", "slice", "permuted", "transposed", "misaligned")
#: the layouts whose first operand kernel_plan copies (once a call)
COPIED_LAYOUTS = ("transposed", "misaligned")
#: element counts that leave a partial last tile (checked, not timed)
LIMB_TAIL_SIZES = (1, 31, 257, 4097)
LIMB_EDGES = (0, 1, L.P - 1, L.P - 2, L.R_INT)
#: unsynchronised calls timed on the host clock for the host cost of a call
HOST_CALLS = 1000
#: the elementwise inversion's element counts: one element and a batch
#: that fills 16,384 threads
INV_SIZES = (1, 1 << 14)
#: the sizes of batch_inv's calls on the paths: a warm default-config sign
#: (two each: the trace interpolation's, the boundary and the transition
#: quotients' divisions) and a chain prove at length 3200 (the same three
#: sites); the cold sign and prove record them and the phases check them
SIGN_BATCH_INV_SIZES = (284, 284, 512, 512, 1024, 1024)
CHAIN_BATCH_INV_SIZES = (86_657, 86_657, 1 << 17, 1 << 17, 1 << 18, 1 << 18)
#: the batch inversion's sizes in phase 2c besides a block's capacity C and
#: C + 1: either side of the JAX package's elementwise limit (8), the
#: paths', and 2^20
BATCH_INV_SIZES = (1, 2, 7, 8, 284, 512, 1024, 86_657, 1 << 17, 1 << 18, 1 << 20)
#: its headline size: a sign's largest call
BATCH_INV_HEAD = 1024
#: products of csrc/limbs.cu inv_fermat's addition chain: 132 squarings
#: and 24 products
INV_PRODUCTS = 132 + 24
#: most Python kernel calls a warm sign may make beside its segments'
#: replays (the commitment and FRI trees, the folds, one REDC)
MAX_SIGN_CALLS = 60
#: phase 11's trees: the JAX package's evaluation threshold and four times
#: it (TREE_INTERP_MIN, the interpolation threshold, is timed as well); the
#: values of an evaluation held against host Horner; the order of the root
#: handed to the toolkit (any above the domains)
TREE_SIZES = (PO.TREE_EVAL_MIN, 1 << 14)
TREE_SAMPLES = 64
TOOLKIT_ROOT_ORDER = 1 << 20
#: the Rescue state widths phase 11 adds to phase 9's m = 2 (capacity 1),
#: at every RESCUE_SIZES; the kernel's other instantiations, held against
#: the plain version at the first two sizes only
RESCUE_WIDTHS = (3, 4)
RESCUE_CHECK_WIDTHS = (5, 6, 7, 8)
#: the FFT's golden vector (tests/test_fft.py), its random signal's length,
#: and the tolerance against numpy.fft (complex64: float32 sums of 4096
#: terms of unit size, against numpy's float64)
FFT_SIGNAL = [1.0, 1.0, 1.0, 1.0, 0.0, 0.0, 0.0, 0.0]
FFT_GOLDEN = [(4.0, 0.0), (1.0, -2.414), (0.0, 0.0), (1.0, -0.414), (0.0, 0.0), (1.0, 0.414),
              (0.0, 0.0), (1.0, 2.414)]
FFT_N = 1 << 12
FFT_ATOL = 1e-2
#: the prover's stages under a StageTimer (the JAX package's names)
PROVE_STAGES = {"host_inputs", "segment1", "commit_roots", "segment2", "fri_prove", "openings",
                "serialize"}
#: the device names of the kernels a proof launches (csrc/*.cu)
PORT_KERNEL_NAMES = ("limbs_", "ntt_stages_kernel", "fold_kernel", "leaf_kernel", "node_kernel",
                     "batch_inv_")


def require(cond, message: str) -> None:
    """A check of a phase; raises (unlike assert, it survives python -O)."""
    if not cond:
        raise RuntimeError(message)


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    if a.numel() == 0:  # a layout with no element at a tail size
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def random_mont(n: int, gen: torch.Generator, dev) -> torch.Tensor:
    """n random field elements as [n, 8] limbs on ``dev``: the top limb
    below p's keeps each value below p (a valid canonical or Montgomery
    value)."""
    limbs = torch.randint(0, 1 << 16, (n, L.NLIMB), dtype=L.DTYPE, generator=gen)
    limbs[:, -1] %= L.P_LIMBS[-1]
    return limbs.to(dev)


def edge_pairs() -> tuple[list[int], list[int]]:
    """Every ordered pair of LIMB_EDGES: (first operands, second operands)."""
    return ([x for x in LIMB_EDGES for _ in LIMB_EDGES],
            [y for _ in LIMB_EDGES for y in LIMB_EDGES])


def limb_operands(layout: str, a: torch.Tensor, b: torch.Tensor, rows: int):
    """The operands of a limb call in ``layout``, from a and b [n, 8]:
    "full" a against b; "scalar" a against the single element b[2] (b[0]
    for n = 1);
    "outer" a[:rows] as [rows, 1, 8] against b[:n / rows] as [1, n / rows, 8];
    "slice" the even against the odd rows of a and b interleaved;
    "permuted" the first 8 (n // 8) of a and b as [2, 2, 2, n // 8] with
    their first three dimensions permuted apart (four dimensions that do
    not merge); "transposed" a with its limbs stored transposed (limb
    stride n) against b; and "misaligned" a as a view that starts 8 bytes
    into its buffer (mid-element for the kernel's 16-byte vectors) against
    b.  The kernel wrapper copies a in the last two.  A unary call takes
    the first."""
    n = a.shape[0]
    if layout == "full":
        return a, b
    if layout == "scalar":
        return a, b[min(2, n - 1)]
    if layout == "outer":
        return a[:rows].unsqueeze(1), b[: n // rows].unsqueeze(0)
    if layout == "slice":
        s = torch.stack([a, b], dim=1).reshape(2 * n, L.NLIMB)
        return s[0::2], s[1::2]
    if layout == "permuted":
        m = n // 8
        cube = (2, 2, 2, m, L.NLIMB)
        return (a[:8 * m].reshape(cube).permute(2, 1, 0, 3, 4),
                b[:8 * m].reshape(cube).permute(1, 0, 2, 3, 4))
    if layout == "transposed":
        return a.t().contiguous().t(), b
    if layout == "misaligned":
        buf = torch.empty(n * L.NLIMB + 1, dtype=a.dtype, device=a.device)
        view = buf[1:].view(n, L.NLIMB)
        view.copy_(a)
        return view, b
    raise ValueError(f"unknown layout {layout}")


def decimal_values() -> list[int]:
    """0, and for every decimal length from 1 to 39 digits its least and
    greatest canonical value (10^(k-1) and 10^k - 1, p - 1 for 39): every
    boundary of the leaf kernel's base-10^8 groups, and of base 10^9."""
    vals = [0]
    for k in range(1, 40):
        vals += [10 ** (k - 1), min(10 ** k - 1, L.P - 1)]
    return vals


def fold_bound(n: int, int_rate: float) -> tuple[float, str]:
    return bound_ms(n * 64 + n // 2 * 64 + 2 * 64 + n * 64,
                    n // 2 * (4 * MONT_MUL_OPS + 3 * ADD_SUB_OPS), int_rate)


def leaf_bound(n: int, int_rate: float) -> tuple[float, str]:
    return bound_ms(n * 64 + n * 64, n * (LEAF_COMPRESS_OPS + DECIMAL_OPS), int_rate)


def node_bound(m: int, int_rate: float) -> tuple[float, str]:
    return bound_ms(2 * m * 64 + m * 64, m * COMPRESS_OPS, int_rate)


def check(name, got, ref) -> int:
    err = max_abs_err(got, ref)
    require(err == 0 and torch.equal(got, ref), f"{name}: kernel differs from its plain version")
    return err


def stack_frame(logs: dict, library: str, kernel: str) -> int | None:
    """The bytes of stack frame ptxas gave ``kernel`` of ``library`` (None if
    the library was built before this run)."""
    if library not in logs:
        return None
    return ptxas_report(logs[library], kernel)["stack_bytes"]


def leaf_digit_phase(dev, logs: dict) -> dict:
    """Phase 3a: the leaf kernel on one value of every decimal length (and
    each length's largest) against hashlib and its plain version, also
    from a view that starts mid-element; its stack frame must be 0 bytes
    (the message stays in registers)."""
    print(f"ptxas {ptxas_line(logs, 'blake2b')}", flush=True)
    frame = stack_frame(logs, "blake2b", "leaf_kernel")
    require(frame in (None, 0), f"leaf_kernel has a {frame}-byte stack frame")
    vals = decimal_values()
    canon = L.from_numpy(L.ints_to_limbs(vals), dev)
    got = B.leaf_kernel(canon)
    err = check(f"leaf on {len(vals)} decimal lengths", got, B.leaf_digests_plain(canon))
    shifted = limb_operands("misaligned", canon, canon, 1)[0]  # copied by the wrapper
    err = max(err, check("leaf on a view that starts mid-element", B.leaf_kernel(shifted), got))
    digests = got.cpu().numpy()
    for v, d in zip(vals, digests):
        require(d.tobytes() == hashlib.blake2b(str(v).encode(), digest_size=64).digest(),
                f"leaf of {v} ({len(str(v))} digits) differs from hashlib")
    print(f"leaf decimal lengths: {len(vals)} values (0, and the least and greatest of every "
          f"length 1-39) equal hashlib and the plain version; leaf_kernel stack frame "
          f"{'not rebuilt' if frame is None else f'{frame} bytes'}", flush=True)
    return {"values": len(vals), "max_abs_err": err, "stack_frame_bytes": frame}


def tree_bound(n: int, int_rate: float) -> tuple[float, str]:
    """A tree of n leaves: node_bound summed over its levels."""
    parts = [node_bound(n >> j, int_rate) for j in range(1, n.bit_length())]
    return sum(ms for ms, _ in parts), parts[0][1] if parts else "operations"


def node_tree_phase(dev, int_rate: float) -> dict:
    """Phase 3b: tree_kernel on trees of 1, 2, 4, ..., 2^12 and 2^20 leaves
    (depths a multiple of TREE_LEVELS and not), every level bit for bit
    against the per-level plain loop (tree_plain), a random 2^12-leaf
    tree's layers against hashlib (the host MerkleTree); for each tree its
    launches, its device time (queued) beside the sum of its levels each
    hashed by its own launch (node_kernel one level at a time: the parent
    design's loop), and its bound."""
    gen = torch.Generator().manual_seed(1236)
    trees = {}
    for n in [1 << j for j in range(TREE_SIZES_LOG2 + 1)] + [TREE_BIG]:
        vals = L.mont_to_ints(random_mont(n, gen, "cpu")) if n == 1 << TREE_SIZES_LOG2 else None
        canon = (L.from_numpy(L.ints_to_limbs(vals), dev) if vals is not None
                 else random_mont(n, gen, dev))
        leaves = B.leaf_kernel(canon)
        launches0 = B.NODE_KERNEL.launches
        inner = B.tree_kernel(leaves)
        torch.cuda.synchronize()
        launches = B.NODE_KERNEL.launches - launches0
        require(launches == len(B.tree_launches(n)),
                f"tree of {n} leaves: {launches} launches, planned {len(B.tree_launches(n))}")
        plain, p_ms = timed_once(lambda: B.tree_plain(leaves))
        err = check(f"tree of {n} leaves", inner, plain)
        if vals is not None:
            layers = [[bytes(row) for row in lvl.cpu().numpy()]
                      for lvl in B.split_levels(leaves, inner)]
            require(layers == MerkleTree.from_ints([int(v) for v in vals]).layers,
                    f"tree of {n} leaves differs from the host MerkleTree (hashlib)")
        q_ms = time_ms(lambda: B.tree_kernel(leaves), queued=True)
        level_ms = []
        for lvl in B.split_levels(leaves, inner)[:-1]:
            level_ms.append(time_ms(lambda: B.node_kernel(lvl), queued=True))
        bound = tree_bound(n, int_rate)
        trees[n] = dict(launches=launches, ms=q_ms, per_level_ms=sum(level_ms),
                        per_level_launches=len(level_ms), plain_ms=p_ms, bound_ms=bound[0],
                        bound_by=bound[1], max_abs_err=err,
                        plan=[k for _, k in B.tree_launches(n)])
        print(f"node tree of {n} leaves: bit-exact against the per-level plain loop"
              f"{' and the host MerkleTree (hashlib)' if vals is not None else ''}; "
              f"{launches} launches (levels {trees[n]['plan']}), {q_ms:.5f} ms queued; one launch "
              f"a level: {len(level_ms)} launches, {sum(level_ms):.5f} ms; plain {p_ms:.3f} ms; "
              f"bound {bound[0]:.6f} ms ({bound[1]})", flush=True)
    return trees


def compare_kernels(dev, int_rate: float, logs: dict | None = None) -> dict:
    """Phase 3: each kernel against its plain version at the RPSSS path's
    shapes and at the chain's.  Returns one row per kernel (mode), each
    with its times at every size in ``by_size``, its largest size as the
    headline and its launches in this phase (the paths' launches are filled
    in later)."""
    gen = torch.Generator().manual_seed(1234)
    F = Field()
    rows = {}
    own = [N.NTT_KERNEL, N.NTT_TW_KERNEL, FO.FOLD_KERNEL, B.LEAF_KERNEL, B.NODE_KERNEL]
    launches0 = {k.name: k.launches for k in own}
    digits = leaf_digit_phase(dev, logs or {})

    def record(name, kernel, size, err, k_ms, p_ms, bound, queued_ms=None):
        row = rows.setdefault(name, dict(kernel=kernel, max_abs_err=0, by_size={}))
        row.update(shape=size, max_abs_err=max(row["max_abs_err"], err), ms=k_ms,
                   plain_ms=p_ms, bound_ms=bound[0], bound_by=bound[1])
        row["by_size"][size] = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": bound[0],
                                "bound_by": bound[1]}
        if queued_ms is not None:
            row["by_size"][size]["queued_ms"] = queued_ms
        print(f"{name} {size}: bit-exact, kernel {k_ms:.4f} ms"
              f"{'' if queued_ms is None else f' ({queued_ms:.4f} queued)'}, plain {p_ms:.3f} ms, "
              f"bound {bound[0]:.6f} ms ({bound[1]})", flush=True)

    # the single-block mode (RPSSS sizes), then the four-step with the
    # fused-twiddle first pass (chain sizes), both against the flat plain
    # transform, forward and inverse root
    for n in (512, 1024, 4096, 1 << 18, 1 << 20):
        x = random_mont(n, gen, dev)
        root = F.primitive_nth_root(n).value
        inv_root = pow(root, -1, L.P)
        four_step = n > N.MAX_KERNEL_N
        err = check(f"ntt n={n}", N.ntt_kernel(x, root), run_plain(N.ntt_plain, x, root))
        err += check(f"intt n={n}", N.ntt_kernel(x, inv_root),
                     run_plain(N.ntt_plain, x, inv_root))
        if four_step:
            err += check(f"four-step plain n={n}", run_plain(N.ntt_passes_plain, x, root),
                         run_plain(N.ntt_plain, x, root))
        k_ms = time_ms(lambda: N.ntt_kernel(x, root))
        p_ms = time_ms(lambda: run_plain(N.ntt_plain, x, root), reps=2 if four_step else 3,
                       runs=3)
        name, kernel = ("ntt_four_step", N.NTT_TW_KERNEL) if four_step else ("ntt", N.NTT_KERNEL)
        record(name, kernel, f"n={n}", err, k_ms, p_ms, ntt_bound(n, int_rate))
        print(f"ntt n={n} plan: {plan_text(n, 1)}", flush=True)

    for n in FOLD_SIZES:
        cw = random_mont(n, gen, dev)
        invpows = random_mont(n // 2, gen, dev)
        ao = L.int_to_mont(987654321987654321 % L.P, dev)
        ti = L.int_to_mont(pow(2, -1, L.P), dev)
        kf, kc = FO.fold_kernel(cw, invpows, ao, ti)
        pf, pc = run_plain(FO.fold_plain, cw, invpows, ao, ti)
        err = max(check(f"fold n={n} folded", kf, pf), check(f"fold n={n} canon", kc, pc))
        # a codeword that starts mid-element: copied by the wrapper, counted
        shifted = limb_operands("misaligned", cw, cw, 1)[0]
        copies = L.copies
        sf, sc = FO.fold_kernel(shifted, invpows, ao, ti)
        require(L.copies - copies == 1, f"fold n={n}: {L.copies - copies} copies of a "
                                        "codeword that starts mid-element")
        err = max(err, check(f"fold n={n} from a view that starts mid-element", sf, pf),
                  check(f"fold n={n} canon from the view", sc, pc))
        if n not in FOLD_TIMED:
            print(f"fold n={n}: bit-exact (also from a view that starts mid-element)", flush=True)
            continue
        k_ms = time_ms(lambda: FO.fold_kernel(cw, invpows, ao, ti))
        q_ms = time_ms(lambda: FO.fold_kernel(cw, invpows, ao, ti), queued=True)
        p_ms = time_ms(lambda: run_plain(FO.fold_plain, cw, invpows, ao, ti), reps=5, runs=3)
        record("fold", FO.FOLD_KERNEL, f"n={n}", err, k_ms, p_ms, fold_bound(n, int_rate), q_ms)

    for n in (4096, 1 << 20):
        canon = L.from_mont(random_mont(n, gen, dev))
        err = check(f"leaf n={n}", B.leaf_kernel(canon), B.leaf_digests_plain(canon))
        k_ms = time_ms(lambda: B.leaf_kernel(canon))
        q_ms = time_ms(lambda: B.leaf_kernel(canon), queued=True)
        p_ms = time_ms(lambda: B.leaf_digests_plain(canon), reps=3, runs=3)
        record("leaf", B.LEAF_KERNEL, f"n={n}", err, k_ms, p_ms, leaf_bound(n, int_rate), q_ms)

    # the node kernel asked for one level (blocks of 2^LEVEL_SPAN_LOG2
    # children), at the widest levels of a sign's and a chain's trees
    for m in NODE_LEVEL_PARENTS:
        level = B.leaf_kernel(L.from_mont(random_mont(2 * m, gen, dev)))
        err = check(f"node parents={m}", B.node_kernel(level), B.node_digests_plain(level))
        if m % (1 << (B.LEVEL_SPAN_LOG2 - 1)):
            print(f"node parents={m}: bit-exact (last block partly full)", flush=True)
            continue
        k_ms = time_ms(lambda: B.node_kernel(level))
        q_ms = time_ms(lambda: B.node_kernel(level), queued=True)
        p_ms = time_ms(lambda: B.node_digests_plain(level), reps=3, runs=3)
        record("node", B.NODE_KERNEL, f"parents={m}", err, k_ms, p_ms, node_bound(m, int_rate),
               q_ms)
    torch.cuda.synchronize()
    trees = node_tree_phase(dev, int_rate)
    for n in (1 << TREE_SIZES_LOG2, TREE_BIG):  # the headline: the chain's tree
        t = trees[n]
        record("node", B.NODE_KERNEL, f"leaves={n}", t["max_abs_err"], t["ms"], t["plain_ms"],
               (t["bound_ms"], t["bound_by"]), t["ms"])
        rows["node"]["by_size"][f"leaves={n}"].update(
            launches=t["launches"], per_level_ms=t["per_level_ms"],
            per_level_launches=t["per_level_launches"], plan=t["plan"])
    rows["node"]["trees"] = {n: {k: v for k, v in t.items() if k != "max_abs_err"}
                             for n, t in trees.items()}
    rows["leaf"]["decimal_lengths"] = digits
    rows["leaf"]["max_abs_err"] = max(rows["leaf"]["max_abs_err"], digits["max_abs_err"])
    rows["ntt"]["source"] = rows["ntt_four_step"]["source"] = "zk_stark_tpu_torch/csrc/ntt.cu"
    rows["fold"]["source"] = "zk_stark_tpu_torch/csrc/fold.cu"
    rows["leaf"]["source"] = rows["node"]["source"] = "zk_stark_tpu_torch/csrc/blake2b.cu"
    for name, k in (("ntt", N.NTT_KERNEL), ("ntt_four_step", N.NTT_TW_KERNEL),
                    ("fold", FO.FOLD_KERNEL), ("leaf", B.LEAF_KERNEL), ("node", B.NODE_KERNEL)):
        rows[name]["launches_own_phase"] = k.launches - launches0[k.name]
    return rows


def fixture_phase(dev) -> None:
    """Phase 4: the pinned fixture signature, reproduced on the card."""
    fixtures = ROOT / "tests" / "fixtures"
    meta = json.loads((fixtures / "meta.json").read_text())
    ref = (fixtures / "signature.bin").read_bytes()
    rpsss = rpsss_from_config(meta["config"], device=dev, rng=DetRng())
    sk, pk = rpsss.keygen()
    require(str(sk) == meta["sk"] and str(pk) == meta["pk"], "fixture keys differ")
    doc = meta["document"].encode()
    sig = rpsss.sign(sk, doc)
    digest = hashlib.sha256(sig).hexdigest()
    require(digest == meta["signature_sha256"], f"fixture sha256 differs: {digest}")
    require(sig == ref, "fixture signature bytes differ")
    require(rpsss.verify(pk, doc, sig), "fixture signature rejected")
    for pos in (17, len(sig) // 2, len(sig) - 3):
        bad = bytearray(sig)
        bad[pos] ^= 0x01
        require(not rpsss.verify(pk, doc, bytes(bad)), f"tamper at {pos} accepted")
    require(not rpsss.verify(pk, doc, sig[:-8]), "truncated signature accepted")
    require(not rpsss.verify(pk, b"other document", sig), "wrong document accepted")
    require(not rpsss.verify((pk + 1) % L.P, doc, sig), "wrong key accepted")
    print(f"fixture: sha256 {digest} reproduced on the card, verifies, "
          "tampered copies rejected", flush=True)


def python_calls() -> int:
    """Calls from Python of every kernel so far (a graph replay makes none)."""
    return sum(k.calls for k in _build.Kernel.instances)


def cached_segments() -> dict:
    """Every cached segment: the prover's and verifier's (Stark) and the
    FRI's last-codeword check's, by (cache, key)."""
    return {**{("stark",) + k: seg for k, seg in Stark._SEG_CACHE.items()},
            **{("fri",) + k: seg for k, seg in FRI._LOWDEG_CACHE.items()}}


def captures_since(before: dict) -> list:
    """The segments captured since ``before`` (cached_segments()): name,
    capture ms and the device memory the capture reserved (its graph's
    pool)."""
    return [{"name": seg.name, "capture_ms": seg.capture_ms, "pool_gb": seg.pool_bytes / 1e9}
            for key, seg in cached_segments().items()
            if key not in before and seg.graph is not None]


@contextlib.contextmanager
def recorded_batch_inv():
    """While active, the element count of every batch_inv call made from
    Python (a cold call's warm-up and capture; a replay makes none)."""
    sizes = []
    batch_inv = L.batch_inv

    def batch_inv_recorded(a):
        sizes.append(a.numel() // L.NLIMB)
        return batch_inv(a)

    L.batch_inv = batch_inv_recorded
    try:
        yield sizes
    finally:
        L.batch_inv = batch_inv


def check_path_launches(path: str, launches: dict, batch_inv_sizes, may_skip=()) -> None:
    """Every kernel of a path launched but those named in ``may_skip``, the
    elementwise inversion not at all (batch_inv has its own kernel), and
    the batch inversion as its calls of ``batch_inv_sizes`` take
    (batch_inv_launches)."""
    for name, count in launches.items():
        if name == L.INV_KERNEL.name:
            require(count == 0, f"kernel {name} was launched {count} times by the {path}")
        elif name not in may_skip:
            require(count > 0, f"kernel {name} was not launched by the {path}")
    want = sum(batch_inv_launches(n) for n in batch_inv_sizes)
    require(launches[L.BATCH_INV_KERNEL.name] == want,
            f"the {path} launched the batch inversion {launches[L.BATCH_INV_KERNEL.name]} times "
            f"({want} expected for calls of {list(batch_inv_sizes)} elements)")


def main_path(dev, kernels) -> tuple[dict, tuple]:
    """Phase 5: default-config keygen -> sign -> verify, cold (capturing the
    configuration's segments) then warm (replaying them)."""
    doc = b"attack at dawn"
    rpsss = RPSSS(Field(), device=dev, rng=DetRng(b"chip-smoke"))
    sk, pk = rpsss.keygen()

    before = cached_segments()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with recorded_batch_inv() as sign_sizes:
        sig_cold = rpsss.sign(sk, doc)
        torch.cuda.synchronize()
    cold_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    with recorded_batch_inv() as verify_sizes:
        ok_cold = rpsss.verify(pk, doc, sig_cold)
        torch.cuda.synchronize()
    verify_cold_ms = (time.perf_counter() - t0) * 1e3
    captures = captures_since(before)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    for k in kernels:
        k.launches = 0
    copies = L.copies
    calls, replays = python_calls(), segments.replays
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sig = rpsss.sign(sk, doc)
    torch.cuda.synchronize()
    sign_ms = (time.perf_counter() - t0) * 1e3
    launches = {k.name: k.launches for k in kernels}
    copies = L.copies - copies
    sign_calls, sign_replays = python_calls() - calls, segments.replays - replays

    calls, replays = python_calls(), segments.replays
    t0 = time.perf_counter()
    ok = rpsss.verify(pk, doc, sig)
    torch.cuda.synchronize()
    verify_ms = (time.perf_counter() - t0) * 1e3
    verify_calls, verify_replays = python_calls() - calls, segments.replays - replays

    require(len(sig_cold) == MAIN_PROOF_BYTES, f"cold proof is {len(sig_cold)} B")
    require(len(sig) == MAIN_PROOF_BYTES, f"proof is {len(sig)} B")
    require(ok_cold and ok, "default-config signature rejected")
    require(not rpsss.verify(pk, b"attack at dusk", sig), "wrong document accepted")
    # the cold sign calls batch_inv at every site (in the segments' warm-up
    # and capture), and for the cached tables it builds
    require(set(SIGN_BATCH_INV_SIZES) <= set(sign_sizes),
            f"the cold sign called batch_inv at {sign_sizes} elements")
    check_path_launches("sign", launches, SIGN_BATCH_INV_SIZES)
    require(sorted(c["name"] for c in captures) == ["lowdeg", "seg1", "seg2", "verify_seg"],
            f"the cold sign and verify captured {[c['name'] for c in captures]}")
    require(sign_replays == 2 and verify_replays == 2,
            f"{sign_replays} replays a warm sign, {verify_replays} a verify (2 each expected)")
    require(sign_calls <= MAX_SIGN_CALLS,
            f"a warm sign made {sign_calls} Python kernel calls (at most {MAX_SIGN_CALLS})")
    result = dict(sign_ms=sign_ms, verify_ms=verify_ms, sign_cold_ms=cold_ms,
                  verify_cold_ms=verify_cold_ms, proof_bytes=len(sig),
                  launches=launches, limb_operand_copies=copies,
                  batch_inv_sizes_sign=list(SIGN_BATCH_INV_SIZES),
                  batch_inv_sizes_cold_sign=sign_sizes,
                  batch_inv_sizes_verify=sorted(set(verify_sizes)),
                  sign_python_kernel_calls=sign_calls, sign_replays=sign_replays,
                  verify_python_kernel_calls=verify_calls, verify_replays=verify_replays,
                  captures=captures, cold_peak_gb=peak_gb)
    print("main path " + json.dumps(result), flush=True)
    return result, (rpsss, sk, pk, doc)


@contextlib.contextmanager
def recorded_shapes():
    """While active, the leaf count of every tree_kernel call and the
    codeword length of every fold_kernel call: a path's shapes, for its
    bounds."""
    shapes = {"tree_leaves": [], "fold_lengths": []}
    tree, fold = B.tree_kernel, FO.fold_kernel

    def tree_recorded(leaves):
        shapes["tree_leaves"].append(int(leaves.shape[0]))
        return tree(leaves)

    def fold_recorded(cw, *args):
        shapes["fold_lengths"].append(int(cw.shape[0]))
        return fold(cw, *args)

    B.tree_kernel, FO.fold_kernel = tree_recorded, fold_recorded
    try:
        yield shapes
    finally:
        B.tree_kernel, FO.fold_kernel = tree, fold


def profiled(fn) -> dict:
    """Run ``fn`` once under torch.profiler: its wall time, the host time of
    the prover's and verifier's record_function spans ("stark.*"), the
    device's busy time (sum of kernel and copy durations; one stream, so no
    overlap) and idle share, the device time by kernel name, and the
    shapes of its trees and folds (recorded_shapes)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    launches0 = [k.launches for k in _build.Kernel.instances]
    replays0 = segments.replays
    torch.cuda.synchronize()
    with recorded_shapes() as shapes, profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    stages, by_kernel = {}, {}
    busy_us = 0.0
    for e in prof.events():
        dur = e.time_range.elapsed_us()
        if e.device_type == DeviceType.CUDA:
            if e.name.startswith("stark."):
                continue  # the device-side copy of a span, not a kernel
            busy_us += dur
            ms, count = by_kernel.get(e.name[:70], (0.0, 0))
            by_kernel[e.name[:70]] = (ms + dur / 1e3, count + 1)
        elif e.name.startswith("stark."):
            stages[e.name] = stages.get(e.name, 0.0) + dur / 1e3
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:10]

    def share(prefix):  # device ms and launches of the kernels named so
        hits = [v for k, v in by_kernel.items() if k.startswith(prefix)]
        return [sum(ms for ms, _ in hits), sum(c for _, c in hits)]

    # the kernels inside graph replays reach the trace only if the profiler
    # attributes them: compare with the launches the counts recorded
    counted = sum(k.launches - c for k, c in zip(_build.Kernel.instances, launches0))
    seen = sum(share(prefix)[1] for prefix in PORT_KERNEL_NAMES)
    replays = segments.replays - replays0
    if seen != counted:
        print(f"profile: the profiler saw {seen} of the {counted} counted launches of the "
              f"port's kernels ({replays} graph replays): the device time by kernel below "
              "misses the rest", flush=True)
    return {
        "kernel_launches_counted": counted,
        "kernel_launches_seen": seen,
        "replays": replays,
        "wall_ms": wall_ms,
        "device_busy_ms": busy_us / 1e3,
        "device_idle_share": 1.0 - busy_us / 1e3 / wall_ms,
        "device_launches": sum(c for _, c in by_kernel.values()),
        # PyTorch's (unvectorised) elementwise kernels, where the limb
        # tensor code ran before the limb kernels, and the limb kernels:
        # [ms, launches]
        "elementwise_kernel": share("void at::native::elementwise_kernel<"),
        "limbs_kernels": share("limbs_"),
        "leaf_kernel": share("leaf_kernel"),
        "node_kernel": share("node_kernel"),
        "fold_kernel": share("fold_kernel"),
        "batch_inv_kernel": share("batch_inv_"),
        "limbs_inv_kernel": share("limbs_inv_kernel"),
        **shapes,
        "stages_host_ms": stages,
        "top_device_ms": {k: [v[0], v[1]] for k, v in top},
    }


def profile_phase(rpsss, sk, pk, doc) -> dict:
    """One more warm sign and verify under torch.profiler."""
    sig = []
    spans = {
        "sign": profiled(lambda: sig.append(rpsss.sign(sk, doc))),
        "verify": profiled(lambda: require(rpsss.verify(pk, doc, sig[0]),
                                           "profiled signature rejected")),
    }
    print(json.dumps({"profile": spans}), flush=True)
    return spans


def rejects(stark, air, boundary, proof: bytes) -> bool:
    """True when the verifier rejects the proof (VerificationError); any
    other exception propagates."""
    try:
        stark.verify(air, boundary, ProofStream.deserialize(proof, stark.field))
    except VerificationError:
        return True
    return False


def chain_fixture_phase(dev) -> None:
    """Phase 6: the chain fixture (made by the JAX package) reproduced on
    the card with the deterministic rng."""
    fixtures = ROOT / "tests" / "fixtures"
    meta = json.loads((fixtures / "chain_meta.json").read_text())
    ref = (fixtures / "chain_proof.bin").read_bytes()
    model, stark = chain_from_config(meta["config"], device=dev,
                                     rng=DetRng(meta["rng_tag"].encode()))
    require(stark.fri.domain_length == meta["fri_domain_length"], "chain fixture FRI domain")
    air = model.air(stark.omicron, stark.omicron_domain_length)
    trace = model.trace(int(meta["input"]))
    y = trace[-1][0]
    require(str(y) == meta["output"], "chain fixture output differs")
    boundary = model.boundary_constraints(y)
    proof = stark.prove(trace, air, boundary, ProofStream(stark.field))
    digest = hashlib.sha256(proof).hexdigest()
    require(digest == meta["proof_sha256"] and proof == ref,
            f"chain fixture proof differs: sha256 {digest}")
    require(not rejects(stark, air, boundary, proof), "chain fixture proof rejected")
    require(rejects(stark, air, model.boundary_constraints(y + 1), proof),
            "chain fixture: wrong output accepted")
    print(f"chain fixture: sha256 {digest} ({len(proof)} B, FRI {stark.fri.domain_length}) "
          "reproduced on the card, verifies, wrong output rejected", flush=True)


def chain_path(dev, kernels) -> dict:
    """Phase 7: the chain of length 3200 (FRI 2^20), trace -> cold prove ->
    warm prove (launches counted) -> verify -> wrong output rejected ->
    one profiled warm prove."""
    model, stark = make_chain_stark(Field(), CHAIN_LENGTH, device=dev,
                                    rng=DetRng(b"chip-smoke-chain"))
    require(stark.omicron_domain_length == 1 << 18 and stark.fri.domain_length == 1 << 20,
            "chain geometry is not omicron 2^18 / FRI 2^20")
    air = model.air(stark.omicron, stark.omicron_domain_length)

    t0 = time.perf_counter()
    trace = model.trace(0x5EED)
    trace_ms = (time.perf_counter() - t0) * 1e3
    y = trace[-1][0]
    boundary = model.boundary_constraints(y)

    def prove():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        proof = stark.prove(trace, air, boundary, ProofStream(stark.field))
        torch.cuda.synchronize()
        return proof, (time.perf_counter() - t0) * 1e3

    before = cached_segments()
    torch.cuda.reset_peak_memory_stats()
    with recorded_batch_inv() as cold_sizes:
        proof_cold, cold_ms = prove()
    cold_captures = captures_since(before)
    for k in kernels:
        k.launches = 0
    copies = L.copies
    calls, replays = python_calls(), segments.replays
    proof, warm_ms = prove()
    launches = {k.name: k.launches for k in kernels}
    copies = L.copies - copies
    prove_calls, prove_replays = python_calls() - calls, segments.replays - replays
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # two more warm proves: host time on a shared machine spreads
    warm_runs = [warm_ms] + [prove()[1] for _ in range(2)]

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ok = not rejects(stark, air, boundary, proof)
    torch.cuda.synchronize()
    verify_cold_ms = (time.perf_counter() - t0) * 1e3  # it captures the verifier's segments
    verify_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    t0 = time.perf_counter()
    ok = ok and not rejects(stark, air, boundary, proof)
    torch.cuda.synchronize()
    verify_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    wrong_rejected = rejects(stark, air, model.boundary_constraints(y + 1), proof)
    torch.cuda.synchronize()
    verify_wrong_ms = (time.perf_counter() - t0) * 1e3

    require(len(proof_cold) == CHAIN_PROOF_BYTES, f"cold chain proof is {len(proof_cold)} B")
    require(len(proof) == CHAIN_PROOF_BYTES, f"chain proof is {len(proof)} B")
    require(ok, "chain proof rejected")
    require(wrong_rejected, "chain proof accepted for a wrong output")
    require(set(CHAIN_BATCH_INV_SIZES) <= set(cold_sizes),
            f"the cold chain prove called batch_inv at {cold_sizes} elements")
    check_path_launches("chain prove", launches, CHAIN_BATCH_INV_SIZES)
    require(sorted(c["name"] for c in cold_captures) == ["seg1", "seg2"] and prove_replays == 2,
            f"the cold chain prove captured {[c['name'] for c in cold_captures]}, the warm one "
            f"replayed {prove_replays} segments")
    result = dict(chain_length=CHAIN_LENGTH, fri_domain_length=stark.fri.domain_length,
                  trace_host_ms=trace_ms, prove_cold_ms=cold_ms,
                  prove_ms=statistics.median(warm_runs), prove_ms_runs=warm_runs,
                  verify_cold_ms=verify_cold_ms, verify_ms=verify_ms,
                  verify_wrong_output_ms=verify_wrong_ms,
                  proof_bytes=len(proof), prove_peak_gb=peak_gb,
                  batch_inv_sizes=list(CHAIN_BATCH_INV_SIZES), batch_inv_sizes_cold=cold_sizes,
                  verify_peak_gb=verify_peak_gb, launches=launches,
                  limb_operand_copies=copies, prove_python_kernel_calls=prove_calls,
                  prove_replays=prove_replays, captures=captures_since(before))
    print("chain path " + json.dumps(result), flush=True)
    result["profile"] = profiled(
        lambda: stark.prove(trace, air, boundary, ProofStream(stark.field)))
    print(json.dumps({"chain_profile": result["profile"]}), flush=True)
    return result


@contextlib.contextmanager
def bodies_called_directly(dev):
    """While active, every segment the prover, verifier and FRI ask for is a
    new segment's body called directly on the card (its inputs moved there):
    no capture and no replay.  Only to hold the replays against."""
    def direct(cache, key, build):
        body = build().body

        def call(*args):
            return body(*[a.to(dev) if isinstance(a, torch.Tensor) else [t.to(dev) for t in a]
                          for a in args])
        return call

    cache_get = segments.cache_get
    segments.cache_get = direct
    try:
        yield
    finally:
        segments.cache_get = cache_get


def segment_phase(dev) -> dict:
    """Phase 7a: a default-config sign through replayed segments against the
    sign from the same rng with the bodies called directly on the card, byte
    for byte; two signs of other documents interleaved with their verifies;
    the fixture and chain fixture phases again, now replaying (no capture);
    then the caches cleared (their graphs' pools freed)."""
    doc, tag = b"attack at dawn", b"chip-smoke-segments"

    def signer():
        rpsss = RPSSS(Field(), device=dev, rng=DetRng(tag))
        return (rpsss, *rpsss.keygen())

    rpsss, sk, pk = signer()
    replays = segments.replays
    with bodies_called_directly(dev):
        direct = rpsss.sign(sk, doc)
        require(rpsss.verify(pk, doc, direct), "the bodies' signature rejected")
    require(segments.replays == replays, "a segment replayed while the bodies ran directly")
    rpsss, sk, pk = signer()
    before, replays = cached_segments(), segments.replays
    sig = rpsss.sign(sk, doc)
    sign_replays = segments.replays - replays
    require(sign_replays == 2 and not captures_since(before),
            f"the sign replayed {sign_replays} segments and captured "
            f"{[c['name'] for c in captures_since(before)]}")
    require(sig == direct, "the replayed segments' signature differs from the bodies'")
    require(rpsss.verify(pk, doc, sig), "the replayed segments' signature rejected")

    docs = (b"first document", b"second document")
    sigs = []
    for d in docs:
        sigs.append(rpsss.sign(sk, d))
        require(rpsss.verify(pk, d, sigs[-1]), f"signature of {d!r} rejected")
    require(rpsss.verify(pk, docs[0], sigs[0]), "the first signature rejected after the second")
    require(not rpsss.verify(pk, docs[1], sigs[0]) and not rpsss.verify(pk, docs[0], sigs[1]),
            "a signature verified against the other document")

    for phase in (fixture_phase, chain_fixture_phase):
        before, replays = cached_segments(), segments.replays
        phase(dev)
        require(not captures_since(before) and segments.replays > replays,
                f"{phase.__name__} again: captured {[c['name'] for c in captures_since(before)]}"
                f", {segments.replays - replays} replays")
    reserved = torch.cuda.memory_reserved() / 1e9
    Stark._SEG_CACHE.clear()
    FRI._LOWDEG_CACHE.clear()
    gc.collect()
    torch.cuda.empty_cache()
    result = dict(sign_equals_bodies=True, sign_replays=sign_replays,
                  interleaved_documents=len(docs), fixtures_replayed=True,
                  reserved_gb_before_clear=reserved,
                  reserved_gb_after_clear=torch.cuda.memory_reserved() / 1e9)
    print("segments: a replayed sign equals the bodies called directly byte for byte; two "
          "documents signed and verified in turns; both fixtures reproduced through replays "
          + json.dumps(result), flush=True)
    return result


def dist_phase(dev, kernels) -> dict:
    """Phase 7d: the distributed engine over NCCL at world size 1."""
    fixtures = ROOT / "tests" / "fixtures"
    meta = json.loads((fixtures / "meta.json").read_text())
    chain_meta = json.loads((fixtures / "chain_meta.json").read_text())
    torch.cuda.set_device(dev)
    tmp = tempfile.mkdtemp()
    require(multihost.initialize(f"file://{tmp}/rendezvous", 1, 0, dev),
            "the process group did not start")
    try:
        require(dist.get_backend() == "nccl", f"backend {dist.get_backend()}, not nccl")
        eng = dist_engine(1)
        require(eng.is_distributed and eng.captures_segments and DEFAULT.captures_segments,
                "the distributed engine does not capture its segments over NCCL")
        ops = DR.check_engine_ops(eng, DIST_SIZES, dev)
        for n, by_op in ops.items():
            for op in ("ntt", "intt"):
                require(by_op[op]["collectives"]["all_to_all"] == 3
                        and by_op[op]["collectives"]["all_gather"] == 0,
                        f"DistEngine.{op} n={n} issued {by_op[op]['collectives']}")
        ntt = DR.check_ntt_dist(DIST_SIZES, dev)
        print(f"dist ops: DistEngine ntt/intt/batch_inv/fold_round/combine/move on blocks "
              f"bit-exact against the single engine's rows at {list(DIST_SIZES)}, "
              f"collectives {json.dumps(ops)}; ntt_dist/intt_dist round trips "
              f"{json.dumps(ntt)}", flush=True)

        sig = DR.sign(eng, meta["config"], meta["document"], "zk-stark-fixture", dev)
        require(bytes.fromhex(sig["proof"]) == (fixtures / "signature.bin").read_bytes(),
                "the fixture signature through the distributed engine differs")
        chain_fixture = DR.prove_chain(eng, chain_meta["config"], chain_meta["input"],
                                       chain_meta["rng_tag"], dev)
        require(bytes.fromhex(chain_fixture["proof"])
                == (fixtures / "chain_proof.bin").read_bytes(),
                "the chain fixture through the distributed engine differs")
        print("dist fixtures: signature and chain fixture reproduced through the engine",
              flush=True)

        def timed(fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            return out, (time.perf_counter() - t0) * 1e3

        def counted(fn):
            """fn() with every kernel's launches, the collectives (by kind,
            with their bytes and largest result), the replays and the
            Python kernel calls counted from just before to just after."""
            for k in kernels:
                k.launches = 0
            replays, calls = segments.replays, python_calls()
            with collectives.record() as tally:
                out, ms = timed(fn)
            issued = dict(DR.tally_json(tally), python_kernel_calls=python_calls() - calls)
            return out, ms, {k.name: k.launches for k in kernels}, issued, \
                segments.replays - replays

        doc = b"attack at dawn"
        rpsss = RPSSS(Field(), device=dev, rng=DetRng(b"chip-smoke-dist"))
        sk, pk = rpsss.keygen()

        def signer(engine):
            """The sign of ``doc`` with ``engine``, from the same randomness
            each time."""
            def sign():
                rpsss.stark._rng = DetRng(b"chip-smoke-dist-sign")
                rpsss.stark.engine = rpsss.stark.fri.engine = engine
                return rpsss.sign(sk, doc)
            return sign

        def warm_runs(fn, engine, runs):
            """A cold call (the captures, or the engine's first tables),
            then ``runs`` warm ones: the first warm one counted, the median
            of their times."""
            timed(fn(engine))
            out, ms, launches, issued, replays = counted(fn(engine))
            times = [ms] + [timed(fn(engine))[1] for _ in range(runs - 1)]
            return out, statistics.median(times), times, launches, issued, replays

        sign = {name: warm_runs(signer, engine, 3)
                for name, engine in (("single", DEFAULT), ("dist", eng))}
        sig, sign_launches, sign_issued, sign_replays = (
            sign["dist"][0], *sign["dist"][3:])
        require(len(sig) == MAIN_PROOF_BYTES, f"the distributed signature is {len(sig)} B")
        require(sig == sign["single"][0],
                "the distributed signature differs from the single engine's")
        rpsss.stark.engine = rpsss.stark.fri.engine = DEFAULT
        require(rpsss.verify(pk, doc, sig), "the distributed signature rejected")
        # the four-step's fused-twiddle passes only at lengths that do not
        # split over the ranks: none at world size 1
        check_path_launches("distributed sign", sign_launches, SIGN_BATCH_INV_SIZES,
                            may_skip=(N.NTT_TW_KERNEL.name,))
        require(sign_replays == 2 and sign["single"][5] == 2,
                f"a distributed sign replayed {sign_replays} segments, a single one "
                f"{sign['single'][5]} (2 and 2 expected)")
        require(sign_issued["collectives"]["all_to_all"] > 0,
                "the distributed sign's replays counted no all-to-all")

        model, stark = make_chain_stark(Field(), CHAIN_LENGTH, device=dev)
        air = model.air(stark.omicron, stark.omicron_domain_length)
        trace = model.trace(0x5EED)
        boundary = model.boundary_constraints(trace[-1][0])

        def prover(engine):
            """The chain's prove with ``engine``, from the same randomness
            each time."""
            def prove():
                stark._rng = DetRng(b"chip-smoke-dist-chain")
                stark.engine = stark.fri.engine = engine
                return stark.prove(trace, air, boundary, ProofStream(stark.field))
            return prove

        chain = {name: warm_runs(prover, engine, 3)
                 for name, engine in (("single", DEFAULT), ("dist", eng))}
        proof, chain_launches, chain_issued, chain_replays = (
            chain["dist"][0], *chain["dist"][3:])
        stark.engine = stark.fri.engine = DEFAULT
        require(len(proof) == CHAIN_PROOF_BYTES, f"the distributed chain proof is {len(proof)} B")
        require(proof == chain["single"][0],
                "the distributed chain proof differs from the single engine's")
        require(not rejects(stark, air, boundary, proof), "the distributed chain proof rejected")
        check_path_launches("distributed chain prove", chain_launches, CHAIN_BATCH_INV_SIZES,
                            may_skip=(N.NTT_TW_KERNEL.name,))
        require(chain_replays == 2 and chain["single"][5] == 2,
                f"a distributed chain prove replayed {chain_replays} segments, a single one "
                f"{chain['single'][5]} (2 and 2 expected)")
        require(chain_issued["collectives"]["all_to_all"] > 0,
                "the distributed chain prove's replays counted no all-to-all")
    finally:
        multihost.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)
    Stark._SEG_CACHE.clear()
    FRI._LOWDEG_CACHE.clear()
    gc.collect()
    torch.cuda.empty_cache()
    result = dict(world_size=1, backend="nccl", card=card_line(), sizes=list(DIST_SIZES),
                  sign_ms_single=sign["single"][1], sign_ms_dist=sign["dist"][1],
                  sign_ms_runs_single=sign["single"][2], sign_ms_runs_dist=sign["dist"][2],
                  chain_prove_ms_single=chain["single"][1], chain_prove_ms_dist=chain["dist"][1],
                  chain_prove_ms_runs_single=chain["single"][2],
                  chain_prove_ms_runs_dist=chain["dist"][2],
                  single_sign_replays=sign["single"][5], single_chain_replays=chain["single"][5],
                  single_sign_python_kernel_calls=sign["single"][4]["python_kernel_calls"],
                  single_chain_python_kernel_calls=chain["single"][4]["python_kernel_calls"],
                  sign_collectives=sign_issued, chain_collectives=chain_issued,
                  sign_replays=sign_replays, chain_replays=chain_replays,
                  sign_launches=sign_launches, chain_launches=chain_launches,
                  proof_bytes=len(sig), chain_proof_bytes=len(proof))
    print("dist: the default-config sign and the chain prove at 3200 through the distributed "
          "engine equal the single engine's byte for byte and verify "
          + json.dumps(result), flush=True)
    return result


def plan_text(n: int, batch: int) -> str:
    """The passes ntt_kernel launches for ``batch`` transforms of n points:
    each pass's transform length, grid and block shape."""
    parts = []
    for p in N.kernel_passes(n, batch, 1):
        b = N.block_shape(p)
        parts.append(f"{p.kernel.name} m={p.m} grid={p.grid}: {1 << b.log2_count} transforms "
                     f"a block along {'xyz'[b.dim]}, {b.threads} threads, loads "
                     f"{'transform' if b.in_tmajor else 'element'}-major, stores "
                     f"{'transform' if b.out_tmajor else 'element'}-major")
        if p.grid[b.dim] % (1 << b.log2_count):
            parts[-1] += " (last block masked)"
    return "; ".join(parts)


def long_ntt_phase(dev, int_rate: float, logs: dict | None = None) -> dict:
    """Phase 7b: the transform entry points beyond 2^20 points and one
    low-degree extension at 2^25; returns the three-pass row (1c) and the
    four-step's times at the larger sizes."""
    F = Field()
    gen = torch.Generator().manual_seed(1237)
    kernels = [N.NTT_KERNEL, N.NTT_TW_KERNEL, N.NTT_LONG_TW_KERNEL, N.NTT_LONG_KERNEL]
    print(f"ptxas {ptxas_line(logs or {}, 'ntt')}", flush=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    xs = {n: random_mont(n, gen, dev) for n in LONG_NTT_SIZES}
    roots = {n: F.primitive_nth_root(n).value for n in LONG_NTT_SIZES}
    coeffs = random_mont(LDE_COEFFS, gen, dev)
    offset = F.generator().value
    lde_root = F.primitive_nth_root(LDE_POINTS).value

    def extend():
        return PO.fast_coset_evaluate(PO.DPoly(coeffs), offset, lde_root, LDE_POINTS)

    for k in kernels:
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ys = {n: N.ntt_mont(x, roots[n]) for n, x in xs.items()}
    backs = {n: N.intt_mont(ys[n], roots[n]) for n in xs}
    codeword = extend()
    torch.cuda.synchronize()
    path_s = time.perf_counter() - t0
    path_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = {k.name: k.launches for k in kernels}
    planned = dict.fromkeys(launches, 0)
    for n, count in [(n, 2) for n in xs] + [(LDE_POINTS, 1)]:
        for p in N.kernel_passes(n, 1, 1):
            planned[p.kernel.name] += count
    require(launches == planned, f"long NTT launches {launches}, planned {planned}")
    require(all(launches.values()), f"a kernel of the long-NTT path was not launched: {launches}")
    # three launches a transform at 2^25, two of them ntt_tw_launch
    require([p.kernel for p in N.kernel_passes(LONG_NTT_SIZES[-1], 1, 1)]
            == [N.NTT_TW_KERNEL, N.NTT_LONG_TW_KERNEL, N.NTT_LONG_KERNEL],
            f"the plan at {LONG_NTT_SIZES[-1]} is not the three-pass split")

    by_size = {}
    for n, x in xs.items():
        root = roots[n]
        inv = pow(root, -1, L.P)
        # the plain versions' own tables (plain products, cached under the
        # same arguments), built before the timed call as the kernel's were
        # by the path
        for r in (root, inv):
            for p in N.kernel_passes(n, 1, r):
                if p.four_step is not None:
                    run_plain(lambda: N._four_step_twiddles_u32(*p.four_step, str(dev),
                                                                plain=True))
        if n == LONG_NTT_SIZES[-1]:
            run_plain(lambda: N._powers_dev(root, n // 2, 1, str(dev), plain=True))
        plain, p_ms = timed_once(lambda: run_plain(N.ntt_passes_plain, x, root))
        err = check(f"ntt_mont n={n}", ys[n], plain)
        del plain
        err += check(f"ntt_kernel inverse root n={n}", N.ntt_kernel(x, inv),
                     run_plain(N.ntt_passes_plain, x, inv))
        require(torch.equal(backs[n], x), f"intt_mont(ntt_mont(x)) is not x at n={n}")
        flat_ms = None
        if n == LONG_NTT_SIZES[-1]:
            flat, flat_ms = timed_once(lambda: run_plain(N.ntt_plain, x, root))
            err += check(f"ntt_mont n={n} against the flat plain transform", ys[n], flat)
            del flat
            # the grid's third index (batch columns of passes 2 and 3): two
            # columns at once equal each alone
            pair = N.ntt_kernel(torch.stack([x, ys[n]], dim=1), root)
            require(torch.equal(pair[:, 0], ys[n]) and torch.equal(pair[:, 1], N.ntt_kernel(ys[n], root)),
                    f"ntt_kernel n={n}: a batch of two differs from the columns alone")
            del pair
        big = n >= 1 << 24
        reps, runs = (5, 3) if big else (20, 5)
        k_ms = time_ms(lambda: N.ntt_kernel(x, root), reps=reps, runs=runs)
        # each pass alone, between two buffers of the transform's size
        passes = N.kernel_passes(n, 1, root)
        dst = torch.empty_like(x)
        pass_ms = [time_ms(lambda: N._launch_pass(x, dst, p), reps=reps, runs=runs) for p in passes]
        del dst
        bound = ntt_bound(n, int_rate)
        by_size[f"n={n}"] = dict(ms=k_ms, pass_ms=pass_ms, plain_ms=p_ms, flat_plain_ms=flat_ms,
                                 bound_ms=bound[0], bound_by=bound[1], passes=len(passes),
                                 max_abs_err=err)
        print(f"long ntt n={n} ({len(passes)} passes): bit-exact (both roots; round trip"
              f"{'; flat plain; batch of two' if flat_ms else ''}), kernel {k_ms:.4f} ms (passes "
              f"{', '.join(f'{t:.4f}' for t in pass_ms)}), plain {p_ms:.1f} ms"
              f"{f', flat plain {flat_ms:.1f} ms' if flat_ms else ''}, bound {bound[0]:.6f} ms "
              f"({bound[1]})", flush=True)
        print(f"long ntt n={n} plan: {plan_text(n, 1)}", flush=True)

    # the extension at 4 coset points, against a direct evaluation (no NTT)
    require(tuple(codeword.shape) == (LDE_POINTS, L.NLIMB), f"codeword shape {codeword.shape}")
    idx = [0, 1, int(torch.randint(2, LDE_POINTS - 1, (1,), generator=gen)), LDE_POINTS - 1]
    points = L.ints_to_mont([offset * pow(lde_root, i, L.P) % L.P for i in idx], dev)
    require(torch.equal(codeword[idx], PO.evaluate_many(coeffs, points)),
            "fast_coset_evaluate differs from evaluate_many at the sampled coset points")
    lde_ms = timed_once(extend)[1]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"low-degree extension {LDE_COEFFS} -> {LDE_POINTS}: equals evaluate_many at coset "
          f"indices {idx}; {lde_ms:.3f} ms warm; path {path_s:.2f} s (host clock); launches "
          f"{launches}; peak device memory {path_peak_gb:.2f} GB in the path (inputs, outputs and "
          f"round trips of every size held), {peak_gb:.2f} GB in the phase", flush=True)

    head = by_size[f"n={LONG_NTT_SIZES[-1]}"]
    row = dict(kernel=N.NTT_LONG_TW_KERNEL, source="zk_stark_tpu_torch/csrc/ntt.cu",
               launches=launches["ntt_long_tw"] + launches["ntt_long"],
               launches_by_kernel=launches, max_abs_err=head["max_abs_err"],
               shape=f"n={LONG_NTT_SIZES[-1]}", ms=head["ms"], pass_ms=head["pass_ms"],
               plain_ms=head["plain_ms"],
               flat_plain_ms=head["flat_plain_ms"], bound_ms=head["bound_ms"],
               bound_by=head["bound_by"], lde_ms=lde_ms, lde_indices=idx, path_s=path_s,
               path_peak_gb=path_peak_gb, peak_gb=peak_gb, by_size={f"n={LONG_NTT_SIZES[-1]}": head})
    four_step = {size: v for size, v in by_size.items() if v["passes"] == 2}
    del xs, ys, backs, codeword
    return {"ntt_long": row, "four_step_by_size": four_step}


def probe_phase(dev) -> dict:
    """Phase 7c: the NTT stage-variant probe; one row per variant (a's
    kernel is ntt.cu's, so its launches are the ntt kernel's over the
    probe's run)."""
    launches0 = {which: k.launches for which, k in NV.VARIANT_KERNELS.items()}
    result = ntt_variant_probe.run(device=dev)
    torch.cuda.synchronize()
    rows = {}
    for which, r in result.items():
        k = NV.VARIANT_KERNELS[which]
        launches = k.launches - launches0[which]
        require(launches > 0, f"kernel {k.name} was not launched by the probe's variant {which}")
        source = "zk_stark_tpu_torch/csrc/" + ("ntt.cu" if which == "a" else "ntt_variants.cu")
        rows[f"ntt_variant_{which}"] = dict(
            kernel=k, source=source, launches=launches,
            replaces=NV.A_REPLACES if which == "a" else k.replaces,
            shape=f"n={ntt_variant_probe.N_POINTS},c={ntt_variant_probe.N_TRANSFORMS}", **r)
    return rows


def permutation_counts(m: int, n_rounds: int, alpha: int, alpha_inv: int) -> tuple[int, int]:
    """(Montgomery products, modular additions) of one Rescue permutation
    as the kernel computes it: per round and register the two S-boxes'
    exponent chains (rescue_ops.exponent_chain); two m x m MDS products,
    m - 1 additions a row; two additions of constants."""
    return (R.products_per_permutation(m, n_rounds, alpha, alpha_inv),
            n_rounds * 2 * (m * (m - 1) + m))


def ptxas_line(logs: dict, name: str) -> str:
    """The registers and spills ptxas printed for library ``name``'s
    kernels, or a note that it was built before this run."""
    if name not in logs:
        return f"{name}: built before this run (no ptxas output)"
    lines = [ln.strip() for ln in logs[name].splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    return f"{name}: " + " | ".join(lines)


def product_phase(dev) -> dict:
    """Phase 2b: field.cuh's product on the card against Python integers."""
    edge = [0, 1, L.P - 1, L.P - 2]
    gen = torch.Generator().manual_seed(45)
    rand = L.mont_to_ints(random_mont(2 * PRODUCT_PAIRS, gen, "cpu"))
    a_vals = [a for a in edge for _ in edge] + [int(v) for v in rand[:PRODUCT_PAIRS]]
    b_vals = [b for _ in edge for b in edge] + [int(v) for v in rand[PRODUCT_PAIRS:]]
    a = L.from_numpy(L.ints_to_limbs(a_vals), dev)
    b = L.from_numpy(L.ints_to_limbs(b_vals), dev)
    got = L.mont_mul_kernel(a, b)  # csrc/limbs.cu: one field.cuh product an element
    r_inv = pow(1 << 128, -1, L.P)
    want = [x * y * r_inv % L.P for x, y in zip(a_vals, b_vals)]
    require(list(L.limbs_to_ints(got)) == want, "field.cuh mont_mul differs from integers")
    require(torch.equal(got, run_plain(L.mont_mul_plain, a, b)),
            "field.cuh mont_mul differs from limbs.mont_mul_plain")
    print(f"product: field.cuh mont_mul equals Python integers on the {len(edge) ** 2} pairs of "
          f"{{0, 1, p-1, p-2}} and {PRODUCT_PAIRS} random pairs ({MONT_MUL_OPS} PTX instructions)",
          flush=True)
    return {"pairs": len(a_vals), "ptx_ops": MONT_MUL_OPS}


def run_plain(fn, *args):
    """``fn(*args)`` for a plain kernel version on the card's tensors: it
    runs its own tensor code (ops/limbs.py *_plain), so no limb kernel may
    be launched during it."""
    before = [k.launches for k in L.KERNELS]
    out = fn(*args)
    moved = {k.name: k.launches - c for k, c in zip(L.KERNELS, before) if k.launches != c}
    require(not moved, f"{getattr(fn, '__name__', fn)} launched limb kernels: {moved}")
    return out


#: op: (kernel wrapper, plain version, operands, 32-bit instructions an element)
LIMB_OPS = {
    "mont_mul": (L.mont_mul_kernel, L.mont_mul_plain, 2, MONT_MUL_OPS),
    "add_mod": (L.add_mod_kernel, L.add_mod_plain, 2, ADD_SUB_OPS),
    "sub_mod": (L.sub_mod_kernel, L.sub_mod_plain, 2, ADD_SUB_OPS),
    "redc": (L.redc_kernel, L.redc_plain, 1, MONT_MUL_OPS),
}


def limb_bound(op: str, n: int, broadcast: bool, int_rate: float) -> tuple[float, str]:
    """n elements of ``op``: each full-shape operand read once and the
    output written once (64 B each; a broadcast operand is one element),
    against its instructions."""
    arrays = 1 + LIMB_OPS[op][2] - broadcast
    return bound_ms(arrays * n * 64, n * LIMB_OPS[op][3], int_rate)


def host_us(fn, calls: int = HOST_CALLS) -> float:
    """Host time of one call: the wall time of ``calls`` unsynchronised calls
    over their count."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / calls * 1e6


def limb_phase(dev, int_rate: float, logs: dict | None = None) -> dict:
    """Phase 2c: the limb kernels (csrc/limbs.cu) at the tail sizes (checked
    only) and at 4096, 2^20 and 2^25 elements, every op in every layout of
    limb_operands bit for bit against its plain version (every pair of
    LIMB_EDGES leads the inputs, as many as fit); times of
    the full and the broadcast layout beside their bounds, the plain
    version timed once at 2^25; the host time of a call at 4096, kernel
    against tensor code; one profiled call of each op (the inversion and
    the batch inversion among them, the latter also at 2^18 elements:
    three launches), which must be one launch of its kernel and nothing
    else.  Kernel times are queued
    (measure.time_ms): at 4096 a call's host time exceeds its device time.
    Returns one row per op."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    print(f"ptxas {ptxas_line(logs or {}, 'limbs')}", flush=True)
    gen = torch.Generator().manual_seed(46)
    ea, eb = edge_pairs()
    rows = {f"limbs_{op}": dict(kernel=k, source="zk_stark_tpu_torch/csrc/limbs.cu",
                                max_abs_err=0, by_size={})
            for op, k in zip(LIMB_OPS, L.KERNELS)}
    launches0 = [k.launches for k in L.KERNELS]
    copies0 = L.copies
    want_copies = 0
    for n in LIMB_TAIL_SIZES + LIMB_SIZES:
        a, b = random_mont(n, gen, dev), random_mont(n, gen, dev)
        edges = min(n, len(ea))
        a[:edges] = L.from_numpy(L.ints_to_limbs(ea[:edges]), dev)
        b[:edges] = L.from_numpy(L.ints_to_limbs(eb[:edges]), dev)
        grid_rows = 1 << (n.bit_length() - 1) // 2
        for op, (kernel, plain, arity, _) in LIMB_OPS.items():
            row = rows[f"limbs_{op}"]
            for layout in LIMB_LAYOUTS if arity == 2 else UNARY_LAYOUTS:
                args = limb_operands(layout, a, b, grid_rows)[:arity]
                err = check(f"limbs {op} {layout} n={n}", kernel(*args), run_plain(plain, *args))
                row["max_abs_err"] = max(row["max_abs_err"], err)
                # one element's transposed limbs are adjacent all the same
                want_copies += layout in COPIED_LAYOUTS and (n > 1 or layout == "misaligned")
            if n in LIMB_TAIL_SIZES:
                continue
            full, bc = (a, b)[:arity], (a, b[2])
            bound = limb_bound(op, n, False, int_rate)
            size = dict(ms=time_ms(lambda: kernel(*full), queued=True), bound_ms=bound[0],
                        bound_by=bound[1])
            if arity == 2:
                size["broadcast_ms"] = time_ms(lambda: kernel(*bc), queued=True)
                size["broadcast_bound_ms"] = limb_bound(op, n, True, int_rate)[0]
            if n == LIMB_SIZES[-1]:
                size["plain_ms"] = timed_once(lambda: run_plain(plain, *full))[1]
            if n == LIMB_SIZES[0]:
                size["host_us"] = host_us(lambda: kernel(*full))
                size["plain_host_us"] = host_us(lambda: run_plain(plain, *full))
            row["by_size"][f"n={n}"] = size
            print(f"limbs {op} n={n}: bit-exact in layouts "
                  f"{', '.join(LIMB_LAYOUTS if arity == 2 else UNARY_LAYOUTS)}; "
                  + ", ".join(f"{k} {v:.6g}" if isinstance(v, float) else f"{k} {v}"
                              for k, v in size.items()), flush=True)
        if n in LIMB_TAIL_SIZES:
            print(f"limbs n={n}: every op bit-exact in every layout", flush=True)
        if n == LIMB_SIZES[0]:
            x, y = a, b
        else:
            del a, b
    copies = L.copies - copies0
    require(copies == want_copies,
            f"{copies} limb operand copies, {want_copies} expected (one a transposed or "
            "misaligned call)")

    # the batch inversion at a sign's largest call (one launch) and the
    # chain's (three)
    big = x.repeat(64, 1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for op, (_, _, arity, _) in LIMB_OPS.items():
            getattr(L, op)(*(x, y)[:arity])  # the dispatching name
        L.mont_inv_fermat(x[:1])
        L.batch_inv(x[:BATCH_INV_HEAD])
        L.batch_inv(big)
        torch.cuda.synchronize()
    device = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    want = [k.symbol.replace("_launch", "_kernel") for k in L.KERNELS]
    # one instantiation a per-thread count
    want[-1] += f"_k{L.BATCH_INV_PER_THREAD}"
    want += want[-1:] * batch_inv_launches(big.shape[0])
    require(device == want, f"one profiled call of each limb op launched {device}")
    print(f"limbs profiled: one call of each op on the card is one launch of its kernel, "
          f"batch_inv of {big.shape[0]} elements {batch_inv_launches(big.shape[0])}: {device}",
          flush=True)

    for row, k, c in zip(rows.values(), L.KERNELS, launches0):
        head = row["by_size"][f"n={LIMB_SIZES[-1]}"]
        row.update(shape=f"n={LIMB_SIZES[-1]}", ms=head["ms"], plain_ms=head["plain_ms"],
                   bound_ms=head["bound_ms"], bound_by=head["bound_by"],
                   launches_own_phase=k.launches - c, copies_own_phase=copies)
    return rows


def inv_bound(n: int, int_rate: float) -> tuple[float, str]:
    """n inversions: each element read and written once (128 B) against the
    chain's INV_PRODUCTS products of MONT_MUL_OPS instructions."""
    return bound_ms(n * 128, n * INV_PRODUCTS * MONT_MUL_OPS, int_rate)


def inversion_phase(dev, int_rate: float) -> dict:
    """Phase 2c, inversion: the kernel of mont_inv_fermat (csrc/limbs.cu
    limbs_inv_launch) bit for bit against its plain version, and against
    Python integers, on 0, 1, p-1, p-2 (as stored limbs), one random
    element and 2^14; its queued time at INV_SIZES beside its bound (at one
    element the time is one thread's chain of dependent products), the
    plain version timed once at 2^14.  Returns the kernel's row."""
    gen = torch.Generator().manual_seed(47)
    launches0 = L.INV_KERNEL.launches
    r2 = L.R_INT * L.R_INT % L.P
    cases = {"edges": L.from_numpy(L.ints_to_limbs([0, 1, L.P - 1, L.P - 2]), dev),
             "n=1": random_mont(1, gen, dev), "n=16384": random_mont(1 << 14, gen, dev)}
    row = dict(kernel=L.INV_KERNEL, source="zk_stark_tpu_torch/csrc/limbs.cu", max_abs_err=0,
               by_size={})
    for name, x in cases.items():
        got = L.mont_inv_fermat_kernel(x)
        row["max_abs_err"] = max(row["max_abs_err"], check(
            f"inv {name}", got, run_plain(L.mont_inv_fermat_plain, x)))
        # a stored value v is the Montgomery form of v / R: its inverse's is R^2 / v
        want = [pow(int(v), -1, L.P) * r2 % L.P if v else 0 for v in L.limbs_to_ints(x)]
        require([int(v) for v in L.limbs_to_ints(got)] == want,
                f"inv {name}: kernel differs from Python integers")
    for n, x in zip(INV_SIZES, (cases["n=1"], cases["n=16384"])):
        bound = inv_bound(n, int_rate)
        size = dict(ms=time_ms(lambda: L.mont_inv_fermat_kernel(x), queued=True),
                    bound_ms=bound[0], bound_by=bound[1])
        if n == INV_SIZES[-1]:
            size["plain_ms"] = timed_once(lambda: run_plain(L.mont_inv_fermat_plain, x))[1]
        row["by_size"][f"n={n}"] = size
    head = row["by_size"][f"n={INV_SIZES[-1]}"]
    row.update(shape=f"n={INV_SIZES[-1]}", ms=head["ms"], plain_ms=head["plain_ms"],
               bound_ms=head["bound_ms"], bound_by=head["bound_by"],
               launches_own_phase=L.INV_KERNEL.launches - launches0)
    print("inv: bit-exact against its plain version and Python integers on 0, 1, p-1, p-2, one "
          "and 2^14 elements; " + json.dumps(row["by_size"]), flush=True)
    return row


def batch_inv_capacity() -> int:
    """C: the most elements one launch of the batch inversion takes."""
    return L.BATCH_INV_THREADS * L.BATCH_INV_PER_THREAD


def batch_inv_launches(n: int) -> int:
    """Launches of the batch inversion for n elements (ops/limbs.py
    batch_inv_grid): one up to C, else two around those of the totals."""
    blocks = -(-n // batch_inv_capacity())
    return 1 if blocks == 1 else 2 + batch_inv_launches(blocks)


def batch_inv_bound(n: int, int_rate: float) -> tuple[float, str]:
    """n elements of batch_inv: each read once and written once (128 B)
    against Montgomery's trick's ~3 products an element (MONT_MUL_OPS
    instructions each).  The root's inversion, one thread's chain of
    dependent steps, is a latency floor that neither count shows."""
    return bound_ms(n * 128, n * 3 * MONT_MUL_OPS, int_rate)


def batch_inv_values(n: int, gen: torch.Generator, dev) -> torch.Tensor:
    """n random elements on ``dev`` with zeros first, in the middle and last
    and 1 and p - 1 (Montgomery form) after the first zero, as many as fit."""
    x = random_mont(n, gen, dev)
    edges = L.ints_to_mont([1, L.P - 1], dev)
    x[1:3] = edges[:max(0, min(2, n - 1))]
    for i in (0, n // 2, n - 1):
        x[i] = 0
    return x


def batch_inv_phase(dev, int_rate: float) -> dict:
    """Phase 2c, batch inversion: csrc/batch_inv.cu through batch_inv at
    BATCH_INV_SIZES, C and C + 1 (batch_inv_values: zeros first, in the
    middle and last), and all-zero inputs of 284 and C + 1 elements, bit for
    bit against batch_inv_plain and Python integers; each call
    batch_inv_launches(n) launches of the kernel and none of another limb
    kernel (limb_phase's profile shows nothing else on the card); a strided
    and a misaligned operand copied once each; each size's
    queued time beside its bound, the plain version timed once at the
    headline size.  Returns the kernel's row."""
    gen = torch.Generator().manual_seed(48)
    cap = batch_inv_capacity()
    k = L.BATCH_INV_KERNEL
    others = [o for o in L.KERNELS if o is not k]
    launches0 = k.launches
    row = dict(kernel=k, source="zk_stark_tpu_torch/csrc/batch_inv.cu", max_abs_err=0, by_size={},
               capacity=cap, threads=L.BATCH_INV_THREADS, per_thread=L.BATCH_INV_PER_THREAD)
    r2 = L.R_INT * L.R_INT % L.P
    sizes = sorted(set(BATCH_INV_SIZES) | {cap, cap + 1})
    cases = [(f"n={n}", batch_inv_values(n, gen, dev)) for n in sizes]
    cases += [(f"all-zero n={n}", torch.zeros((n, L.NLIMB), dtype=L.DTYPE, device=dev))
              for n in (284, cap + 1)]
    for name, x in cases:
        n = x.shape[0]
        before = (k.launches, [o.launches for o in others])
        got = L.batch_inv(x)
        moved = {o.name: o.launches - c for o, c in zip(others, before[1]) if o.launches != c}
        require(k.launches - before[0] == batch_inv_launches(n) and not moved,
                f"batch_inv {name}: {k.launches - before[0]} launches of its kernel "
                f"({batch_inv_launches(n)} expected), others {moved}")
        row["max_abs_err"] = max(row["max_abs_err"], check(
            f"batch_inv {name}", got, run_plain(L.batch_inv_plain, x)))
        # a stored value v is the Montgomery form of v / R: its inverse's is R^2 / v
        want = [pow(int(v), -1, L.P) * r2 % L.P if v else 0 for v in L.limbs_to_ints(x)]
        require([int(v) for v in L.limbs_to_ints(got)] == want,
                f"batch_inv {name}: kernel differs from Python integers")
        if name.startswith("all-zero"):
            continue
        bound = batch_inv_bound(n, int_rate)
        size = dict(ms=time_ms(lambda: L.batch_inv_kernel(x), queued=True),
                    launches=batch_inv_launches(n), bound_ms=bound[0], bound_by=bound[1])
        if n == BATCH_INV_HEAD:
            size["plain_ms"] = timed_once(lambda: run_plain(L.batch_inv_plain, x))[1]
            head = x
        row["by_size"][name] = size

    copies0 = L.copies
    strided = torch.stack([head, head], dim=1)[:, 0]
    buf = torch.empty(head.numel() + 1, dtype=L.DTYPE, device=dev)
    misaligned = buf[1:].view(head.shape)
    misaligned.copy_(head)
    want = L.batch_inv_kernel(head)
    for view in (strided, misaligned):
        check("batch_inv from a strided or misaligned view", L.batch_inv(view), want)
    require(L.copies - copies0 == 2, f"{L.copies - copies0} copies for two views (2 expected)")

    head_size = row["by_size"][f"n={BATCH_INV_HEAD}"]
    row.update(shape=f"n={BATCH_INV_HEAD}", ms=head_size["ms"], plain_ms=head_size["plain_ms"],
               bound_ms=head_size["bound_ms"], bound_by=head_size["bound_by"],
               launches_own_phase=k.launches - launches0)
    print(f"batch_inv: bit-exact against batch_inv_plain and Python integers at {sizes} elements "
          f"(C = {cap}: {L.BATCH_INV_THREADS} threads x {L.BATCH_INV_PER_THREAD}), zeros first, in "
          "the middle and last, and all-zero at 284 and C + 1; one launch up to C, three above; "
          "a strided and a misaligned operand copied once each; " + json.dumps(row["by_size"]),
          flush=True)
    return row


def timed_once(fn):
    """(fn(), its device time in ms) for one call, with CUDA events."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def montmul_chain_phase(dev, int_rate: float, logs: dict | None = None) -> dict:
    """Phase 8a: the chained product, the card's measured product rate."""
    gen = torch.Generator().manual_seed(42)
    x = random_mont(CHAIN_N, gen, dev)
    plain, p_ms = timed_once(lambda: run_plain(MC.mont_mul_chain_plain, x, CHAIN_K))
    err = check(f"montmul_chain n={CHAIN_N} k={CHAIN_K}", MC.mont_mul_chain_kernel(x, CHAIN_K), plain)
    ragged = random_mont(CHAIN_RAGGED_N, gen, dev)
    err = max(err, check(f"montmul_chain n={CHAIN_RAGGED_N} k={CHAIN_RAGGED_K}",
                         MC.mont_mul_chain_kernel(ragged, CHAIN_RAGGED_K),
                         run_plain(MC.mont_mul_chain_plain, ragged, CHAIN_RAGGED_K)))
    del ragged
    probe_vals = (2, 3, L.P - 1)
    probe = L.ints_to_mont(probe_vals, dev)
    for k in (CHAIN_K, CHAIN_K_LONG):
        require([int(v) for v in L.mont_to_ints(MC.mont_mul_chain_kernel(probe, k))]
                == [pow(v, k + 1, L.P) for v in probe_vals],
                f"montmul_chain k={k}: y is not x^(k+1)")

    MC.MONTMUL_CHAIN_KERNEL.launches = 0
    MC.mont_mul_chain(x, CHAIN_K)
    torch.cuda.synchronize()
    launches = MC.MONTMUL_CHAIN_KERNEL.launches

    k_ms = time_ms(lambda: MC.mont_mul_chain_kernel(x, CHAIN_K))
    long_ms = time_ms(lambda: MC.mont_mul_chain_kernel(x, CHAIN_K_LONG), reps=5, runs=3)
    products = CHAIN_N * CHAIN_K
    # the unrolled body's 32 products and the tail's one, of each chain
    mix = sass_mix(_build.library_path("montmul_chain"), "montmul_chain_kernel", 33 * MC.CHAINS)
    bound = bound_ms(2 * CHAIN_N * 64, products * MONT_MUL_OPS, int_rate)
    # None where the library was built before this run (no ptxas output)
    ptxas = (ptxas_report(logs["montmul_chain"], "montmul_chain_kernel")
             if "montmul_chain" in (logs or {}) else None)
    row = dict(kernel=MC.MONTMUL_CHAIN_KERNEL, source="zk_stark_tpu_torch/csrc/montmul_chain.cu",
               launches=launches, max_abs_err=err, shape=f"n={CHAIN_N},k={CHAIN_K}",
               ms=k_ms, plain_ms=p_ms, bound_ms=bound[0], bound_by=bound[1],
               chains_a_thread=MC.CHAINS, ragged_n=CHAIN_RAGGED_N, ptxas=ptxas,
               ops_per_product=MONT_MUL_OPS, sass_ops_per_product=mix["ops"],
               sass_imad_per_product=mix["imad"], sass_other_per_product=mix["other"],
               sass_by_opcode=mix["by_opcode"],
               ceiling_sass_ms=products * mix["ops"] / int_rate * 1e3,
               ns_per_product=k_ms * 1e6 / products, ms_long=long_ms,
               bound_ms_long=bound_ms(2 * CHAIN_N * 64, CHAIN_N * CHAIN_K_LONG * MONT_MUL_OPS,
                                      int_rate)[0],
               ceiling_sass_ms_long=CHAIN_N * CHAIN_K_LONG * mix["ops"] / int_rate * 1e3,
               ns_per_product_long=long_ms * 1e6 / (CHAIN_N * CHAIN_K_LONG))
    print(f"montmul_chain n={CHAIN_N} k={CHAIN_K}: bit-exact (and n={CHAIN_RAGGED_N} "
          f"k={CHAIN_RAGGED_K}), x^(k+1) at k={CHAIN_K} and {CHAIN_K_LONG}; {MC.CHAINS} chains a "
          f"thread; kernel {k_ms:.4f} ms ({row['ns_per_product']:.6f} ns/product), "
          f"{long_ms:.4f} ms at k={CHAIN_K_LONG} ({row['ns_per_product_long']:.6f}), plain "
          f"{p_ms:.3f} ms, bound {bound[0]:.6f} ms ({bound[1]}, {MONT_MUL_OPS} "
          f"instructions/product; {row['bound_ms_long']:.6f} at k={CHAIN_K_LONG}), "
          f"{mix['ops']:.2f} SASS instructions/product as compiled ({mix['imad']:.2f} IMAD, "
          f"{mix['other']:.2f} other; ceiling {row['ceiling_sass_ms']:.6f} / "
          f"{row['ceiling_sass_ms_long']:.6f} ms), ptxas {ptxas}, launches {launches}", flush=True)
    print(f"montmul_chain SASS by opcode a product: "
          f"{json.dumps({op: round(v, 3) for op, v in mix['by_opcode'].items()})}", flush=True)
    return row


def compress_phase(dev, int_rate: float) -> dict:
    """Phase 8b: bare compressions, the card's measured compression rate."""
    gen = torch.Generator().manual_seed(43)
    n = COMPRESS_N
    # the bench's message: a digest twice (t = 128)
    dig = torch.randint(0, 1 << 32, (2, 8, n), dtype=L.DTYPE, generator=gen).to(dev)
    bench_msg = (torch.cat([dig[0], dig[0]]), torch.cat([dig[1], dig[1]]),
                 torch.full((n,), 128, dtype=L.DTYPE, device=dev))
    # random words, random byte counts in [0, 128], zero beyond the count
    t = torch.randint(0, 129, (n,), dtype=L.DTYPE, generator=gen)
    t[:5] = torch.tensor([0, 1, 40, 127, 128])
    raw = torch.randint(0, 256, (n, 128), dtype=torch.uint8, generator=gen)
    raw[torch.arange(128)[None, :] >= t[:, None]] = 0
    rand_msg = (*B._bytes_to_words(raw.to(dev)), t.to(dev))

    err = 0
    plain_ms = {}
    for kind, msg in (("bench", bench_msg), ("random", rand_msg)):
        (ph, pl), plain_ms[kind] = timed_once(lambda: B.compress_plain(*msg))
        kh, kl = B.compress_kernel(*msg)
        err = max(err, check(f"compress {kind} n={n} hi", kh, ph), check(f"compress {kind} lo", kl, pl))
        if kind == "random":
            idx = torch.cat([torch.arange(5), torch.randint(5, n, (59,), generator=gen)])
            digests = B.words_to_digest_np(kh[:, idx.to(dev)], kl[:, idx.to(dev)])
            for row_i, i in enumerate(idx.tolist()):
                msg_bytes = raw[i, : int(t[i])].numpy().tobytes()
                require(digests[row_i].tobytes()
                        == hashlib.blake2b(msg_bytes, digest_size=64).digest(),
                        f"compress: message {i} (t = {int(t[i])}) differs from hashlib")

    B.COMPRESS_KERNEL.launches = 0
    B.compress_words(*bench_msg)
    B.compress_words(*rand_msg)
    B.node_digests_packed(torch.cat([dig, dig], dim=2))
    torch.cuda.synchronize()
    launches = B.COMPRESS_KERNEL.launches

    k_ms = time_ms(lambda: B.compress_kernel(*bench_msg))
    k_rand_ms = time_ms(lambda: B.compress_kernel(*rand_msg))
    bound = bound_ms((16 * 2 + 1 + 8 * 2) * 8 * n, n * COMPRESS_OPS, int_rate)
    row = dict(kernel=B.COMPRESS_KERNEL, source="zk_stark_tpu_torch/csrc/blake2b.cu",
               launches=launches, max_abs_err=err, shape=f"messages={n}", ms=k_ms,
               plain_ms=plain_ms["bench"], bound_ms=bound[0], bound_by=bound[1],
               ns_per_compression=k_ms * 1e6 / n, random_ms=k_rand_ms,
               random_plain_ms=plain_ms["random"])
    print(f"compress messages={n}: bit-exact (bench and random messages), 64 samples equal "
          f"hashlib (t = 0, 1, 40, 127, 128 among them); kernel {k_ms:.4f} ms "
          f"({row['ns_per_compression']:.6f} ns/compression), random messages {k_rand_ms:.4f} ms, "
          f"plain {plain_ms['bench']:.3f} ms, bound {bound[0]:.6f} ms ({bound[1]}), "
          f"launches {launches}", flush=True)
    return row


def rescue_width(dev, rp: RescuePrime, int_rate: float, ns_per_product: float,
                 sass_per_product: float, gen: torch.Generator,
                 sizes: tuple = RESCUE_SIZES) -> dict:
    """``rp``'s batched hash at ``sizes`` (RESCUE_SIZES or its first two):
    256 (entry()'s inputs) and random inputs, launches counted; the kernel
    bit for bit against the plain version at the sizes below 2^20, the host
    hash on all 256 and on 68 sampled inputs at the largest; times and
    ceilings."""
    name = "rescue" if rp.m == 2 else f"rescue m={rp.m}"
    inputs = {256: L.ints_to_mont(range(256), dev)}
    for n in sizes[1:]:
        inputs[n] = random_mont(n, gen, dev)

    R.RESCUE_KERNEL.launches = 0
    outs = {n: rp.hash_batch_device(x) for n, x in inputs.items()}
    torch.cuda.synchronize()
    launches = R.RESCUE_KERNEL.launches
    require(launches == len(sizes),
            f"{name}: {launches} launches for {len(sizes)} hash_batch_device calls")

    require([int(v) for v in L.mont_to_ints(outs[256])] == [rp.hash(x) for x in range(256)],
            f"{name}: hash_batch_device(range(256)) differs from the host hash")
    big = sizes[-1]
    idx = torch.cat([torch.arange(4), torch.randint(4, big, (64,), generator=gen)]).to(dev)
    xs = L.mont_to_ints(inputs[big][idx])
    ys = L.mont_to_ints(outs[big][idx])
    require([int(y) for y in ys] == [rp.hash(int(x)) for x in xs],
            f"{name}: hash_batch_device at {big} differs from the host hash on the samples")

    mds, rc = rp._device_constants(dev)
    per_hash, adds_per_hash = permutation_counts(rp.m, rp.N, rp.alpha, rp.alpha_inv)
    ops_per_hash = per_hash * MONT_MUL_OPS + adds_per_hash * ADD_SUB_OPS
    row = dict(kernel=R.RESCUE_KERNEL, source="zk_stark_tpu_torch/csrc/rescue.cu",
               launches=launches, launches_per_hash_batch=launches / len(sizes),
               max_abs_err=0, products_per_hash=per_hash, adds_per_hash=adds_per_hash,
               ops_per_hash=ops_per_hash, by_size={})
    for n, x in inputs.items():
        size = {}
        if n < RESCUE_SIZES[-1]:
            zeros = torch.zeros((n, rp.m - rp.capacity, L.NLIMB), dtype=L.DTYPE, device=dev)
            state = torch.cat([x.unsqueeze(1), zeros], dim=1)
            plain, size["plain_ms"] = timed_once(
                lambda: run_plain(R.permutation_plain, state, mds, rc, rp.N, rp.alpha,
                                  rp.alpha_inv))
            got = R.permutation_kernel(state, mds, rc, rp.N, rp.alpha, rp.alpha_inv)
            row["max_abs_err"] = max(row["max_abs_err"], check(f"{name} n={n}", got, plain))
            require(torch.equal(got[:, 0], outs[n]), f"{name} n={n}: hash_batch_device differs")
        reps, runs = (20, 5) if n < RESCUE_SIZES[-1] else (3, 3)
        size["ms"] = time_ms(lambda: rp.hash_batch_device(x), reps=reps, runs=runs)
        products = n * per_hash
        size["hashes_per_s"] = n / size["ms"] * 1e3
        size["ceiling_measured_ms"] = products * ns_per_product * 1e-6
        size["ceiling_issue_ms"] = n * ops_per_hash / int_rate * 1e3
        size["ceiling_sass_ms"] = products * sass_per_product / int_rate * 1e3
        size["bound_ms"], size["bound_by"] = max(
            (2 * n * rp.m * 64 / HBM_BYTES_PER_S * 1e3, "bytes"),
            (size["ceiling_issue_ms"], "operations"))
        size["plan"] = R.launch_plan(n, rp.m)
        row["by_size"][f"n={n}"] = size
        plain_txt = f"{size['plain_ms']:.1f} ms" if "plain_ms" in size else "not timed"
        print(f"{name} n={n}: kernel {size['ms']:.4f} ms ({size['hashes_per_s']:.4e} hashes/s), "
              f"plain {plain_txt}, ceilings: measured-rate "
              f"{size['ceiling_measured_ms']:.4f} ms, issue-rate {size['ceiling_issue_ms']:.4f} ms "
              f"({products:.4e} products; at the compiled SASS count "
              f"{size['ceiling_sass_ms']:.4f} ms); launch: {size['plan']}", flush=True)
    return row


def rescue_phase(dev, int_rate: float, ns_per_product: float, sass_per_product: float,
                 logs: dict | None = None) -> dict:
    """Phase 9: the batched Rescue-Prime hash at 256, 2^14 and 2^20."""
    rp = RescuePrime(Field())
    print(f"ptxas {ptxas_line(logs or {}, 'rescue')}", flush=True)
    row = rescue_width(dev, rp, int_rate, ns_per_product, sass_per_product,
                       torch.Generator().manual_seed(44))
    require(rp.hash_batch([1], device=dev) == [RESCUE_HASH_1], "hash(1) differs from the vector")
    # the headline is the largest size the plain version is timed at (at
    # 2^20 it would take minutes: ~4,700 tensor-code products of ~75 launches
    # on [2^20, 2, 8])
    head = row["by_size"][f"n={RESCUE_SIZES[1]}"]
    row.update(shape=f"n={RESCUE_SIZES[1]}", ms=head["ms"], plain_ms=head["plain_ms"],
               bound_ms=head["bound_ms"], bound_by=head["bound_by"])
    print("rescue batch " + json.dumps({k: v for k, v in row.items() if k != "kernel"}),
          flush=True)
    return row


def ints(t: torch.Tensor) -> list[int]:
    """Montgomery limbs on any device -> canonical Python ints."""
    return [int(v) for v in L.mont_to_ints(t)]


def toolkit_checks(dev, gen: torch.Generator) -> dict:
    """Phase 11a's path: the subproduct trees and the arbitrary-domain
    toolkit at the JAX package's thresholds, exact against host references;
    returns what the timings reuse."""
    field = Field()
    root = field.primitive_nth_root(TOOLKIT_ROOT_ORDER).value
    data = {}
    for k in TREE_SIZES:
        domain, coeffs, values = (random_mont(k, gen, dev) for _ in range(3))
        got = M.evaluate_tree(coeffs, domain)
        idx = torch.cat([torch.tensor([0, k - 1]),
                         torch.randint(1, k - 1, (TREE_SAMPLES - 2,), generator=gen)]).to(dev)
        poly = Polynomial(field, ints(coeffs))
        require(ints(got[idx]) == [poly.evaluate(x) for x in ints(domain[idx])],
                f"evaluate_tree k=n={k}: differs from host Horner on the samples")
        interp = M.interpolate_tree(domain, values)
        require(torch.equal(M.evaluate_tree(interp, domain), values),
                f"interpolate_tree k={k}: evaluating its coefficients misses the values")
        if k == PO.TREE_EVAL_MIN:
            require(torch.equal(PO.fast_evaluate_domain(PO.DPoly(coeffs), domain), got),
                    f"fast_evaluate_domain k=n={k} (the tree branch) differs from evaluate_tree")
            require(torch.equal(PO.evaluate_many(coeffs, domain), got),
                    f"evaluate_many k=n={k} differs from evaluate_tree")
        data[k] = (domain, coeffs, values)

    # the zerofier of 4096 points: monic, of degree k, zero on every point
    domain = data[PO.TREE_EVAL_MIN][0]
    z = PO.fast_zerofier(domain, root, TOOLKIT_ROOT_ORDER)
    require(int(PO.degree_device(z.c)) == domain.shape[0] == z.degree(),
            "fast_zerofier: wrong degree")
    require(torch.equal(z.c[-1], L.one_mont(dev)), "fast_zerofier: not monic")
    require(not PO.evaluate_many(z.c, domain).any(), "fast_zerofier: nonzero on its domain")

    # the interpolation threshold's tree branch against host Lagrange
    k = PO.TREE_INTERP_MIN
    dom_ints, val_ints = ints(random_mont(k, gen, dev)), ints(random_mont(k, gen, dev))
    got = PO.fast_interpolate_domain(None, dom_ints, val_ints, root, TOOLKIT_ROOT_ORDER, device=dev)
    t0 = time.perf_counter()
    want = Polynomial.interpolate_domain(Field(), dom_ints, val_ints).coeffs
    data["lagrange_ms"] = (time.perf_counter() - t0) * 1e3
    require(got.to_ints() == want,
            f"fast_interpolate_domain k={k} (the tree branch) differs from host Lagrange")
    data[k] = (L.ints_to_mont(dom_ints, dev), L.ints_to_mont(val_ints, dev))
    return data


def peak_gb(fn) -> float:
    """Peak device memory one call of ``fn`` adds to what the process holds
    already, GB."""
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - held) / 1e9


def call_launches(fn, kernels) -> dict:
    """Launches of ``kernels`` in one call of ``fn`` (those above 0)."""
    before = [k.launches for k in kernels]
    fn()
    torch.cuda.synchronize()
    return {k.name: k.launches - c for k, c in zip(kernels, before) if k.launches != c}


def toolkit_phase(dev) -> dict:
    """Phase 11a: the trees and the toolkit (ops/multipoint.py,
    ops/poly_ops.py) checked with every count reset just before and read
    just after; then each branch timed at the thresholds and at 2^14."""
    path_kernels = [N.NTT_KERNEL, N.NTT_TW_KERNEL, *L.KERNELS]
    other = [B.LEAF_KERNEL, B.NODE_KERNEL, FO.FOLD_KERNEL, N.NTT_LONG_TW_KERNEL, N.NTT_LONG_KERNEL]
    for k in _build.Kernel.instances:
        k.launches = 0
    t0 = time.perf_counter()
    data = toolkit_checks(dev, torch.Generator().manual_seed(46))
    torch.cuda.synchronize()
    checks_s = time.perf_counter() - t0
    launches = {k.name: k.launches for k in _build.Kernel.instances if k.launches}
    for k in (N.NTT_KERNEL, N.NTT_TW_KERNEL, L.MONT_MUL_KERNEL, L.ADD_MOD_KERNEL,
              L.SUB_MOD_KERNEL, L.BATCH_INV_KERNEL):
        require(launches.get(k.name, 0) > 0, f"toolkit: kernel {k.name} was not launched")
    for k in other:
        require(k.launches == 0, f"toolkit: kernel {k.name} launched {k.launches} times")
    print(f"toolkit checks: evaluate_tree at k=n={TREE_SIZES} equals host Horner on "
          f"{TREE_SAMPLES} samples, the interpolate -> evaluate round trip returns the values, "
          f"at {PO.TREE_EVAL_MIN} the tree equals evaluate_many and fast_evaluate_domain; "
          f"fast_zerofier({PO.TREE_EVAL_MIN}) monic, degree {PO.TREE_EVAL_MIN}, zero on its "
          f"domain; fast_interpolate_domain({PO.TREE_INTERP_MIN}) (tree branch) equals host "
          f"Lagrange; {checks_s:.1f} s; launches {json.dumps(launches)}", flush=True)

    timed = {}
    for k in TREE_SIZES:
        domain, coeffs, values = data[k]
        interp = M.interpolate_tree(domain, values)
        entry = {}
        for name, fn in (("evaluate_tree", lambda: M.evaluate_tree(coeffs, domain)),
                         ("interpolate_tree", lambda: M.interpolate_tree(domain, values)),
                         ("evaluate_many", lambda: PO.evaluate_many(coeffs, domain))):
            torch.cuda.empty_cache()
            entry[f"{name}_launches"] = call_launches(fn, path_kernels)
            entry[f"{name}_peak_gb"] = peak_gb(fn)
            entry[f"{name}_ms"] = time_ms(fn, reps=1 if name == "evaluate_many" else 3, runs=3)
        require(torch.equal(M.evaluate_tree(interp, domain), values), f"k={k}: round trip")
        timed[f"k=n={k}"] = entry
        print(f"toolkit k=n={k}: " + json.dumps(entry), flush=True)
    domain, values = data[PO.TREE_INTERP_MIN]
    fn = lambda: M.interpolate_tree(domain, values)  # noqa: E731
    timed[f"k={PO.TREE_INTERP_MIN}"] = {
        "interpolate_tree_ms": time_ms(fn, reps=3, runs=3),
        "interpolate_tree_launches": call_launches(fn, path_kernels),
        "interpolate_tree_peak_gb": peak_gb(fn),
        "lagrange_host_ms": data["lagrange_ms"],
    }
    print(f"toolkit k={PO.TREE_INTERP_MIN}: " + json.dumps(timed[f"k={PO.TREE_INTERP_MIN}"]),
          flush=True)
    return {"launches": launches, "checks_s": checks_s, "timed": timed}


def ptxas_by_width(logs: dict) -> dict:
    """Registers and spill bytes of each rescue_kernel<m> instantiation, from
    ptxas's -v output."""
    out, m = {}, None
    for line in logs.get("rescue", "").splitlines():
        found = re.search(r"Compiling entry function '\w*rescue_kernelILi(\d+)E", line)
        if found:
            m = int(found.group(1))
            out[f"m={m}"] = {}
        elif m is not None and "spill stores" in line:
            out[f"m={m}"]["spill_bytes"] = sum(int(v) for v in re.findall(r"(\d+) bytes spill", line))
        elif m is not None and "Used" in line and "registers" in line:
            out[f"m={m}"]["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
            m = None
    return out


def rescue_widths_phase(dev, int_rate: float, rescue: dict, mm: dict, logs: dict) -> dict:
    """Phase 11b: the batched hash at the state widths 3 and 4 (capacity 1),
    as phase 9 runs m = 2, and at 5 to 8 at 256 and 2^14."""
    widths = ptxas_by_width(logs)
    print(f"rescue instantiations (ptxas): {json.dumps(widths)}", flush=True)
    by_width = {"m=2": rescue["by_size"]}
    for m in RESCUE_WIDTHS + RESCUE_CHECK_WIDTHS:
        sizes = RESCUE_SIZES if m in RESCUE_WIDTHS else RESCUE_SIZES[:2]
        row = rescue_width(dev, RescuePrime(Field(), m=m), int_rate, mm["ns_per_product"],
                           mm["sass_ops_per_product"], torch.Generator().manual_seed(47 + m),
                           sizes)
        by_width[f"m={m}"] = dict(row["by_size"], launches=row["launches"],
                                  max_abs_err=row["max_abs_err"],
                                  products_per_hash=row["products_per_hash"])
        rescue["max_abs_err"] = max(rescue["max_abs_err"], row["max_abs_err"])
    return {"by_width": by_width, "ptxas": widths}


def fft_phase(dev) -> dict:
    """Phase 11c: the complex FFT tier (ops/fft.py) on the card: the golden
    vector, and a random 2^12-point signal against numpy.fft within
    FFT_ATOL."""
    for fn in (FFT.fft, FFT.dft):
        freqs = fn(FFT_SIGNAL, device=dev)
        got = [(round(float(f.real), 3) + 0.0, round(float(f.imag), 3) + 0.0) for f in freqs]
        require(got == FFT_GOLDEN, f"{fn.__name__}: the golden vector differs: {got}")
    x = np.random.default_rng(48).standard_normal(FFT_N).astype(np.float32)
    want = np.fft.fft(x)
    row = {}
    for fn in (FFT.fft, FFT.dft):
        err = float(np.abs(fn(x, device=dev) - want).max())
        require(err <= FFT_ATOL, f"{fn.__name__} n={FFT_N}: max abs error {err} > {FFT_ATOL}")
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(x, device=dev)
            times.append((time.perf_counter() - t0) * 1e3)
        row[fn.__name__] = {"max_abs_err": err, "host_ms": statistics.median(times)}
    print(f"fft: the golden vector (fft, dft); n={FFT_N} against numpy.fft.fft within "
          f"{FFT_ATOL}: {json.dumps(row)}", flush=True)
    return row


def profiling_phase(dev, signer) -> dict:
    """Phase 11d: a warm default-config sign under a StageTimer (its
    report), then one verify inside device_trace (its Chrome trace)."""
    rpsss, sk, pk, doc = signer
    rpsss.sign(sk, doc)  # warm: phase 7a cleared the segment caches
    timer = StageTimer(dev)
    rpsss.stark.timer = timer
    try:
        sig = rpsss.sign(sk, doc)
    finally:
        rpsss.stark.timer = None
    require(set(timer.totals) == PROVE_STAGES, f"stage timer: stages {sorted(timer.totals)}")
    print("stage timer, warm default-config sign:\n" + timer.report(), flush=True)
    with tempfile.TemporaryDirectory() as logdir:
        with device_trace(logdir):
            ok = rpsss.verify(pk, doc, sig)
        (trace,) = pathlib.Path(logdir).glob("trace_*.json")
        events = json.loads(trace.read_text())["traceEvents"]
        kernels = sum(1 for e in events if e.get("cat") == "kernel")
        size = trace.stat().st_size
    require(ok, "the timed signature was rejected")
    require(kernels > 0, "device_trace: no kernel in the trace of a verify")
    print(f"device_trace: one verify, {size} B, {len(events)} events, {kernels} kernels",
          flush=True)
    return {"stages_ms": {k: v * 1e3 for k, v in timer.totals.items()}, "trace_bytes": size,
            "trace_kernels": kernels}


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device: the port's smoke test needs an NVIDIA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}", flush=True)

    rpsss_kernels = [N.NTT_KERNEL, FO.FOLD_KERNEL, B.LEAF_KERNEL, B.NODE_KERNEL, *L.KERNELS]
    chain_kernels = rpsss_kernels + [N.NTT_TW_KERNEL]
    long_kernels = [N.NTT_LONG_TW_KERNEL, N.NTT_LONG_KERNEL, *NV.VARIANT_KERNELS.values()]
    hash_kernels = [MC.MONTMUL_CHAIN_KERNEL, B.COMPRESS_KERNEL, R.RESCUE_KERNEL]
    t0 = time.perf_counter()
    logs = _build.build(sorted({k.library for k in chain_kernels + long_kernels + hash_kernels}))
    build_s = time.perf_counter() - t0
    for name in logs:
        print(f"build {ptxas_line(logs, name)}", flush=True)
    print(f"build: {len(logs)} libraries in {build_s:.1f} s", flush=True)

    int_rate = int32_ops_per_s()
    print(f"int32 peak: {int_rate:.4e} instructions/s", flush=True)
    product = product_phase(dev)
    limb_rows = limb_phase(dev, int_rate, logs)
    limb_rows["limbs_mont_inv_fermat"] = inversion_phase(dev, int_rate)
    limb_rows["limbs_batch_inv"] = batch_inv_phase(dev, int_rate)
    rows = compare_kernels(dev, int_rate, logs)
    rows.update(limb_rows)
    fixture_phase(dev)
    main, signer = main_path(dev, rpsss_kernels)
    main["profile"] = profile_phase(*signer)
    chain_fixture_phase(dev)
    chain = chain_path(dev, chain_kernels)
    main["segments"] = segment_phase(dev)
    dist_result = dist_phase(dev, chain_kernels)
    long_ntt = long_ntt_phase(dev, int_rate, logs)
    variants = probe_phase(dev)
    mm = montmul_chain_phase(dev, int_rate, logs)
    comp = compress_phase(dev, int_rate)
    rescue = rescue_phase(dev, int_rate, mm["ns_per_product"], mm["sass_ops_per_product"], logs)
    toolkit = toolkit_phase(dev)
    rescue.update(rescue_widths_phase(dev, int_rate, rescue, mm, logs))
    fft_row = fft_phase(dev)
    prof = profiling_phase(dev, signer)
    # the leaf and node rows beside the measured compression rate (a tree
    # of n leaves is n - 1 compressions)
    for name in ("leaf", "node"):
        for size, entry in rows[name]["by_size"].items():
            kind, count = size.split("=")
            count = int(count) - (kind == "leaves")
            entry["compress_ceiling_ms"] = count * comp["ns_per_compression"] * 1e-6
        rows[name]["compress_ceiling_ms"] = entry["compress_ceiling_ms"]
    # the node and fold kernels' device time over a whole path beside the
    # bound of the trees and folds that path made
    for path, prof in (("sign", main["profile"]["sign"]), ("chain prove", chain["profile"])):
        prof["node_bound_ms"] = sum(tree_bound(n, int_rate)[0] for n in prof["tree_leaves"])
        prof["fold_bound_ms"] = sum(fold_bound(n, int_rate)[0] for n in prof["fold_lengths"])
        print(f"{path} path: node {prof['node_kernel'][0]:.4f} ms in {prof['node_kernel'][1]} "
              f"launches ({len(prof['tree_leaves'])} trees of {sorted(prof['tree_leaves'])} "
              f"leaves), bound {prof['node_bound_ms']:.4f} ms; fold {prof['fold_kernel'][0]:.4f} "
              f"ms in {prof['fold_kernel'][1]} launches (codewords "
              f"{sorted(prof['fold_lengths'])}), bound {prof['fold_bound_ms']:.4f} ms", flush=True)
        for name in ("node", "fold"):
            rows[name][f"{path.replace(' ', '_')}_path"] = {
                "device_ms": prof[f"{name}_kernel"][0], "launches": prof[f"{name}_kernel"][1],
                "bound_ms": prof[f"{name}_bound_ms"]}
    for row in rows.values():
        row["launches"] = chain["launches"][row["kernel"].name]
    rows["ntt_four_step"]["by_size"].update(long_ntt["four_step_by_size"])
    rows["ntt_long"] = long_ntt["ntt_long"]
    rows.update(variants)
    rows.update(montmul_chain=mm, compress=comp, rescue=rescue)

    table = []
    for name, row in rows.items():
        k = row["kernel"]
        entry = {
            "name": name,
            "route": "cuda",
            "source": row["source"],
            "replaces": row.get("replaces", k.replaces),
            "launches": row["launches"],
            "launches_rpsss_sign": main["launches"].get(k.name, 0),
            "launches_dist_sign": dist_result["sign_launches"].get(k.name, 0),
            "launches_dist_chain_prove": dist_result["chain_launches"].get(k.name, 0),
            "launches_toolkit": toolkit["launches"].get(k.name, 0),
            "max_abs_err": row["max_abs_err"],
            "bit_exact": row["max_abs_err"] == 0,
            "shape": row["shape"],
            "ms": row["ms"],
            "kernel_ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": None,
        }
        entry.update({key: v for key, v in row.items() if key not in entry and key != "kernel"})
        table.append(entry)
    print(json.dumps({"main_path": main, "chain_path": chain, "dist": dist_result, "card": card,
                      "product": product, "build_s": build_s, "int32_ops_per_s": int_rate,
                      "toolkit": toolkit, "fft": fft_row, "profiling": prof}))
    print(f"card: {card}")
    print(json.dumps({"kernels": table}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
