"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught):

1. the card's name and power limit (nvidia-smi);
2. build the CUDA kernels of zk_stark_tpu_torch/csrc in parallel;
3. each kernel against its plain PyTorch version on the card, bit for bit,
   with both times (CUDA events, median): at the signature's shapes, then
   at the chain's (the four-step NTT, fused-twiddle mode, at 2^18 and 2^20
   against the flat plain transform, forward and inverse; fold and leaf at
   2^20; node at 2^19 parents);
4. the fixture-config signature with the deterministic rng: its sha256
   equals tests/fixtures/meta.json's, it verifies, tampered copies fail;
5. the RPSSS path: keygen -> sign -> verify at the default config
   (expansion 4, 64 checks, security 128), cold and then warm, with every
   kernel's launch count reset just before the warm sign and read just
   after it; the proof is 1,156,888 bytes, verifies, and a wrong document
   is rejected; then one more sign and verify under torch.profiler (stage
   host times, device busy time and idle share, device time by kernel);
6. the chain fixture (tests/fixtures/chain_meta.json, FRI 2^14) reproduced
   byte for byte on the card; it verifies and a wrong output is rejected;
7. the chain path: the Rescue-permutation chain of length 3200 (FRI 2^20):
   host trace, one cold prove, one warm prove with every kernel's launch
   count reset just before and read just after (and two more warm proves
   for the median time), one verify, one verify against a wrong output
   that must be rejected; the proof is 3,430,752 bytes; then one more warm
   prove under torch.profiler;
8. the numbers, the card line, the kernel table as one JSON line, and last
   the result line {"ok": true, "device": {...}}.

Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import hashlib
import json
import pathlib
import statistics
import subprocess
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

from zk_stark_tpu_torch.carry import DetRng, chain_from_config, rpsss_from_config  # noqa: E402
from zk_stark_tpu_torch.field import Field  # noqa: E402
from zk_stark_tpu_torch.models.rescue_chain import make_chain_stark  # noqa: E402
from zk_stark_tpu_torch.models.rpsss import RPSSS  # noqa: E402
from zk_stark_tpu_torch.proof_stream import ProofStream  # noqa: E402
from zk_stark_tpu_torch.stark import VerificationError  # noqa: E402
from zk_stark_tpu_torch.ops import _build  # noqa: E402
from zk_stark_tpu_torch.ops import blake2b as B  # noqa: E402
from zk_stark_tpu_torch.ops import fold as FO  # noqa: E402
from zk_stark_tpu_torch.ops import limbs as L  # noqa: E402
from zk_stark_tpu_torch.ops import ntt as N  # noqa: E402

#: HBM bytes/s of one H100 SXM (published datasheet)
HBM_BYTES_PER_S = 3.35e12
#: thread-instructions an SM can issue per clock on sm_90: 4 schedulers,
#: each one warp instruction (32 lanes) per clock.  No mix of integer
#: instructions runs faster (integer multiply-adds go to the FMA pipe, the
#: rest to the 64-lane ALU pipe), so SMs x this x the card's maximum SM clock
#: is a ceiling of the integer rate and the bound derived from it a floor
ISSUE_LANES_PER_SM = 128

#: 32-bit integer instructions per field operation on 4 words of 32 bits
#: (CIOS product: 16 wide products = 32 multiplies plus ~45 carry adds and
#: the reduction's multiplies; add/sub: 4 add-with-carry, 4 subtract, 4
#: selects and flags) and per BLAKE2b compression (96 G mixes of 6 64-bit
#: adds, 4 xors and 4 rotates, 2 instructions each, plus finalisation)
MONT_MUL_OPS = 80
ADD_SUB_OPS = 16
COMPRESS_OPS = 96 * 28 + 16
DECIMAL_OPS = 600  # 20 128-bit divisions by 10^9, 45 digits, packing

MAIN_PROOF_BYTES = 1_156_888
#: the chain of BASELINE.md config 5: omicron domain 2^18, FRI domain 2^20;
#: the JAX package's proof length for it (CHAIN_FULL_r04.json)
CHAIN_LENGTH = 3200
CHAIN_PROOF_BYTES = 3_430_752


def require(cond, message: str) -> None:
    """A check of a phase; raises (unlike assert, it survives python -O)."""
    if not cond:
        raise RuntimeError(message)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def int32_ops_per_s() -> float:
    """The card's peak rate of 32-bit integer instructions (its issue rate)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    mhz = float(out.stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * ISSUE_LANES_PER_SM * mhz * 1e6


def time_ms(fn, reps: int = 20, runs: int = 5) -> float:
    """Median over ``runs`` of the mean time of ``reps`` calls (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        samples.append(start.elapsed_time(end) / reps)
    return statistics.median(samples)


def bound_ms(nbytes: int, ops: int, int_rate: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / int_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def random_mont(n: int, gen: torch.Generator, dev) -> torch.Tensor:
    """n random field elements as [n, 8] limbs on ``dev``: the top limb
    below p's keeps each value below p (a valid canonical or Montgomery
    value)."""
    limbs = torch.randint(0, 1 << 16, (n, L.NLIMB), dtype=L.DTYPE, generator=gen)
    limbs[:, -1] %= L.P_LIMBS[-1]
    return limbs.to(dev)


def ntt_bound(n: int, int_rate: float, four_step: bool) -> tuple[float, str]:
    """Input and output once as int64 limbs plus the 16-byte stage twiddle
    words; the butterflies, and with the four-step one product per element.
    The four-step's [c, r] twiddle table is not counted: it is this design's
    choice, and a kernel that formed root^(i2 * k1) from the small stage
    tables would not read it."""
    log2n = n.bit_length() - 1
    if four_step:
        r, c = N.four_step_split(n)
        nbytes = 2 * n * 64 + (r // 2 + c // 2) * 16
    else:
        nbytes = 2 * n * 64 + n // 2 * 16
    ops = log2n * n // 2 * (MONT_MUL_OPS + 2 * ADD_SUB_OPS) + (n * MONT_MUL_OPS if four_step else 0)
    return bound_ms(nbytes, ops, int_rate)


def fold_bound(n: int, int_rate: float) -> tuple[float, str]:
    return bound_ms(n * 64 + n // 2 * 64 + 2 * 64 + n * 64,
                    n // 2 * (4 * MONT_MUL_OPS + 3 * ADD_SUB_OPS), int_rate)


def leaf_bound(n: int, int_rate: float) -> tuple[float, str]:
    return bound_ms(n * 64 + n * 64, n * (COMPRESS_OPS + DECIMAL_OPS), int_rate)


def node_bound(m: int, int_rate: float) -> tuple[float, str]:
    return bound_ms(2 * m * 64 + m * 64, m * COMPRESS_OPS, int_rate)


def check(name, got, ref) -> int:
    err = max_abs_err(got, ref)
    require(err == 0 and torch.equal(got, ref), f"{name}: kernel differs from its plain version")
    return err


def compare_kernels(dev, int_rate: float) -> dict:
    """Phase 3: each kernel against its plain version at the RPSSS path's
    shapes and at the chain's.  Returns one row per kernel (mode), each
    with its times at every size in ``by_size`` and its largest size as
    the headline (launches are filled in later)."""
    gen = torch.Generator().manual_seed(1234)
    F = Field()
    rows = {}

    def record(name, kernel, size, err, k_ms, p_ms, bound):
        row = rows.setdefault(name, dict(kernel=kernel, max_abs_err=0, by_size={}))
        row.update(shape=size, max_abs_err=max(row["max_abs_err"], err), ms=k_ms,
                   plain_ms=p_ms, bound_ms=bound[0], bound_by=bound[1])
        row["by_size"][size] = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": bound[0],
                                "bound_by": bound[1]}
        print(f"{name} {size}: bit-exact, kernel {k_ms:.4f} ms, plain {p_ms:.3f} ms, "
              f"bound {bound[0]:.6f} ms ({bound[1]})", flush=True)

    # the single-block mode (RPSSS sizes), then the four-step with the
    # fused-twiddle first pass (chain sizes), both against the flat plain
    # transform, forward and inverse root
    for n in (512, 1024, 4096, 1 << 18, 1 << 20):
        x = random_mont(n, gen, dev)
        root = F.primitive_nth_root(n).value
        inv_root = pow(root, -1, L.P)
        four_step = n > N.MAX_KERNEL_N
        err = check(f"ntt n={n}", N.ntt_kernel(x, root), N.ntt_plain(x, root))
        err += check(f"intt n={n}", N.ntt_kernel(x, inv_root), N.ntt_plain(x, inv_root))
        if four_step:
            err += check(f"four-step plain n={n}", N.ntt_passes_plain(x, root),
                         N.ntt_plain(x, root))
        k_ms = time_ms(lambda: N.ntt_kernel(x, root))
        p_ms = time_ms(lambda: N.ntt_plain(x, root), reps=2 if four_step else 3, runs=3)
        name, kernel = ("ntt_four_step", N.NTT_TW_KERNEL) if four_step else ("ntt", N.NTT_KERNEL)
        record(name, kernel, f"n={n}", err, k_ms, p_ms, ntt_bound(n, int_rate, four_step))

    for n in (4096, 1 << 20):
        cw = random_mont(n, gen, dev)
        omega = F.primitive_nth_root(n).value
        invpows = N.powers_mont(pow(omega, -1, L.P), n // 2, dev)
        ao = L.int_to_mont(987654321987654321 % L.P, dev)
        ti = L.int_to_mont(pow(2, -1, L.P), dev)
        kf, kc = FO.fold_kernel(cw, invpows, ao, ti)
        pf, pc = FO.fold_plain(cw, invpows, ao, ti)
        err = max(check(f"fold n={n} folded", kf, pf), check(f"fold n={n} canon", kc, pc))
        k_ms = time_ms(lambda: FO.fold_kernel(cw, invpows, ao, ti))
        p_ms = time_ms(lambda: FO.fold_plain(cw, invpows, ao, ti), reps=5, runs=3)
        record("fold", FO.FOLD_KERNEL, f"n={n}", err, k_ms, p_ms, fold_bound(n, int_rate))

        canon = L.from_mont(cw)
        err = check(f"leaf n={n}", B.leaf_kernel(canon), B.leaf_digests_plain(canon))
        k_ms = time_ms(lambda: B.leaf_kernel(canon))
        p_ms = time_ms(lambda: B.leaf_digests_plain(canon), reps=3, runs=3)
        record("leaf", B.LEAF_KERNEL, f"n={n}", err, k_ms, p_ms, leaf_bound(n, int_rate))

        level = B.leaf_kernel(canon)  # n digests -> n/2 parents
        m = n // 2
        err = check(f"node parents={m}", B.node_kernel(level), B.node_digests_plain(level))
        k_ms = time_ms(lambda: B.node_kernel(level))
        p_ms = time_ms(lambda: B.node_digests_plain(level), reps=3, runs=3)
        record("node", B.NODE_KERNEL, f"parents={m}", err, k_ms, p_ms, node_bound(m, int_rate))
    torch.cuda.synchronize()
    rows["ntt"]["source"] = rows["ntt_four_step"]["source"] = "zk_stark_tpu_torch/csrc/ntt.cu"
    rows["fold"]["source"] = "zk_stark_tpu_torch/csrc/fold.cu"
    rows["leaf"]["source"] = rows["node"]["source"] = "zk_stark_tpu_torch/csrc/blake2b.cu"
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


def main_path(dev, kernels) -> tuple[dict, tuple]:
    """Phase 5: default-config keygen -> sign -> verify, cold then warm."""
    doc = b"attack at dawn"
    rpsss = RPSSS(Field(), device=dev, rng=DetRng(b"chip-smoke"))
    sk, pk = rpsss.keygen()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sig_cold = rpsss.sign(sk, doc)
    torch.cuda.synchronize()
    cold_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    ok_cold = rpsss.verify(pk, doc, sig_cold)
    torch.cuda.synchronize()
    verify_cold_ms = (time.perf_counter() - t0) * 1e3

    for k in kernels:
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sig = rpsss.sign(sk, doc)
    torch.cuda.synchronize()
    sign_ms = (time.perf_counter() - t0) * 1e3
    launches = {k.symbol: k.launches for k in kernels}

    t0 = time.perf_counter()
    ok = rpsss.verify(pk, doc, sig)
    torch.cuda.synchronize()
    verify_ms = (time.perf_counter() - t0) * 1e3

    require(len(sig_cold) == MAIN_PROOF_BYTES, f"cold proof is {len(sig_cold)} B")
    require(len(sig) == MAIN_PROOF_BYTES, f"proof is {len(sig)} B")
    require(ok_cold and ok, "default-config signature rejected")
    require(not rpsss.verify(pk, b"attack at dusk", sig), "wrong document accepted")
    for name, count in launches.items():
        require(count > 0, f"kernel {name} was not launched by the sign")
    result = dict(sign_ms=sign_ms, verify_ms=verify_ms, sign_cold_ms=cold_ms,
                  verify_cold_ms=verify_cold_ms, proof_bytes=len(sig),
                  launches=launches)
    print("main path " + json.dumps(result), flush=True)
    return result, (rpsss, sk, pk, doc)


def profiled(fn) -> dict:
    """Run ``fn`` once under torch.profiler: its wall time, the host time of
    the prover's and verifier's record_function spans ("stark.*"), the
    device's busy time (sum of kernel and copy durations; one stream, so no
    overlap) and idle share, and the device time by kernel name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
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
    return {
        "wall_ms": wall_ms,
        "device_busy_ms": busy_us / 1e3,
        "device_idle_share": 1.0 - busy_us / 1e3 / wall_ms,
        "device_launches": sum(c for _, c in by_kernel.values()),
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

    torch.cuda.reset_peak_memory_stats()
    proof_cold, cold_ms = prove()
    for k in kernels:
        k.launches = 0
    proof, warm_ms = prove()
    launches = {k.symbol: k.launches for k in kernels}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # two more warm proves: host time on a shared machine spreads
    warm_runs = [warm_ms] + [prove()[1] for _ in range(2)]

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ok = not rejects(stark, air, boundary, proof)
    torch.cuda.synchronize()
    verify_ms = (time.perf_counter() - t0) * 1e3
    verify_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    t0 = time.perf_counter()
    wrong_rejected = rejects(stark, air, model.boundary_constraints(y + 1), proof)
    torch.cuda.synchronize()
    verify_wrong_ms = (time.perf_counter() - t0) * 1e3

    require(len(proof_cold) == CHAIN_PROOF_BYTES, f"cold chain proof is {len(proof_cold)} B")
    require(len(proof) == CHAIN_PROOF_BYTES, f"chain proof is {len(proof)} B")
    require(ok, "chain proof rejected")
    require(wrong_rejected, "chain proof accepted for a wrong output")
    for name, count in launches.items():
        require(count > 0, f"kernel {name} was not launched by the chain prove")
    result = dict(chain_length=CHAIN_LENGTH, fri_domain_length=stark.fri.domain_length,
                  trace_host_ms=trace_ms, prove_cold_ms=cold_ms,
                  prove_ms=statistics.median(warm_runs), prove_ms_runs=warm_runs,
                  verify_ms=verify_ms, verify_wrong_output_ms=verify_wrong_ms,
                  proof_bytes=len(proof), prove_peak_gb=peak_gb,
                  verify_peak_gb=verify_peak_gb, launches=launches)
    print("chain path " + json.dumps(result), flush=True)
    result["profile"] = profiled(
        lambda: stark.prove(trace, air, boundary, ProofStream(stark.field)))
    print(json.dumps({"chain_profile": result["profile"]}), flush=True)
    return result


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device: the port's smoke test needs an NVIDIA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}", flush=True)

    rpsss_kernels = [N.NTT_KERNEL, FO.FOLD_KERNEL, B.LEAF_KERNEL, B.NODE_KERNEL]
    chain_kernels = rpsss_kernels + [N.NTT_TW_KERNEL]
    t0 = time.perf_counter()
    logs = _build.build(sorted({k.library for k in chain_kernels}))
    build_s = time.perf_counter() - t0
    for name, log in logs.items():
        ptxas = [ln for ln in log.splitlines() if "registers" in ln or "spill" in ln]
        print(f"build {name}: " + " | ".join(x.strip() for x in ptxas), flush=True)
    print(f"build: {len(logs)} libraries in {build_s:.1f} s", flush=True)

    int_rate = int32_ops_per_s()
    print(f"int32 peak: {int_rate:.4e} instructions/s", flush=True)
    rows = compare_kernels(dev, int_rate)
    fixture_phase(dev)
    main, signer = main_path(dev, rpsss_kernels)
    main["profile"] = profile_phase(*signer)
    chain_fixture_phase(dev)
    chain = chain_path(dev, chain_kernels)

    table = []
    for name, row in rows.items():
        k = row["kernel"]
        table.append({
            "name": name,
            "route": "cuda",
            "source": row["source"],
            "replaces": k.replaces,
            "launches": chain["launches"][k.symbol],
            "launches_rpsss_sign": main["launches"].get(k.symbol, 0),
            "max_abs_err": row["max_abs_err"],
            "bit_exact": row["max_abs_err"] == 0,
            "shape": row["shape"],
            "ms": row["ms"],
            "kernel_ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": None,
            "by_size": row["by_size"],
        })
    print(json.dumps({"main_path": main, "chain_path": chain, "card": card,
                      "build_s": build_s, "int32_ops_per_s": int_rate}))
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
