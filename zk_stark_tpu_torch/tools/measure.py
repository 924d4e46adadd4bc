"""What the card's measurements share: its name and power limit, its peak
rates, kernel times with CUDA events, and the bounds (the least time the
card could take for a function's bytes or its integer instructions).

Used by ``chip_smoke.py`` and the probes under ``tools/``; every function
that reads the card needs one.
"""

from __future__ import annotations

import collections
import re
import shutil
import statistics
import subprocess

import torch

from ..ops import _build
from ..ops import ntt as N

#: HBM bytes/s of one H100 SXM (published datasheet)
HBM_BYTES_PER_S = 3.35e12
#: thread-instructions an SM can issue per clock on sm_90: 4 schedulers,
#: each one warp instruction (32 lanes) per clock.  No mix of integer
#: instructions runs faster (integer multiply-adds go to the FMA pipe, the
#: rest to the 64-lane ALU pipe), so SMs x this x the card's maximum SM clock
#: is a ceiling of the integer rate and the bound derived from it a floor
ISSUE_LANES_PER_SM = 128


def mont_mul_ops() -> int:
    """32-bit integer instructions of one Montgomery product as
    csrc/field.cuh writes it: the PTX instructions of ``mont_mul``'s asm
    block, counted from the source (64: 35 for the 4x4-word schoolbook
    product as multiply-add carry chains, 19 for the reduction through p's
    shape, 10 for the conditional subtraction of p).  A multiply-add with
    carry, an add with carry, a subtract with borrow, a compare and a select
    is one instruction each.  The same count for every kernel's bound; the
    compiled code's count is a separate diagnostic (:func:`sass_mix`).
    """
    src = (_build.CSRC / "field.cuh").read_text()
    block = src[src.index("// mont_mul PTX begin"):src.index("// mont_mul PTX end")]
    return len(re.findall(r'"[a-z][a-z0-9.]* [^"]*;\\n\\t"', block))


#: 32-bit integer instructions per field operation on 4 words of 32 bits
#: (product: 64, see mont_mul_ops; add/sub: 4 add-with-carry, 4 subtract,
#: 4 selects and flags)
MONT_MUL_OPS = mont_mul_ops()
ADD_SUB_OPS = 16


#: SASS opcodes that are not the arithmetic of a product: memory, control,
#: special-register reads
NON_ARITH = {"LDG", "STG", "LD", "ST", "LDS", "STS", "LDL", "STL", "LDC", "ULDC",
             "BRA", "EXIT", "BAR", "NOP", "RET", "CALL", "BSSY", "BSYNC",
             "WARPSYNC", "JMP", "S2R", "S2UR", "CS2R"}


def sass_mix(library, function: str, bodies: int) -> dict:
    """The compiled instructions of ``function`` (in the shared library
    ``library``, read with ``cuobjdump -sass``) per product body, for a
    kernel whose code is ``bodies`` Montgomery products and little else:
    ``ops`` every instruction but memory, control and special-register reads
    (moves, the loads' repacking and the loop are counted too); ``imad``
    the integer multiply-adds (``IMAD*``, issued to the FMA pipe) and
    ``other`` the rest of ``ops`` (the integer ALU pipe's adds, logic,
    shifts, selects, ...); ``by_opcode`` each opcode's count.  A diagnostic
    of the code generation beside :data:`MONT_MUL_OPS`, never a bound."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run(
        [tool, "-sass", "-fun", function, str(library)],
        check=True, capture_output=True, text=True, timeout=120,
    ).stdout
    ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)", out)
    if len(ops) <= bodies * 40:
        raise RuntimeError(f"SASS of {function}: only {len(ops)} instructions for {bodies} "
                           "product bodies")
    arith = [op for op in ops if op.split(".")[0] not in NON_ARITH]
    imad = sum(op.startswith("IMAD") for op in arith)
    return {"ops": len(arith) / bodies, "imad": imad / bodies,
            "other": (len(arith) - imad) / bodies,
            "by_opcode": {op: k / bodies
                          for op, k in collections.Counter(arith).most_common()}}


def ptxas_report(log: str, kernel: str) -> dict:
    """The registers, spill bytes (stores and loads) and stack frame that
    ptxas's ``-v`` output ``log`` gives ``kernel``."""
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if line.rstrip().endswith(f"Function properties for {kernel}"):
            props = lines[i + 1]
            regs = next(ln for ln in lines[i + 2:] if "Used" in ln and "registers" in ln)
            return {"registers": int(re.search(r"Used (\d+) registers", regs).group(1)),
                    "spill_bytes": sum(int(v) for v in re.findall(r"(\d+) bytes spill", props)),
                    "stack_bytes": int(re.search(r"(\d+) bytes stack frame", props).group(1))}
    raise RuntimeError(f"ptxas printed no properties for {kernel}")


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
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


#: clock cycles the card sleeps a call before a queued timing: ~200 us at
#: the H100's ~2 GHz, more than a call's host time
QUEUE_CYCLES = 400_000


def time_ms(fn, reps: int = 20, runs: int = 5, queued: bool = False) -> float:
    """Median over ``runs`` of the mean time of ``reps`` calls (CUDA events).

    ``queued``: the card first sleeps while the host enqueues the calls, so
    that they run back to back and a call whose host time exceeds its device
    time is timed on the device all the same."""
    fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if queued:
            torch.cuda._sleep(QUEUE_CYCLES * reps)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        samples.append(start.elapsed_time(end) / reps)
    return statistics.median(samples)


def bound_ms(nbytes: int, ops: int, int_rate: float) -> tuple[float, str]:
    """The larger of the bytes' time at the HBM rate and the instructions'
    at ``int_rate``, and which of the two it is."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / int_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ntt_bound(n: int, int_rate: float, batch: int = 1) -> tuple[float, str]:
    """``batch`` transforms of n points as ``ops.ntt`` runs them: input and
    output once as int64 limbs plus each pass's 16-byte stage twiddle
    words; the log2(n) * n / 2 butterflies of a radix-2 transform.  The
    four-step's fused twiddles are not counted, neither their tables nor
    their products: the split is this design's choice, and a radix-2
    transform needs neither."""
    log2n = n.bit_length() - 1
    passes = N.kernel_passes(n, batch, 1)
    nbytes = 2 * n * batch * 64 + sum(p.m // 2 * 16 for p in passes)
    ops = batch * log2n * n // 2 * (MONT_MUL_OPS + 2 * ADD_SUB_OPS)
    return bound_ms(nbytes, ops, int_rate)
