"""The frozen yardstick: the card's published peaks, the work an algorithm
needs for given inputs, and the arithmetic that turns a run's clocks,
counters and trace into numbers.

Nothing here reads the card or the program's sources, so a reading means
the same thing whatever implements the work it counts.

Peaks of one NVIDIA H100 SXM5 (80 GB HBM3), as published:

* HBM bandwidth 3.35 TB/s (data sheet);
* 132 SMs at a boost clock of 1.98 GHz (data sheet: 66.9 TFLOP/s float32
  = 132 x 128 lanes x 2 x 1.98e9);
* 64 32-bit integer multiply-adds per clock per SM on compute capability
  9.0 (CUDA C++ Programming Guide, "Throughput of Native Arithmetic
  Instructions": 32-bit integer multiply, multiply-add and
  extended-precision multiply-add), and 64 32-bit integer additions
  (integer add, extended-precision add, subtract).

These assume the card's full power limit of 700 W; a run prints the
card's own limit beside its readings.
"""

from __future__ import annotations

import statistics
from collections import Counter

HBM_BYTES_PER_S = 3.35e12
SMS = 132
BOOST_HZ = 1.98e9
INT_MADS_PER_CLOCK_PER_SM = 64
INT_ADDS_PER_CLOCK_PER_SM = 64
#: 32-bit integer multiply-adds per second of the whole card
INT_MADS_PER_S = SMS * INT_MADS_PER_CLOCK_PER_SM * BOOST_HZ
#: 32-bit integer additions per second of the whole card
INT_ADDS_PER_S = SMS * INT_ADDS_PER_CLOCK_PER_SM * BOOST_HZ

#: 32-bit words of a field element (p < 2^128)
WORDS = 4
#: 32-bit multiply-adds of the Montgomery reduction mod p = 1 + 407 * 2^119:
#: since -p^-1 = 407 * 2^119 - 1 mod 2^128, one multiply for the
#: quotient's top word and 4 x 2 for 407 x 2^119 times the quotient
REDUCE_MADS = 1 + 2 * WORDS
#: 32-bit multiply-adds of one Montgomery product of 4-word elements: the
#: schoolbook product, each of its 4 x 4 word products a low and a high
#: multiply-add, and the reduction
MONT_MUL_MADS = 2 * WORDS * WORDS + REDUCE_MADS
#: of one Montgomery squaring: only the 4 x 5 / 2 distinct word products
#: (a cross product is doubled by a shift or an addition, not a multiply)
#: and the reduction
MONT_SQR_MADS = 2 * (WORDS * (WORDS + 1) // 2) + REDUCE_MADS
#: 32-bit add-with-carry instructions of one modular addition (one a word;
#: the conditional subtraction of p left out)
MOD_ADD_OPS = WORDS
#: bytes of a field element at rest
ELEMENT_BYTES = 16


def exponent_steps(e: int) -> tuple[int, int]:
    """(squarings, products) of the cheapest addition chain that could raise
    x to e > 1, a floor for every chain: it has at least ceil(log2 e) steps,
    since a step at most doubles the exponent, and at least ceil(log2 v)
    of them are not doublings (products of two different powers), where v
    counts e's binary ones, since a doubling keeps that count and a sum at
    most adds two counts.  Every other step is taken as a squaring."""
    steps = (e - 1).bit_length()
    products = (e.bit_count() - 1).bit_length()
    return steps - products, products


def rescue_hash_work(m: int, N: int, alpha: int, alpha_inv: int) -> tuple[int, int, int]:
    """(squarings, products, modular additions) of one Rescue-Prime hash of
    width m: per round two S-box layers (m powers each, to alpha and to
    alpha^-1), two MDS products (m x m products, m x (m - 1) additions
    each) and two constant additions (m each)."""
    power_sqr, power_mul = (a + b for a, b in zip(exponent_steps(alpha),
                                                   exponent_steps(alpha_inv)))
    squarings = N * m * power_sqr
    products = N * (m * power_mul + 2 * m * m)
    additions = N * (2 * m * (m - 1) + 2 * m)
    return squarings, products, additions


def rescue_hash_bound_s(hashes: int, m: int, N: int, alpha: int, alpha_inv: int) -> float:
    """The least time the card could hash ``hashes`` elements in: the
    largest of their multiply-adds at the multiply-add peak, their
    additions' word additions at the addition peak (another pipe) and
    their bytes (one element read, one digest written) at the HBM peak."""
    squarings, products, additions = rescue_hash_work(m, N, alpha, alpha_inv)
    mads = hashes * (squarings * MONT_SQR_MADS + products * MONT_MUL_MADS)
    adds = hashes * additions * MOD_ADD_OPS
    nbytes = hashes * 2 * ELEMENT_BYTES
    return max(mads / INT_MADS_PER_S, adds / INT_ADDS_PER_S, nbytes / HBM_BYTES_PER_S)


def percentile(values, q: float) -> float:
    """The q-th percentile (0 < q < 100) by linear interpolation between
    order statistics (``statistics.quantiles``, inclusive method)."""
    if len(values) == 1:
        return float(values[0])
    return statistics.quantiles(values, n=100, method="inclusive")[round(q) - 1]


def union_seconds(starts, ends, lo: int, hi: int) -> tuple[float, list[tuple[int, int]]]:
    """Total length (s) of the union of the intervals [starts, ends) (ns)
    clipped to [lo, hi], and the gaps of [lo, hi] that none covers."""
    import numpy as np

    s = np.clip(np.asarray(starts, dtype=np.int64), lo, hi)
    e = np.clip(np.asarray(ends, dtype=np.int64), lo, hi)
    order = np.argsort(s, kind="stable")
    s, e = s[order], e[order]
    covered = 0
    gaps = []
    cursor = lo
    if len(s):
        reach = np.maximum.accumulate(e)
        # a new run of overlapping intervals starts where an interval
        # begins after everything before it has ended
        prev = np.concatenate(([lo], reach[:-1]))
        starts_run = s > prev
        run_first = np.flatnonzero(starts_run | (np.arange(len(s)) == 0))
        for j, i in enumerate(run_first):
            last = run_first[j + 1] - 1 if j + 1 < len(run_first) else len(s) - 1
            a, b = max(int(s[i]), cursor), int(reach[last])
            if a > cursor:
                gaps.append((cursor, a))
            if b > a:
                covered += b - a
            cursor = max(cursor, b)
    if hi > cursor:
        gaps.append((cursor, hi))
    return covered / 1e9, gaps


def innermost_segments(spans):
    """Nested spans (name, start, end) -> non-overlapping segments (start,
    end, name), each named by the innermost span open over it."""
    segs = []
    stack: list[tuple[int, str]] = []
    cursor = 0

    def close_until(t):
        nonlocal cursor
        while stack and stack[-1][0] <= t:
            end, name = stack.pop()
            if end > cursor:
                segs.append((cursor, end, name))
                cursor = end

    for name, a, b in sorted(spans, key=lambda s: (s[1], -s[2])):
        close_until(a)
        if stack and a > cursor:
            segs.append((cursor, a, stack[-1][1]))
        cursor = max(cursor, a)
        stack.append((b, name))
    close_until(float("inf"))
    return segs


def idle_by_host_span(gaps, spans, top: int = 10):
    """Idle seconds of the device by what the host was doing: each gap goes
    to the span the host was innermost in at its middle."""
    import numpy as np

    if not gaps:
        return []
    segs = innermost_segments(spans)
    starts = np.array([s[0] for s in segs], dtype=np.int64)
    ends = np.array([s[1] for s in segs], dtype=np.int64)
    totals = Counter()
    for a, b in gaps:
        mid = (a + b) // 2
        j = int(np.searchsorted(starts, mid, side="right")) - 1
        name = segs[j][2] if j >= 0 and mid < ends[j] else "outside any span"
        totals[name] += (b - a) / 1e9
    ranked = sorted(totals.items(), key=lambda kv: (-kv[1], kv[0]))
    return [[name, secs] for name, secs in ranked[:top]]
