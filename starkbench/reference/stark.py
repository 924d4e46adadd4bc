"""A STARK verifier for the Rescue AIRs, on Python ints.

The protocol is the STARK Anatomy tutorial's, as the measured prover
implements it: the trace is randomized with 4 x (colinearity checks)
rows, its boundary quotients and a randomizer polynomial are committed
in BLAKE2b-512 Merkle trees of decimal-string leaves, the weighted
combination of transition and boundary quotients (each also shifted to
the maximal degree) is proven low-degree by FRI, and the verifier checks
the combination at every queried point against the opened leaves.

The AIR is Rescue-Prime's, with the round constants as columns that
interpolate, over the first R = (cycles - 1) powers of omicron, the
constant each step adds (period N).  For the signature R = N = 27; for
the chain R = 27 * chain length.  :class:`Columns` evaluates those
interpolants and the transition zerofier at a point in O(R) by the
barycentric formula.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

from .field import GENERATOR, P, batch_inverse, primitive_root, sample
from .rescue import Rescue
from .transcript import Reject, Transcript


def _blake(data: bytes) -> bytes:
    return hashlib.blake2b(data, digest_size=64).digest()


def leaf_hash(value: int) -> bytes:
    return _blake(str(value).encode())


def merkle_root(values: Sequence[int]) -> bytes:
    level = [leaf_hash(v) for v in values]
    while len(level) > 1:
        level = [_blake(level[i] + level[i + 1]) for i in range(0, len(level), 2)]
    return level[0]


def check_path(root: bytes, index: int, depth: int, path: Sequence[bytes], value: int,
               what: str) -> None:
    if len(path) != depth or any(len(e) != 64 for e in path):
        raise Reject(f"{what}: path of {len(path)} entries, expected {depth}")
    node = leaf_hash(value)
    for sibling in path:
        node = _blake(node + sibling) if index % 2 == 0 else _blake(sibling + node)
        index >>= 1
    if node != root:
        raise Reject(f"{what}: path does not lead to the root")


def ntt(values: Sequence[int], root: int) -> list[int]:
    """sum_i values[i] * root^(i k) for every k (len a power of two)."""
    n = len(values)
    if n == 1:
        return [values[0] % P]
    sq = root * root % P
    even, odd = ntt(values[0::2], sq), ntt(values[1::2], sq)
    out, w, half = [0] * n, 1, n // 2
    for i in range(half):
        t = w * odd[i] % P
        out[i] = (even[i] + t) % P
        out[i + half] = (even[i] - t) % P
        w = w * root % P
    return out


def bit_count(v: int) -> int:
    """Bits from the top set bit down to bit 0 (1 for 0)."""
    return max(v.bit_length(), 1)


@dataclass(frozen=True)
class Setup:
    """The geometry the verifier derives from a configuration."""

    expansion_factor: int
    num_checks: int
    num_registers: int
    num_cycles: int
    constraint_degree: int = 3

    @property
    def num_randomizers(self) -> int:
        return 4 * self.num_checks

    @property
    def omicron_domain_length(self) -> int:
        rtl = self.num_cycles + self.num_randomizers
        return 1 << bit_count(rtl * self.constraint_degree)

    @property
    def fri_domain_length(self) -> int:
        return self.omicron_domain_length * self.expansion_factor

    @property
    def fri_rounds(self) -> int:
        n, k = self.fri_domain_length, 0
        while n > self.expansion_factor and n > 4 * self.num_checks:
            n, k = n // 2, k + 1
        return k


class Columns:
    """At a point x: Z(x) = prod_{i<R} (x - omicron^i), and the 2m round
    constant columns' interpolants over those R points.

    Barycentric: C(x) = Z(x) sum_i c_i w_i / (x - omicron^i), with w_i =
    1 / prod_{j != i} (omicron^i - omicron^j) from the ratio
    D_{i+1} / D_i = omicron^(R-1) (1 - omicron^(-i-1)) / (1 - omicron^(R-1-i)),
    and the sum taken per residue of i mod N, since c_i has period N.
    """

    def __init__(self, rescue: Rescue, num_rows: int, omicron: int):
        R = self.R = num_rows
        self.rescue = rescue
        self.points = [1] * R
        for i in range(1, R):
            self.points[i] = self.points[i - 1] * omicron % P
        d0 = 1
        for a in self.points[1:]:
            d0 = d0 * (1 - a) % P
        omicron_inv = pow(omicron, -1, P)
        lost = batch_inverse([(1 - self.points[R - 1 - i]) % P for i in range(R - 1)])
        gain_base = self.points[R - 1]
        d, ds, neg = d0, [d0], 1
        for i in range(R - 1):
            neg = neg * omicron_inv % P  # omicron^(-i-1)
            d = d * gain_base % P * (1 - neg) % P * lost[i] % P
            ds.append(d)
        self.weights = batch_inverse(ds)
        m, N = rescue.m, rescue.N
        self.constants = [[rescue.constant_column(half, j, r) for r in range(N)]
                          for half in (0, 1) for j in range(m)]

    def at(self, x: int) -> tuple[int, list[int]]:
        pts, w, N = self.points, self.weights, self.rescue.N
        prefix = [0] * self.R
        acc = 1
        for i, a in enumerate(pts):
            prefix[i] = acc
            acc = acc * (x - a) % P
        z = acc
        inv = pow(z, P - 2, P)  # 1 / prod_{j <= i}, walking i down
        buckets = [0] * N
        for i in range(self.R - 1, -1, -1):
            buckets[i % N] += w[i] * (inv * prefix[i] % P)
            inv = inv * (x - pts[i]) % P
        buckets = [b % P for b in buckets]
        cols = [z * (sum(c * b for c, b in zip(col, buckets)) % P) % P for col in self.constants]
        return z, cols


def rescue_constraints(rescue: Rescue, cur: Sequence[int], nxt: Sequence[int],
                       cols: Sequence[int]) -> list[int]:
    """MDS cur^alpha + C1(x) - (MDS^-1 (nxt - C2(x)))^alpha, per register."""
    m = rescue.m
    c1, c2 = cols[:m], cols[m:]
    cubes = [pow(c, rescue.alpha, P) for c in cur]
    inner = [(nxt[k] - c2[k]) % P for k in range(m)]
    out = []
    for j in range(m):
        lhs = (sum(rescue.mds[j][k] * cubes[k] for k in range(m)) + c1[j]) % P
        rhs = pow(sum(rescue.mds_inv[j][k] * inner[k] for k in range(m)) % P, rescue.alpha, P)
        out.append((lhs - rhs) % P)
    return out


def _interpolate_at(domain: Sequence[int], values: Sequence[int], x: int) -> int:
    """Lagrange interpolant of (domain, values) at x (0 on no points)."""
    total = 0
    for i, (xi, vi) in enumerate(zip(domain, values)):
        num, den = 1, 1
        for j, xj in enumerate(domain):
            if j != i:
                num = num * (x - xj) % P
                den = den * (xi - xj) % P
        total += vi * num * pow(den, -1, P)
    return total % P


def _colinear(points: Sequence[tuple[int, int]]) -> bool:
    """The three points lie on a polynomial of degree exactly 1."""
    (x0, y0), (x1, y1), (x2, y2) = points
    if len({x0, x1, x2}) != 3:
        return False
    det = (y0 * (x1 - x2) + y1 * (x2 - x0) + y2 * (x0 - x1)) % P
    return det == 0 and (y0 - y1) % P != 0


def _sample_indices(seed: bytes, size: int, reduced_size: int, number: int) -> list[int]:
    if number > reduced_size:
        raise Reject("more queries than the last codeword holds")
    indices, reduced = [], set()
    counter = 0
    while len(indices) < number:
        data = _blake(seed + bytes(counter))
        nbytes = (size.bit_length() - 1) // 8 + 1
        index = int.from_bytes(data[-nbytes:], "big") % size
        counter += 1
        if index % reduced_size not in reduced:
            indices.append(index)
            reduced.add(index % reduced_size)
    return indices


def verify_fri(ts: Transcript, s: Setup, points: list[tuple[int, int]]) -> None:
    """FRI over the coset GENERATOR * <omega>; appends the first round's
    queried (index, value) pairs to ``points``."""
    n = s.fri_domain_length
    omega, offset = primitive_root(n), GENERATOR
    rounds = s.fri_rounds
    roots, alphas = [], []
    for _ in range(rounds):
        roots.append(ts.root())
        alphas.append(sample(ts.challenge()))
    last = ts.codeword()
    size = n >> (rounds - 1)
    if len(last) != size:
        raise Reject(f"last codeword of {len(last)} elements, expected {size}")
    if merkle_root(last) != roots[-1]:
        raise Reject("last codeword does not match its root")
    last_omega, last_offset = omega, offset
    for _ in range(rounds - 1):
        last_omega, last_offset = last_omega * last_omega % P, last_offset * last_offset % P
    coeffs = ntt(last, pow(last_omega, -1, P))  # size * coefficients, scaled by offset^k
    nonzero = [k for k, c in enumerate(coeffs) if c]
    if not nonzero:
        raise Reject("last codeword is the zero polynomial")
    if nonzero[-1] > size // s.expansion_factor - 1:
        raise Reject(f"last codeword has degree {nonzero[-1]}")
    top = _sample_indices(ts.challenge(), n >> 1, size, s.num_checks)
    for r in range(rounds - 1):
        half = n >> (r + 1)
        idx_a = [i % half for i in top]
        idx_b = [i + half for i in idx_a]
        leafs = [ts.leafs() for _ in range(s.num_checks)]
        for q, (ay, by, cy) in enumerate(leafs):
            if r == 0:
                points.append((idx_a[q], ay))
                points.append((idx_b[q], by))
            ax = offset * pow(omega, idx_a[q], P) % P
            bx = offset * pow(omega, idx_b[q], P) % P
            if not _colinear([(ax, ay), (bx, by), (alphas[r], cy)]):
                raise Reject(f"round {r}: colinearity check {q} fails")
        depth = (n >> r).bit_length() - 1
        for q, (ay, by, cy) in enumerate(leafs):
            check_path(roots[r], idx_a[q], depth, ts.path(), ay, f"round {r} a")
            check_path(roots[r], idx_b[q], depth, ts.path(), by, f"round {r} b")
            check_path(roots[r + 1], idx_a[q], depth - 1, ts.path(), cy, f"round {r} c")
        omega, offset = omega * omega % P, offset * offset % P


def verify(proof: bytes, s: Setup, rescue: Rescue, boundary: Sequence[tuple[int, int, int]],
           document: Optional[bytes] = None,
           columns: Optional[Callable[[list[int]], list[tuple[int, list[int]]]]] = None) -> None:
    """Raise :class:`Reject` unless ``proof`` proves the Rescue AIR of
    ``s.num_cycles`` cycles under ``boundary`` ((cycle, register, value)
    triples); ``document`` binds a signature.  ``columns`` maps a list of
    points to :meth:`Columns.at` of each (by default here, one by one)."""
    ts = Transcript(proof, document)
    m, n = s.num_registers, s.fri_domain_length
    odl = s.omicron_domain_length
    omicron, omega = primitive_root(odl), primitive_root(n)
    R = s.num_cycles - 1
    if 1 + max(c for c, _, _ in boundary) != s.num_cycles:
        raise ValueError("boundary does not end on the last cycle")
    rtl = s.num_cycles + s.num_randomizers

    bq_roots = [ts.root() for _ in range(m)]
    rand_root = ts.root()
    # weight i samples the challenge behind i zero bytes (which the 128-bit
    # fold does not see: the weights are equal, as the prover draws them)
    randomness = ts.challenge()
    weights = [sample(bytes(i) + randomness) for i in range(1 + 2 * m + 2 * m)]

    points: list[tuple[int, int]] = []
    verify_fri(ts, s, points)
    points.sort()
    indices = [i for i, _ in points]
    values = [v for _, v in points]
    dup = sorted(indices + [(i + s.expansion_factor) % n for i in indices])

    leafs = []
    for reg in range(m):
        got = {}
        for i in dup:
            v = ts.value()
            check_path(bq_roots[reg], i, n.bit_length() - 1, ts.path(), v,
                       f"boundary quotient {reg} leaf {i}")
            got[i] = v
        leafs.append(got)
    rand = {}
    for i in dup:
        v = ts.value()
        check_path(rand_root, i, n.bit_length() - 1, ts.path(), v, f"randomizer leaf {i}")
        rand[i] = v
    if not ts.finished():
        raise Reject("items left after the last opening")

    # degree bookkeeping: the Rescue constraints have degree 3 in the
    # registers, whose randomized trace has degree rtl - 1
    tdb = 3 * (rtl - 1)
    max_degree = (1 << bit_count(tdb)) - 1
    shift_tq = max_degree - (tdb - R)
    bnd_domains = [[pow(omicron, c, P) for c, r, _ in boundary if r == reg] for reg in range(m)]
    bnd_values = [[v for c, r, v in boundary if r == reg] for reg in range(m)]
    shift_bq = [max_degree - (rtl - 1 - len(d)) for d in bnd_domains]

    xs = [GENERATOR * pow(omega, i, P) % P for i in indices]
    if columns is None:
        table = Columns(rescue, R, omicron)
        evaluated = [table.at(x) for x in xs]
    else:
        evaluated = columns(xs)

    def zerofier(reg: int, x: int) -> int:
        out = 1
        for d in bnd_domains[reg]:
            out = out * (x - d) % P
        return out

    for q, i in enumerate(indices):
        x = xs[q]
        nxt_i = (i + s.expansion_factor) % n
        x_next = GENERATOR * pow(omega, nxt_i, P) % P
        cur = [(leafs[reg][i] * zerofier(reg, x) + _interpolate_at(bnd_domains[reg], bnd_values[reg], x)) % P
               for reg in range(m)]
        nxt = [(leafs[reg][nxt_i] * zerofier(reg, x_next)
                + _interpolate_at(bnd_domains[reg], bnd_values[reg], x_next)) % P
               for reg in range(m)]
        z, cols = evaluated[q]
        z_inv = pow(z, -1, P)
        terms = [rand[i]]
        for c in rescue_constraints(rescue, cur, nxt, cols):
            quotient = c * z_inv % P
            terms += [quotient, quotient * pow(x, shift_tq, P) % P]
        for reg in range(m):
            terms += [leafs[reg][i], leafs[reg][i] * pow(x, shift_bq[reg], P) % P]
        combination = sum(t * w for t, w in zip(terms, weights)) % P
        if combination != values[q]:
            raise Reject(f"combination at index {i} does not match FRI's first codeword")
