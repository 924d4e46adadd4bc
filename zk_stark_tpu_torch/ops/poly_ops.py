"""Polynomials with Montgomery limb-tensor coefficients.

Counterpart of the main-path subset of the JAX package's
``ops/poly_ops.py``: the same degree bookkeeping (root-order halving,
result truncation) and the same closed-form O(n log n) algorithms for the
structured "first k powers of omega" domains the prover uses:

* zerofier values on the full domain from the sliding-window product
  ``prod_{i<k}(w^j - w^i) = w^{jk} * G_j / G_{j-k}`` with
  ``G_j = prod_{t=1..j}(1 - w^{-t})``, then one iNTT for coefficients;
* interpolation in barycentric form, where the off-domain values are a
  cyclic convolution (two NTTs) with ``1/(w^d - 1)``.

Results are exact field elements, so they agree with the JAX package
coefficient for coefficient.  Every function runs on the device of its
inputs; the NTTs go through the kernel on the card.  The functions the
prover calls take an ``engine`` (``parallel/engine.py``; the single-device
``DEFAULT`` when None) for their transforms and inversions, as the JAX
package's do.  Under a distributed engine a :class:`DPoly` may be held as
blocks (its ``layout``: the engine's rows of its coefficients zero-padded to
a length n), and these functions return such polynomials; :func:`laid`
brings a polynomial, whole or in blocks, to the rows a transform of
another length takes.

The arbitrary-domain toolkit (:func:`fast_zerofier`,
:func:`fast_evaluate_domain`, :func:`fast_interpolate_domain`) runs the
subproduct trees of ``ops/multipoint.py`` at the JAX package's dispatch
thresholds; the zerofier tree is built level by level, one batched product
a level.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import numpy as np
import torch

from ..field import Field
from ..poly import Polynomial
from ..utils.bits import is_pow2, next_pow2
from . import limbs as L
from . import multipoint
from ._build import resolve_device
from .ntt import intt_mont, ntt_mont, powers_mont

P = L.P


# -----------------------------------------------------------------------------
# Reductions and scans
# -----------------------------------------------------------------------------


def _tree_sum(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Modular sum along ``dim`` by pairwise halving."""
    x = x.movedim(dim, 0)
    while x.shape[0] > 1:
        if x.shape[0] % 2:
            x = torch.cat([x, torch.zeros_like(x[:1])])
        x = L.add_mod(x[0::2], x[1::2])
    return x[0]


def reduce_sum_mont(x: torch.Tensor) -> torch.Tensor:
    """Sum of all elements along axis 0 -> [8]."""
    if x.shape[0] == 0:
        return torch.zeros(L.NLIMB, dtype=L.DTYPE, device=x.device)
    return _tree_sum(x)


def cumprod_mont(x: torch.Tensor) -> torch.Tensor:
    """Inclusive cumulative product along axis 0 (blocked two-level scan)."""
    return L.cumprod_mont_blocked(x)


def degree_device(c: torch.Tensor, start: int = 0) -> torch.Tensor:
    """Degree scan on the device: [n, 8] -> int64 scalar, -1 for zero.  The
    rows of ``c`` are coefficients ``start`` onwards (a rank's block)."""
    n = c.shape[0]
    if n == 0:
        return torch.tensor(-1, device=c.device)
    nz = (c != 0).any(dim=-1)
    idx = torch.arange(start, start + n, device=c.device)
    return torch.where(nz, idx, torch.full_like(idx, -1)).amax()


# -----------------------------------------------------------------------------
# DPoly: dense polynomial with tensor coefficients
# -----------------------------------------------------------------------------


class DPoly:
    """Dense polynomial with Montgomery coefficients [n, 8] on a device.

    ``degree`` may be given when it is known without looking at the data
    (``None`` for the zero polynomial); otherwise it is scanned on first use.

    ``layout`` is None when ``c`` holds the coefficients whole, or
    (engine, n) when ``c`` is ``engine.rows(n)`` of the coefficients
    zero-padded to n: a rank's block under a distributed engine
    (:meth:`held`).  Such a polynomial scales, truncates, adds and
    subtracts in place and moves to another length with :meth:`padded`;
    its degree scan takes one small collective.  ``bound``, when known,
    is a length past which its coefficients are zero (set by
    :meth:`truncated`): a move carries no row from it on.
    """

    __slots__ = ("c", "_degree", "layout", "bound")

    def __init__(self, c: torch.Tensor, degree: Optional[int] = "unknown", layout=None,
                 bound: Optional[int] = None):
        self.c = c
        self._degree = degree
        self.layout = layout
        self.bound = bound

    @classmethod
    def held(cls, c: torch.Tensor, n: int, engine, degree="unknown") -> "DPoly":
        """``c``, the engine's rows of a length-n coefficient vector: whole
        under the single engine, in blocks under a distributed one."""
        return cls(c, degree, (engine, n) if engine.is_distributed else None)

    @property
    def start(self) -> int:
        """The index of the first coefficient ``c`` holds."""
        return 0 if self.layout is None else self.layout[0].rows(self.layout[1]).start

    @classmethod
    def from_ints(cls, vals: Sequence[int], device="cuda") -> "DPoly":
        return cls(L.ints_to_mont(list(vals), device))

    @classmethod
    def zero(cls, device) -> "DPoly":
        return cls(torch.zeros((0, L.NLIMB), dtype=L.DTYPE, device=device), None)

    def to_ints(self) -> list[int]:
        if self.c.shape[0] == 0:
            return []
        return [int(v) for v in L.mont_to_ints(self.c)]

    @property
    def device(self) -> torch.device:
        return self.c.device

    def __len__(self) -> int:
        return int(self.c.shape[0]) if self.layout is None else self.layout[1]

    def degree(self) -> Optional[int]:
        if self._degree == "unknown":
            d = degree_device(self.c, self.start)
            if self.layout is not None:
                d = self.layout[0].max_over_ranks(d)
            d = int(d)
            self._degree = None if d < 0 else d
        return self._degree

    def is_zero(self) -> bool:
        return self.degree() is None

    def padded(self, n: int) -> torch.Tensor:
        """The coefficients zero-padded to n, as held: whole, or (in
        blocks) the engine's rows of them, which takes one ``permute``
        when they move between ranks.  Coefficients past n must be zero."""
        if self.layout is not None:
            eng, m = self.layout
            return eng.move(self.c, m, n, [(0, 0, min(m, n, self._bound()))])[0]
        m = self.c.shape[0]
        assert m <= n, f"polynomial of length {m} does not fit order {n}"
        if m == n:
            return self.c
        pad = torch.zeros((n - m, L.NLIMB), dtype=L.DTYPE, device=self.c.device)
        return torch.cat([self.c, pad])

    def _bound(self) -> int:
        return len(self) if self.bound is None else self.bound

    def truncated(self, n: int) -> "DPoly":
        if self.layout is not None:  # zero the block's rows from n on
            bound = min(n, self._bound())
            keep = min(max(n - self.start, 0), self.c.shape[0])
            if keep == self.c.shape[0]:
                return DPoly(self.c, self._degree, self.layout, bound)
            c = self.c.clone()
            c[keep:] = 0
            return DPoly(c, layout=self.layout, bound=bound)
        if self.c.shape[0] <= n:
            return self
        return DPoly(self.c[:n])

    def _pair(self, other: "DPoly"):
        """(layout, self's rows, other's rows, bound) of a sum or
        difference in which at least one side is in blocks; a whole side is
        constrained."""
        lay = self.layout or other.layout
        if self.layout and other.layout and self.layout != other.layout:
            raise ValueError("DPoly: the two sides are held at different lengths")
        eng, n = lay
        a = self.c if self.layout else eng.constrain(self.c, n)
        b = other.c if other.layout else eng.constrain(other.c, n)
        return lay, a, b, max(self._bound(), other._bound())

    def __add__(self, other: "DPoly") -> "DPoly":
        if self.layout or other.layout:
            lay, a, b, bound = self._pair(other)
            return DPoly(L.add_mod(a, b), layout=lay, bound=bound)
        n = max(len(self), len(other))
        if n == 0:
            return DPoly.zero(self.device)
        return DPoly(L.add_mod(self.padded(n), other.padded(n)))

    def __sub__(self, other: "DPoly") -> "DPoly":
        if self.layout or other.layout:
            lay, a, b, bound = self._pair(other)
            return DPoly(L.sub_mod(a, b), layout=lay, bound=bound)
        n = max(len(self), len(other))
        if n == 0:
            return DPoly.zero(self.device)
        return DPoly(L.sub_mod(self.padded(n), other.padded(n)))

    def __neg__(self) -> "DPoly":
        if len(self) == 0:
            return self
        return DPoly(L.neg_mod(self.c))

    def scale(self, factor_int: int) -> "DPoly":
        """x -> factor*x substitution."""
        if self.layout is not None:
            eng, n = self.layout
            return DPoly(L.mont_mul(self.c, eng.powers(factor_int, n, self.device)),
                         self._degree, self.layout, self.bound)
        n = len(self)
        if n == 0:
            return self
        return DPoly(
            L.mont_mul(self.c, powers_mont(factor_int, n, self.device)), self._degree
        )

    def shift(self, k: int) -> "DPoly":
        """Multiply by x^k.  A degree not yet scanned stays unknown (the JAX
        package's ``shift`` marks it None, the zero polynomial's)."""
        if k == 0 or len(self) == 0:
            return self
        d = self._degree
        return DPoly(
            torch.cat([self.c.new_zeros((k, L.NLIMB)), self.c]),
            d if d is None or d == "unknown" else d + k,
        )

    def _scalar(self, v: int) -> torch.Tensor:
        # a caller's value: uploaded anew, never cached (limbs.int_to_mont)
        return L.ints_to_mont([v], self.device)[0]

    def const_mul(self, scalar_int: int) -> "DPoly":
        if len(self) == 0:
            return self
        return DPoly(L.mont_mul(self.c, self._scalar(scalar_int)))

    def evaluate(self, x_int: int) -> int:
        """The value at a host point: its powers by doubling, the products
        and a tree sum on the device."""
        n = len(self)
        if n == 0:
            return 0
        pows = _power_table(self._scalar(x_int).unsqueeze(0), n)[:, 0]
        return int(L.mont_to_ints(reduce_sum_mont(L.mont_mul(self.c, pows)).unsqueeze(0))[0])


# -----------------------------------------------------------------------------
# NTT polynomial arithmetic
# -----------------------------------------------------------------------------


def _halve_root(degree: int, root_int: int, order: int) -> tuple[int, int]:
    """Halve the root's order while degree < order/2."""
    while degree < order // 2:
        root_int = root_int * root_int % P
        order //= 2
    return root_int, order


def _engine(engine):
    if engine is not None:
        return engine
    from ..parallel.engine import DEFAULT

    return DEFAULT


def laid(poly: DPoly, n: int, engine) -> torch.Tensor:
    """``poly``'s coefficients zero-padded to n as the engine holds a
    length-n vector: whole under the single engine, the rank's block under
    a distributed one (a slice of a whole polynomial, or its blocks moved
    from their own length)."""
    if poly.layout is None and engine.is_distributed:
        return engine.constrain(poly.c, n)
    return poly.padded(n)


def fast_multiply(lhs: DPoly, rhs: DPoly, root_int: int, root_order: int,
                  engine=None) -> DPoly:
    """NTT polynomial product."""
    eng = _engine(engine)
    if lhs.is_zero() or rhs.is_zero():
        return DPoly.zero(lhs.device)
    degree = lhs.degree() + rhs.degree()
    root, order = _halve_root(degree, root_int, root_order)
    assert degree < order, "product degree exceeds available root order"
    la = eng.ntt(laid(lhs.truncated(lhs.degree() + 1), order, eng), root, order)
    lb = eng.ntt(laid(rhs.truncated(rhs.degree() + 1), order, eng), root, order)
    coeffs = eng.intt(L.mont_mul(la, lb), root, order)
    return DPoly.held(coeffs, order, eng, degree).truncated(degree + 1)


def fast_coset_evaluate(
    poly: DPoly, offset_int: int, root_int: int, order: int, engine=None
) -> torch.Tensor:
    """Codeword [order, 8] of ``poly`` on the coset ``offset * root^i``
    (the engine's rows of it)."""
    eng = _engine(engine)
    return eng.ntt(laid(poly.scale(offset_int), order, eng), root_int, order)


def fast_coset_divide(
    lhs: DPoly,
    rhs: DPoly,
    offset_int: int,
    root_int: int,
    root_order: int,
    lhs_degree: Optional[int] = None,
    rhs_degree: Optional[int] = None,
    engine=None,
) -> DPoly:
    """Division via coset NTT, truncated to ``deg(lhs) - deg(rhs) + 1``
    coefficients even when inexact (the prover's degree check relies on
    that).  Degrees may be passed when known, to skip the device scans."""
    if lhs_degree is None:
        assert not rhs.is_zero(), "cannot divide by zero polynomial"
        if lhs.is_zero():
            return DPoly.zero(lhs.device)
        lhs_degree = lhs.degree()
    if rhs_degree is None:
        rhs_degree = rhs.degree()
    assert lhs_degree >= rhs_degree, "cannot divide by higher-degree polynomial"

    degree = max(lhs_degree, rhs_degree)
    result_len = lhs_degree - rhs_degree + 1
    root, order = _halve_root(degree, root_int, root_order)

    lhs = lhs.truncated(lhs_degree + 1)
    rhs = rhs.truncated(rhs_degree + 1)
    eng = _engine(engine)
    la = eng.ntt(laid(lhs.scale(offset_int), order, eng), root, order)
    lb = eng.ntt(laid(rhs.scale(offset_int), order, eng), root, order)
    coeffs = eng.intt(L.mont_mul(la, eng.batch_inv(lb)), root, order)
    return DPoly.held(coeffs, order, eng).truncated(result_len).scale(pow(offset_int, -1, P))


# -----------------------------------------------------------------------------
# Structured domains: first k powers of a primitive n-th root
# -----------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _one_minus_invpow_cumprod(root_int: int, n: int, device: str):
    """(G, G^-1) [n, 8] with G[j] = prod_{t=1..j} (1 - w^-t), G[0] = 1."""
    invpows = powers_mont(pow(root_int, -1, P), n, device)
    one = L.one_mont(device)
    terms = L.sub_mod(one.expand_as(invpows), invpows)  # index 0 is 0
    terms[0] = one  # G starts at 1
    g = cumprod_mont(terms)
    return g, L.batch_inv(g)


@functools.lru_cache(maxsize=None)
def _idx_mont(k: int, device: str) -> torch.Tensor:
    """Montgomery [k, 8] of the integers 1..k (derivative multipliers)."""
    return L.ints_to_mont(range(1, k + 1), device)


@functools.lru_cache(maxsize=None)
def _h_table_ntt(root_int: int, n: int, device: str) -> torch.Tensor:
    """NTT of h with h[d] = 1/(w^d - 1) for d != 0, h[0] = 0."""
    pows = powers_mont(root_int, n, device)
    diffs = L.sub_mod(pows, L.one_mont(device).expand_as(pows))
    return ntt_mont(L.batch_inv(diffs), root_int)  # inv(0) == 0 keeps h[0] = 0


@functools.lru_cache(maxsize=None)
def _zerofier_first_k(root_int: int, n: int, k: int, device: str):
    """(coefficients [k+1, 8], values [n, 8] on the full domain)."""
    assert 0 < k <= n
    if k == n:
        # Z = x^n - 1
        coeffs = L.ints_to_mont([P - 1] + [0] * (n - 1) + [1], device)
        return coeffs, torch.zeros((n, L.NLIMB), dtype=L.DTYPE, device=device)
    g, g_inv = _one_minus_invpow_cumprod(root_int, n, device)
    wk = powers_mont(pow(root_int, k, P), n, device)  # w^{jk}
    g_shift = torch.cat([g_inv[n - k :], g_inv[: n - k]])  # G^-1_{j-k}
    zvals = L.mont_mul(wk, L.mont_mul(g, g_shift))
    zvals[:k] = 0
    coeffs = intt_mont(zvals, root_int)[: k + 1]
    return coeffs, zvals


def zerofier_first_k(root_int: int, n: int, k: int, device) -> DPoly:
    """Z(x) = prod_{i<k} (x - w^i), w a primitive n-th root (0 < k <= n)."""
    coeffs, _ = _zerofier_first_k(root_int, n, k, str(torch.device(device)))
    return DPoly(coeffs, k)


def interpolate_first_k(root_int: int, n: int, k: int, values: torch.Tensor,
                        engine=None) -> DPoly:
    """The unique polynomial of degree < k through ``values`` (whole) at
    the first k powers of w (a primitive n-th root); under a distributed
    engine its coefficients are held in blocks of n, each rank computing
    the rows of its block of every step."""
    eng = _engine(engine)
    assert 0 < k <= n and values.shape[0] == k
    if k == n:
        return DPoly.held(eng.intt(eng.constrain(values, n), root_int, n), n, eng)
    if k == 1:
        return DPoly(values)
    device = str(values.device)
    zc, zvals = _zerofier_first_k(root_int, n, k, device)
    zvals = eng.constrain(zvals, n)
    # this rank holds the rows [lo, hi) of [0, k), at [0, hi - lo) of its block
    rows = eng.rows(n)
    lo, hi = min(rows.start, k), min(rows.stop, k)

    # Z'(w^i) for i < k: derivative coefficients, evaluated by NTT
    dz = L.mont_mul(zc[1:], _idx_mont(k, device))  # degree k-1, length k
    dz_vals = eng.ntt(laid(DPoly(dz), n, eng), root_int, n)[: hi - lo]

    # u_i = v_i / Z'(w^i), weighted by w^-i for the convolution kernel
    a = values[lo:hi]
    if hi > lo:
        u = L.mont_mul(a, L.batch_inv(dz_vals))
        w_inv = pow(root_int, -1, P)
        a = L.mont_mul(u, powers_mont(w_inv, hi - lo, device, scale_int=pow(w_inv, lo, P)))
    a_full = DPoly(a).padded(rows.stop - rows.start)

    # S_j = sum_i u_i / (w^j - w^i) as a cyclic convolution with h
    h_ntt = eng.constrain(_h_table_ntt(root_int, n, device), n)
    s = eng.intt(L.mont_mul(eng.ntt(a_full, root_int, n), h_ntt), root_int, n)
    ivals = L.mont_mul(zvals, s)
    ivals[: hi - lo] = values[lo:hi]
    return DPoly.held(eng.intt(ivals, root_int, n), n, eng).truncated(k)


# -----------------------------------------------------------------------------
# Evaluation at many points
# -----------------------------------------------------------------------------


def _power_table(points: torch.Tensor, n: int) -> torch.Tensor:
    """[n, k, 8]: points^e for e < n, by doubling (log2 n multiplies)."""
    pows = L.one_mont(points.device).expand((1,) + tuple(points.shape)).clone()
    xp = points
    while pows.shape[0] < n:
        pows = torch.cat([pows, L.mont_mul(pows, xp)])
        xp = L.mont_sqr(xp)
    return pows[:n]


#: coefficient count from which evaluation leaves Horner's rule (one
#: dependent Montgomery product per coefficient) for the log-depth form; the
#: JAX package's ``_PARALLEL_EVAL_MIN``
PARALLEL_EVAL_MIN = 513


def _evaluate_horner(coeffs: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """coeffs [nb, n, 8] at shared points [k, 8], or at points [nb, k, 8]
    of their own, -> [nb, k, 8]: n dependent steps, all polynomials at
    once."""
    acc = torch.zeros((coeffs.shape[0],) + tuple(points.shape[-2:]), dtype=L.DTYPE,
                      device=points.device)
    for j in range(coeffs.shape[1] - 1, -1, -1):
        acc = L.add_mod(L.mont_mul(acc, points), coeffs[:, j].unsqueeze(1))
    return acc


def _evaluate_parallel(coeffs: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """coeffs [nb, n, 8] at shared points [k, 8], or at points [nb, k, 8]
    of their own, -> [nb, k, 8] at log depth: the powers x^0..x^(n-1) by
    doubling, then every coefficient-power product and a tree sum.  The
    products are taken in blocks of coefficients (at most
    ``limbs.MUL_BLOCK`` products each, one step of the product, so the tree
    sum never holds more) and the blocks' sums added; field sums are exact,
    so this equals the JAX package's single zero-padded tree sum."""
    nb, n = coeffs.shape[0], coeffs.shape[1]
    k = points.shape[-2]
    pows = _power_table(points, n)  # [n, k, 8] or [n, nb, k, 8]
    if points.dim() == 3:
        pows = pows.transpose(0, 1)
    step = max(1, L.MUL_BLOCK // (nb * k))
    acc = None
    for j in range(0, n, step):
        prods = L.mont_mul(pows[..., j : j + step, :, :], coeffs[:, j : j + step].unsqueeze(2))
        part = _tree_sum(prods, dim=1)  # [nb, k, 8]
        acc = part if acc is None else L.add_mod(acc, part)
    return acc


def evaluate_polys_shared(coeffs: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Polynomials coeffs [nb, n, 8] at shared points [k, 8] -> [nb, k, 8]:
    Horner's rule below :data:`PARALLEL_EVAL_MIN` coefficients, the
    log-depth form from there (the verifier's transition zerofier and the
    chain's round-constant polynomials).  Points [nb, k, 8] give each
    polynomial its own (:func:`evaluate_many_batched`)."""
    nb, n = coeffs.shape[0], coeffs.shape[1]
    if n == 0:
        return torch.zeros((nb,) + tuple(points.shape[-2:]), dtype=L.DTYPE,
                           device=points.device)
    if n >= PARALLEL_EVAL_MIN:
        return _evaluate_parallel(coeffs, points)
    return _evaluate_horner(coeffs, points)


def evaluate_many(coeffs: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Dense polynomial [n, 8] at points [k, 8] -> [k, 8]."""
    return evaluate_polys_shared(coeffs.unsqueeze(0), points)[0]


def evaluate_many_batched(coeffs: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Polynomial b of coeffs [B, n, 8] at its own points [B, k, 8] ->
    [B, k, 8]."""
    if points.dim() != 3 or coeffs.shape[0] != points.shape[0]:
        raise ValueError(f"evaluate_many_batched: {coeffs.shape[0]} polynomials, "
                         f"points {tuple(points.shape)}")
    return evaluate_polys_shared(coeffs, points)


@functools.lru_cache(maxsize=None)
def _mpoly_tables(items: tuple, nvars: int, device: str):
    """A constraint's coefficients [T, 1, 8] (Montgomery) and, for each
    variable with a nonzero exponent, (its largest exponent, the term
    exponents as an index tensor [T]), on ``device``: built once per
    constraint and device (so a captured segment makes no upload)."""
    exps = np.zeros((len(items), nvars), dtype=np.int64)
    for t, (k, _) in enumerate(items):
        for v, e in enumerate(k):
            if v < nvars:
                exps[t, v] = e
            else:
                assert e == 0, "exponent on missing variable"
    coeffs = L.ints_to_mont([v for _, v in items], device).unsqueeze(1)
    index = [
        (v, int(exps[:, v].max()), torch.from_numpy(exps[:, v].copy()).to(device))
        for v in range(nvars)
        if exps[:, v].max() > 0
    ]
    return coeffs, index


def mpoly_evaluate_codewords(
    dictionary: dict[tuple[int, ...], int], points: Sequence[torch.Tensor]
) -> torch.Tensor:
    """Evaluate a sparse multivariate polynomial pointwise over codewords.

    ``points[v]`` is the codeword [N, 8] (Montgomery) of variable v.  Each
    variable's powers are built once; every term gathers its powers,
    multiplies across variables, and the terms are tree-summed.
    """
    items = tuple((tuple(k), v) for k, v in dictionary.items() if v % P != 0)
    device = points[0].device
    n = points[0].shape[0]
    if not items:
        return torch.zeros((n, L.NLIMB), dtype=L.DTYPE, device=device)
    term, index = _mpoly_tables(items, len(points), str(device))
    for v, max_e, exps in index:
        pows = _power_table(points[v], max_e + 1)
        term = L.mont_mul(term, pows[exps])
    return _tree_sum(term.expand((len(items), n, L.NLIMB)))


# -----------------------------------------------------------------------------
# Arbitrary-domain toolkit
# -----------------------------------------------------------------------------

#: both sizes at or above this send arbitrary-domain evaluation to the
#: subproduct tree (ops/multipoint.py): the JAX package's ``_TREE_EVAL_MIN``
#: (its crossover on a TPU; where it lies on the card is still open, PERF.md)
TREE_EVAL_MIN = 4096
#: from this power-of-two size, interpolation on an unstructured domain takes
#: the tree in place of host Lagrange: the JAX package's ``_TREE_INTERP_MIN``
TREE_INTERP_MIN = 2048


def fast_zerofier(domain: torch.Tensor, root_int: int, root_order: int) -> DPoly:
    """prod (x - d) over an arbitrary Montgomery domain [k, 8], built level
    by level: ceil(log2 k) batched products (``multipoint.zerofier_levels``,
    the leaves past k the constant 1), not one product a pair of nodes.
    The zerofier is unique, so its coefficients equal the host reference's.
    ``root_order`` bounds the degree, as the JAX package's products do;
    ``root_int`` is taken for parity with the JAX package's signature and is
    not read (each level's transform takes the root of its own size).  The
    prover's first-k-powers domains have :func:`zerofier_first_k`."""
    k = domain.shape[0]
    if k == 0:
        return DPoly.zero(domain.device)
    if k >= root_order:
        raise ValueError(f"fast_zerofier: degree {k} is not below the root order {root_order}")
    levels = multipoint.zerofier_levels(domain, next_pow2(k))
    return DPoly(levels[-1][: k + 1, 0], k)


def fast_evaluate_domain(poly: DPoly, domain: torch.Tensor) -> torch.Tensor:
    """``poly`` at an arbitrary Montgomery domain [k, 8] -> [k, 8]: the
    subproduct tree when k is a power of two and both k and the coefficient
    count are at least :data:`TREE_EVAL_MIN`, else :func:`evaluate_many`.
    The same field elements either way."""
    k, n = domain.shape[0], len(poly)
    if is_pow2(k) and k >= TREE_EVAL_MIN and n >= TREE_EVAL_MIN:
        return multipoint.evaluate_tree(poly.c, domain)
    return evaluate_many(poly.c, domain)


def fast_interpolate_domain(
    field_order_unused,
    domain_ints: Sequence[int],
    values_ints: Sequence[int],
    root_int: int,
    root_order: int,
    device="cuda",
) -> DPoly:
    """The polynomial of degree below k through k host points, on
    ``device``: the first k powers of ``root_int`` go to
    :func:`interpolate_first_k`; a power-of-two k from
    :data:`TREE_INTERP_MIN` to ``multipoint.interpolate_tree``; anything
    else to host Lagrange (``Polynomial.interpolate_domain``).  Interpolation is
    unique, so every branch gives the same coefficients."""
    device = resolve_device(device)
    k = len(domain_ints)
    if k != len(values_ints):
        raise ValueError(f"fast_interpolate_domain: {k} points, {len(values_ints)} values")
    if k == 0:
        return DPoly.zero(device)
    expected = 1
    structured = True
    for d in domain_ints:
        if d % P != expected:
            structured = False
            break
        expected = expected * root_int % P
    if structured and k <= root_order:
        return interpolate_first_k(root_int, root_order, k, L.ints_to_mont(values_ints, device))
    if is_pow2(k) and k >= TREE_INTERP_MIN:
        return DPoly(multipoint.interpolate_tree(L.ints_to_mont(domain_ints, device),
                                                 L.ints_to_mont(values_ints, device)))
    return DPoly.from_ints(
        Polynomial.interpolate_domain(Field(), domain_ints, values_ints).coeffs, device)

