"""The port's polynomial operations against the host Polynomial (the JAX
package's jax-free reference) and, for the long-polynomial evaluator, the
JAX package's own, on the CPU."""

import numpy as np
import pytest
import torch

from zk_stark_tpu.ops import limbs as JL
from zk_stark_tpu.ops import poly_ops as JPO
from zk_stark_tpu.poly import MPolynomial as HostMPoly
from zk_stark_tpu.poly import Polynomial as HostPoly
from zk_stark_tpu_torch.field import FIELD_PRIME as P
from zk_stark_tpu_torch.field import Field
from zk_stark_tpu_torch.ops import limbs as L
from zk_stark_tpu_torch.ops import poly_ops as PO

F = Field()
N = 64
W = F.primitive_nth_root(N).value


def _rand(seed, n):
    rng = np.random.default_rng(seed)
    hi = rng.integers(0, 1 << 63, size=n, dtype=np.uint64)
    lo = rng.integers(0, 1 << 63, size=n, dtype=np.uint64)
    return [(int(h) << 63 | int(l)) % P for h, l in zip(hi, lo)]


def _dpoly(vals):
    return PO.DPoly(L.ints_to_mont(vals, "cpu"))


def _host(vals):
    return HostPoly(F, vals)


@pytest.mark.parametrize("k", [1, 5, 33, N])
def test_interpolate_first_k(k):
    values = _rand(k, k)
    got = PO.interpolate_first_k(W, N, k, L.ints_to_mont(values, "cpu"))
    domain = [pow(W, i, P) for i in range(k)]
    want = HostPoly.interpolate_domain(F, domain, values)
    assert _host(got.to_ints()) == want


@pytest.mark.parametrize("k", [1, 27, N])
def test_zerofier_first_k(k):
    got = PO.zerofier_first_k(W, N, k, "cpu")
    want = HostPoly.zerofier_domain(F, [pow(W, i, P) for i in range(k)])
    assert got.to_ints() == want.coeffs
    assert got.degree() == k


def test_multiply_divide_and_coset_evaluate():
    a, b = _rand(1, 20), _rand(2, 9)
    prod = PO.fast_multiply(_dpoly(a), _dpoly(b), W, N)
    assert _host(prod.to_ints()) == _host(a) * _host(b)
    g = F.generator().value
    quot = PO.fast_coset_divide(prod, _dpoly(b), g, W, N)
    assert _host(quot.to_ints()) == _host(a)
    cw = PO.fast_coset_evaluate(_dpoly(a), g, W, N)
    assert [int(v) for v in L.mont_to_ints(cw)] == [
        _host(a).evaluate(g * pow(W, i, P) % P) for i in range(N)
    ]


@pytest.mark.parametrize("n", [0, 1, 28])
def test_evaluate_many(n):
    coeffs, pts = _rand(3, n), _rand(4, 5)
    got = PO.evaluate_many(L.ints_to_mont(coeffs, "cpu"), L.ints_to_mont(pts, "cpu"))
    assert [int(v) for v in L.mont_to_ints(got)] == [_host(coeffs).evaluate(x) for x in pts]


def test_long_polynomials_match_jax():
    """From 513 coefficients evaluation is log-depth; at 675 (the chain
    fixture's round-constant polynomials) it equals the JAX package's
    parallel kernel, the port's own Horner form and the host reference."""
    n, k = 675, 5
    coeffs = [_rand(20 + b, n) for b in range(3)]
    pts = _rand(30, k)
    c_t = torch.stack([L.ints_to_mont(c, "cpu") for c in coeffs])
    p_t = L.ints_to_mont(pts, "cpu")

    # the JAX package's evaluate_many runs this parallel kernel for one
    # polynomial; one compile for three holds the port's evaluate_many too
    want = np.asarray(
        JPO.evaluate_polys_shared(np.asarray(c_t.numpy(), np.uint32), JL.ints_to_mont(pts))
    )
    shared = PO.evaluate_polys_shared(c_t, p_t)
    assert np.array_equal(shared.numpy().astype(np.uint32), want)
    assert torch.equal(shared, PO._evaluate_horner(c_t, p_t))

    for b in range(3):
        got = PO.evaluate_many(c_t[b], p_t)
        assert np.array_equal(got.numpy().astype(np.uint32), want[b])
        assert [int(v) for v in L.mont_to_ints(got)] == [
            _host(coeffs[b]).evaluate(x) for x in pts
        ]


def test_long_polynomial_blocks(monkeypatch):
    """The log-depth form sums its products in blocks; blocks of 7 products
    (an uneven last block, and the power table's products in blocks of
    the same size) give the same values."""
    monkeypatch.setattr(L, "MUL_BLOCK", 7 * 2 * 3)
    c_t = torch.stack([L.ints_to_mont(_rand(40 + b, 600), "cpu") for b in range(2)])
    p_t = L.ints_to_mont(_rand(50, 3), "cpu")
    assert torch.equal(PO.evaluate_polys_shared(c_t, p_t), PO._evaluate_horner(c_t, p_t))


def test_degree_sums_and_scans():
    vals = _rand(5, 10) + [0, 0]
    d = _dpoly(vals)
    assert d.degree() == 9 and PO.DPoly.zero("cpu").degree() is None
    assert int(PO.degree_device(L.ints_to_mont([0, 0], "cpu"))) == -1
    assert int(L.mont_to_ints(PO.reduce_sum_mont(d.c))[()]) == sum(vals) % P
    got = PO.cumprod_mont(L.ints_to_mont(vals[:10], "cpu"))
    assert int(L.mont_to_ints(got)[-1]) == int(np.prod(np.array(vals[:10], dtype=object)) % P)
    assert (d + _dpoly([1])).to_ints()[0] == (vals[0] + 1) % P
    assert (d - d).is_zero() and (-d).to_ints()[1] == (-vals[1]) % P
    assert d.scale(3).to_ints()[1] == vals[1] * 3 % P
    assert d.truncated(4).to_ints() == vals[:4] and len(d.padded(16)) == 16


def test_mpoly_evaluate_codewords():
    x, y, z = HostMPoly.variables(3, F)
    c = HostMPoly.constant(F, 7)
    poly = x ** 3 * y + c * z ** 2 - y * z + c
    pts = [_rand(10 + v, 6) for v in range(3)]
    got = PO.mpoly_evaluate_codewords(
        dict(poly.dictionary), [L.ints_to_mont(p, "cpu") for p in pts]
    )
    want = [poly.evaluate([pts[v][i] for v in range(3)]) for i in range(6)]
    assert [int(v) for v in L.mont_to_ints(got)] == want
    empty = PO.mpoly_evaluate_codewords({}, [L.ints_to_mont(pts[0], "cpu")])
    assert torch.equal(empty, torch.zeros_like(empty))


def test_dpoly_leftovers_match_jax():
    """DPoly.from_ints and shift against the JAX package's DPoly on the same
    ints; const_mul and evaluate, whose JAX forms compile XLA programs of
    seconds each, against the host reference."""
    vals, x, c = _rand(40, 6), _rand(41, 1)[0], _rand(42, 1)[0]
    d, jd = PO.DPoly.from_ints(vals, "cpu"), JPO.DPoly.from_ints(vals)
    assert np.array_equal(d.c.numpy().astype(np.uint32), np.asarray(jd.c))
    shifted, jshifted = d.shift(3), jd.shift(3)
    assert shifted.to_ints() == jshifted.to_ints() == [0, 0, 0] + vals
    # the degree of a shifted polynomial: scanned, or carried from a known one
    assert shifted.degree() == 8 and PO.DPoly(d.c, 5).shift(3)._degree == 8
    assert PO.DPoly.from_ints([], "cpu").shift(2).to_ints() == []
    assert d.evaluate(x) == _host(vals).evaluate(x)
    assert d.const_mul(c).to_ints() == [v * c % P for v in vals]
    assert PO.DPoly.zero("cpu").evaluate(x) == 0


@pytest.mark.parametrize("n", [7, PO.PARALLEL_EVAL_MIN])
def test_evaluate_many_batched(n):
    """Three polynomials, each at its own 4 points, against the host
    reference: Horner below 513 coefficients, the log-depth form at 513."""
    coeffs = [_rand(50 + b, n) for b in range(3)]
    pts = [_rand(60 + b, 4) for b in range(3)]
    c_t = torch.stack([L.ints_to_mont(c, "cpu") for c in coeffs])
    p_t = torch.stack([L.ints_to_mont(p, "cpu") for p in pts])
    got = PO.evaluate_many_batched(c_t, p_t)
    assert [[int(v) for v in row] for row in L.mont_to_ints(got)] == [
        [_host(c).evaluate(x) for x in p] for c, p in zip(coeffs, pts)]
    with pytest.raises(ValueError):
        PO.evaluate_many_batched(c_t, p_t[:2])
