"""The port's subproduct trees (ops/multipoint.py) and the arbitrary-domain
toolkit of ops/poly_ops.py against the JAX package's jax-free host
Polynomial (Horner, Lagrange, zerofier_domain), as the JAX package's own
tree tests hold its trees, on the CPU.  Interpolation and zerofiers are
unique, so every comparison is exact.  The JAX package's trees run eagerly
on XLA-CPU for minutes even at k = 4; they are compared only under
``slow``."""

import math

import numpy as np
import pytest

from zk_stark_tpu.poly import Polynomial as HostPoly
from zk_stark_tpu_torch.field import FIELD_PRIME as P
from zk_stark_tpu_torch.field import Field
from zk_stark_tpu_torch.ops import limbs as L
from zk_stark_tpu_torch.ops import multipoint as M
from zk_stark_tpu_torch.ops import poly_ops as PO
from zk_stark_tpu_torch.poly import Polynomial

F = Field()
ROOT_ORDER = 1 << 20
ROOT = F.primitive_nth_root(ROOT_ORDER).value


def _rand(seed, n):
    rng = np.random.default_rng(seed)
    hi = rng.integers(0, 1 << 63, size=n, dtype=np.uint64)
    lo = rng.integers(0, 1 << 63, size=n, dtype=np.uint64)
    return [(int(h) << 63 | int(l)) % P for h, l in zip(hi, lo)]


def _mont(vals):
    return L.ints_to_mont(vals, "cpu")


def _ints(t):
    return [int(v) for v in L.mont_to_ints(t)]


def _counted(monkeypatch, module, name):
    calls = []
    fn = getattr(module, name)

    def wrapper(*args):
        calls.append(args)
        return fn(*args)

    monkeypatch.setattr(module, name, wrapper)
    return calls


@pytest.mark.parametrize("k, n", [(1, 3), (8, 8), (32, 32), (64, 64), (32, 200)])
def test_evaluate_tree_matches_horner(k, n):
    domain, coeffs = _rand(k, k), _rand(100 + n, n)
    got = _ints(M.evaluate_tree(_mont(coeffs), _mont(domain)))
    assert got == [HostPoly(F, coeffs).evaluate(x) for x in domain]


@pytest.mark.parametrize("k, degree", [(8, 7), (32, 31), (32, 9)])
def test_interpolate_tree_matches_lagrange(k, degree):
    """Values of a random polynomial of the given degree at k random points:
    the tree gives host Lagrange's coefficients, its top k - 1 - degree
    zero, and evaluating them on the domain gives the values back."""
    domain, coeffs = _rand(200 + k, k), _rand(300 + degree, degree + 1)
    values = [HostPoly(F, coeffs).evaluate(x) for x in domain]
    got = M.interpolate_tree(_mont(domain), _mont(values))
    assert _ints(got) == HostPoly.interpolate_domain(F, domain, values).coeffs
    assert _ints(got) == coeffs + [0] * (k - 1 - degree)
    assert _ints(M.evaluate_tree(got, _mont(domain))) == values


def test_wide_batches_split_above_one_block(monkeypatch):
    """Above one block the NTT kernel lays the batch on the grid's y
    dimension, so a wider batch goes in several calls: with one block
    lowered to 4 points and the y limit to 3, a 32-point tree's upper
    levels split (and equal host Horner)."""
    monkeypatch.setattr(M, "MAX_KERNEL_N", 4)
    monkeypatch.setattr(M, "MAX_GRID_YZ", 3)
    batches = _counted(monkeypatch, M, "_bntt")
    transforms = _counted(monkeypatch, M, "ntt_mont")
    domain, coeffs = _rand(1000, 32), _rand(1001, 32)
    got = _ints(M.evaluate_tree(_mont(coeffs), _mont(domain)))
    assert got == [HostPoly(F, coeffs).evaluate(x) for x in domain]
    assert any(x.shape[0] > 4 and x.shape[1] > 3 for x, _ in batches)
    assert max(x.shape[1] for x, _ in transforms if x.shape[0] > 4) <= 3


def test_trees_refuse_other_sizes():
    with pytest.raises(ValueError, match="power of two"):
        M.evaluate_tree(_mont([1, 2]), _mont([1, 2, 3]))
    with pytest.raises(ValueError, match="values"):
        M.interpolate_tree(_mont([1, 2, 3, 4]), _mont([1, 2]))


@pytest.mark.parametrize("k", [1, 13, 64])
def test_fast_zerofier_matches_host(monkeypatch, k):
    """Built level by level: at most ceil(log2 k) batched products (6 at
    k = 64, where a product a pair of nodes would take 63)."""
    domain = _rand(400 + k, k)
    products = _counted(monkeypatch, M, "_bmul")
    z = PO.fast_zerofier(_mont(domain), ROOT, ROOT_ORDER)
    assert len(products) <= math.ceil(math.log2(k))
    assert z.to_ints() == HostPoly.zerofier_domain(F, domain).coeffs
    assert z.degree() == k
    assert PO.fast_zerofier(_mont([]), ROOT, ROOT_ORDER).to_ints() == []
    with pytest.raises(ValueError, match="root order"):
        PO.fast_zerofier(_mont(domain), F.primitive_nth_root(1).value, 1)


@pytest.mark.parametrize("lowered, k, n, tree", [(True, 16, 20, True), (True, 16, 8, False),
                                                 (True, 12, 20, False), (False, 16, 20, False)])
def test_fast_evaluate_domain_branches(monkeypatch, lowered, k, n, tree):
    """The tree takes a power-of-two domain when both sizes reach
    TREE_EVAL_MIN (lowered to 16 here where ``lowered``), else
    evaluate_many; the same values either way."""
    if lowered:
        monkeypatch.setattr(PO, "TREE_EVAL_MIN", 16)
    trees = _counted(monkeypatch, M, "evaluate_tree")
    domain, coeffs = _rand(500 + k, k), _rand(600 + n, n)
    got = PO.fast_evaluate_domain(PO.DPoly(_mont(coeffs)), _mont(domain))
    assert len(trees) == tree
    assert _ints(got) == [HostPoly(F, coeffs).evaluate(x) for x in domain]


@pytest.mark.parametrize("branch, k", [("structured", 11), ("tree", 32), ("lagrange", 13),
                                       ("lagrange", 32)])
def test_fast_interpolate_domain_branches(monkeypatch, branch, k):
    """First-k-powers domains interpolate in closed form; power-of-two
    domains from TREE_INTERP_MIN (lowered to 16 for the tree case) on the
    tree; others by host Lagrange.  Each equals Polynomial.interpolate_domain."""
    if branch == "tree":
        monkeypatch.setattr(PO, "TREE_INTERP_MIN", 16)
    trees = _counted(monkeypatch, M, "interpolate_tree")
    firsts = _counted(monkeypatch, PO, "interpolate_first_k")
    root, order = F.primitive_nth_root(64).value, 64
    if branch == "structured":
        domain = [pow(root, i, P) for i in range(k)]
    else:
        domain = _rand(700 + k, k)
    values = _rand(800 + k, k)
    got = PO.fast_interpolate_domain(None, domain, values, root, order, device="cpu")
    assert (len(firsts), len(trees)) == (branch == "structured", branch == "tree")
    assert got.to_ints() == HostPoly.interpolate_domain(F, domain, values).coeffs


def test_fast_interpolate_domain_edges():
    assert PO.fast_interpolate_domain(None, [], [], ROOT, ROOT_ORDER, device="cpu").to_ints() == []
    with pytest.raises(ValueError, match="values"):
        PO.fast_interpolate_domain(None, [1, 2], [3], ROOT, ROOT_ORDER, device="cpu")
    with pytest.raises(ValueError):  # a repeated point has no interpolant
        PO.fast_interpolate_domain(None, [5, 7, 5], [1, 2, 3], ROOT, ROOT_ORDER, device="cpu")


@pytest.mark.parametrize("k", [1, 2, 5, 40])
def test_host_interpolate_domain_matches_jax_host(k):
    """The port's O(k^2) host Lagrange against the JAX package's O(k^3)."""
    domain, values = _rand(900 + k, k), _rand(950 + k, k)
    assert Polynomial.interpolate_domain(Field(), domain, values).coeffs == \
        HostPoly.interpolate_domain(F, domain, values).coeffs


@pytest.mark.slow
def test_structured_branch_matches_jax():
    """About a minute of XLA-CPU compiles for the JAX package's closed form."""
    from zk_stark_tpu.ops import poly_ops as JPO

    root, order = F.primitive_nth_root(16).value, 16
    domain = [pow(root, i, P) for i in range(11)]
    values = _rand(11, 11)
    got = PO.fast_interpolate_domain(None, domain, values, root, order, device="cpu")
    assert got.to_ints() == JPO.fast_interpolate_domain(None, domain, values, root,
                                                        order).to_ints()


@pytest.mark.slow
def test_trees_match_jax():
    """The JAX package's trees run eagerly on XLA-CPU: minutes at k = 8."""
    from zk_stark_tpu.ops import limbs as JL
    from zk_stark_tpu.ops import multipoint as JM

    domain, coeffs, values = _rand(1, 8), _rand(2, 8), _rand(3, 8)
    got = M.evaluate_tree(_mont(coeffs), _mont(domain))
    want = JM.evaluate_tree(JL.ints_to_mont(coeffs), JL.ints_to_mont(domain))
    assert np.array_equal(got.numpy().astype(np.uint32), np.asarray(want))
    got = M.interpolate_tree(_mont(domain), _mont(values))
    want = JM.interpolate_tree(JL.ints_to_mont(domain), JL.ints_to_mont(values))
    assert np.array_equal(got.numpy().astype(np.uint32), np.asarray(want))
