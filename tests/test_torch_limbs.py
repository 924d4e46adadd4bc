"""The port's limb arithmetic against the JAX package and the host Field.

Inputs are made from a numpy seed and handed to both packages; every
comparison is exact (integer field arithmetic).
"""

import numpy as np
import pytest
import torch

from zk_stark_tpu.ops import limbs as JL
from zk_stark_tpu_torch.field import FIELD_PRIME as P
from zk_stark_tpu_torch.field import Field
from zk_stark_tpu_torch.ops import limbs as L

F = Field()
EDGES = [0, 1, P - 1, P - 2]


def _rand_ints(rng, n):
    hi = rng.integers(0, 1 << 63, size=n, dtype=np.uint64)
    lo = rng.integers(0, 1 << 63, size=n, dtype=np.uint64)
    return [(int(h) << 63 | int(l)) % P for h, l in zip(hi, lo)]


@pytest.fixture(scope="module")
def operands():
    rng = np.random.default_rng(2024)
    a = EDGES + EDGES + _rand_ints(rng, 56)
    b = EDGES + EDGES[::-1] + _rand_ints(rng, 56)
    return a, b


def _port(vals):
    return L.from_numpy(L.ints_to_limbs(vals), "cpu")


def _jax(vals):
    return np.asarray(JL.ints_to_limbs(vals))


def _ints(t):
    return [int(v) for v in L.limbs_to_ints(t)]


def test_codecs_match_jax_layout(operands):
    a, _ = operands
    port = L.ints_to_limbs(a)
    assert np.array_equal(port.astype(np.uint32), _jax(a))
    assert _ints(_port(a)) == a
    mont = L.ints_to_mont(a, "cpu")
    assert np.array_equal(mont.numpy().astype(np.uint32), np.asarray(JL.ints_to_mont(a)))
    assert [int(v) for v in L.mont_to_ints(mont)] == a


@pytest.mark.parametrize(
    "name, port_fn, jax_fn, host_fn",
    [
        ("add_mod", L.add_mod, JL.add_mod_jit, lambda x, y: (x + y) % P),
        ("sub_mod", L.sub_mod, JL.sub_mod_jit, lambda x, y: (x - y) % P),
        ("mont_mul", L.mont_mul, JL.mont_mul_jit,
         lambda x, y: x * y * pow(L.R_INT, -1, P) % P),
    ],
)
def test_binary_ops(operands, name, port_fn, jax_fn, host_fn):
    a, b = operands
    got = port_fn(_port(a), _port(b))
    assert np.array_equal(got.numpy().astype(np.uint32), np.asarray(jax_fn(_jax(a), _jax(b))))
    assert _ints(got) == [host_fn(x, y) for x, y in zip(a, b)], name


@pytest.mark.parametrize("block", [1, 5, 16, 48])
def test_mont_mul_in_blocks(operands, monkeypatch, block):
    """Products larger than MUL_BLOCK run in blocks along the leading
    dimensions (a block smaller than one index of the first dimension
    recurses into it, an uneven last block is kept); broadcast operands
    give the unblocked product."""
    a, b = operands
    x = _port(a).reshape(4, 2, 8, L.NLIMB)
    y = _port(b[:8])
    want = [L.mont_mul(x, y), L.mont_mul(y.unsqueeze(1), x[0, 0])]
    monkeypatch.setattr(L, "MUL_BLOCK", block)
    assert torch.equal(L.mont_mul(x, y), want[0])
    assert torch.equal(L.mont_mul(y.unsqueeze(1), x[0, 0]), want[1])
    assert _ints(want[0].reshape(-1, L.NLIMB)) == [
        u * v * pow(L.R_INT, -1, P) % P for u, v in zip(a, b[:8] * 8)
    ]


def test_unary_ops(operands):
    a, _ = operands
    x = _port(a)
    assert np.array_equal(L.neg_mod(x).numpy(), np.asarray(JL.neg_mod_jit(_jax(a))))
    assert _ints(L.neg_mod(x)) == [(-v) % P for v in a]
    assert np.array_equal(L.to_mont(x).numpy(), np.asarray(JL.to_mont_jit(_jax(a))))
    assert _ints(L.from_mont(L.to_mont(x))) == a
    assert _ints(L.mont_sqr(x)) == _ints(L.mont_mul(x, x))
    assert L.is_zero(x).tolist() == [v == 0 for v in a]


@pytest.mark.parametrize("e", [0, 1, 5, 200, P - 2])
def test_mont_pow_against_host_field(operands, e):
    a, _ = operands
    got = [int(v) for v in L.mont_to_ints(L.mont_pow(L.ints_to_mont(a[:12], "cpu"), e))]
    assert got == [(F(v) ** e).value for v in a[:12]]


def test_mont_pow_matches_jax(operands):
    a, _ = operands
    got = L.mont_pow(L.ints_to_mont(a, "cpu"), 3)
    assert np.array_equal(got.numpy(), np.asarray(JL.mont_pow_jit(JL.ints_to_mont(a), 3)))


@pytest.mark.parametrize("n", [1, 5, 64])
def test_batch_inv(operands, n):
    a, _ = operands
    got = L.batch_inv(L.ints_to_mont(a[:n], "cpu"))
    assert [int(v) for v in L.mont_to_ints(got)] == [F.inv(v) for v in a[:n]]


def test_batch_inv_matches_jax(operands):
    a, _ = operands
    got = L.batch_inv(L.ints_to_mont(a, "cpu"))
    assert np.array_equal(got.numpy(), np.asarray(JL.batch_inv_jit(JL.ints_to_mont(a))))


def test_cumprod_blocked(operands):
    a, _ = operands
    vals = [v for v in a if v][:40]
    got = L.cumprod_mont_blocked(L.ints_to_mont(vals, "cpu"))
    expect, acc = [], 1
    for v in vals:
        acc = acc * v % P
        expect.append(acc)
    assert [int(v) for v in L.mont_to_ints(got)] == expect
    assert torch.equal(got, L.cumprod_mont_blocked(L.ints_to_mont(vals, "cpu"), cols=3))
