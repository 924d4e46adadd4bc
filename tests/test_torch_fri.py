"""The port's FRI: the fold round against the JAX package's, and a
prove/verify round trip on the CPU."""

import numpy as np
import pytest

from zk_stark_tpu.fri import _fold_round_kernel_cached
from zk_stark_tpu.ops import limbs as JL
from zk_stark_tpu.parallel.engine import DEFAULT
from zk_stark_tpu_torch import merkle
from zk_stark_tpu_torch.field import FIELD_PRIME as P
from zk_stark_tpu_torch.field import Field
from zk_stark_tpu_torch.fri import FRI
from zk_stark_tpu_torch.ops import fold as FO
from zk_stark_tpu_torch.ops import limbs as L
from zk_stark_tpu_torch.ops.ntt import powers_mont
from zk_stark_tpu_torch.ops.poly_ops import DPoly, fast_coset_evaluate
from zk_stark_tpu_torch.proof_stream import Codeword, ProofStream, Root

F = Field()


def _rand(rng, n):
    hi = rng.integers(0, 1 << 63, size=n, dtype=np.uint64)
    lo = rng.integers(0, 1 << 63, size=n, dtype=np.uint64)
    return [(int(h) << 63 | int(l)) % P for h, l in zip(hi, lo)]


def test_fold_round_matches_jax():
    n = 512
    rng = np.random.default_rng(11)
    cw_ints = _rand(rng, n)
    omega = F.primitive_nth_root(n).value
    g = F.generator().value
    alpha = _rand(rng, 1)[0]
    ao_int = alpha * pow(g, -1, P) % P

    cw = L.ints_to_mont(cw_ints, "cpu")
    invpows = powers_mont(pow(omega, -1, P), n // 2, "cpu")
    ao = L.int_to_mont(ao_int, "cpu")
    two_inv = L.int_to_mont(pow(2, -1, P), "cpu")
    folded, canon = FO.fold_round(cw, invpows, ao, two_inv)

    jf, jc = _fold_round_kernel_cached(n, DEFAULT)(
        JL.ints_to_mont(cw_ints),
        invpows.numpy().astype(np.uint32),
        ao.numpy().astype(np.uint32),
        two_inv.numpy().astype(np.uint32),
    )
    assert np.array_equal(folded.numpy().astype(np.uint32), np.asarray(jf))
    assert np.array_equal(canon.numpy().astype(np.uint32), np.asarray(jc))

    # and the fold formula on host ints
    inv_w = pow(omega, -1, P)
    half = n // 2
    expect = [
        pow(2, -1, P)
        * ((1 + ao_int * pow(inv_w, i, P)) * cw_ints[i]
           + (1 - ao_int * pow(inv_w, i, P)) * cw_ints[i + half]) % P
        for i in range(half)
    ]
    assert [int(v) for v in L.limbs_to_ints(canon)] == expect


def test_fold_kernel_refuses_cpu_tensors():
    cw = L.ints_to_mont([1, 2, 3, 4], "cpu")
    one = L.int_to_mont(1, "cpu")
    with pytest.raises(ValueError, match="CUDA tensor"):
        FO.fold_kernel(cw, cw[:2], one, one)


def _fri(n=512, checks=2):
    return FRI(F, F.generator().value, F.primitive_nth_root(n).value, n, 4, checks, device="cpu")


def _codeword(fri, degree, seed):
    coeffs = L.ints_to_mont(_rand(np.random.default_rng(seed), degree + 1), "cpu")
    return fast_coset_evaluate(DPoly(coeffs), fri.offset, fri.omega, fri.domain_length)


def test_prove_verify_round_trip():
    fri = _fri()
    cw = _codeword(fri, fri.domain_length // 4 - 1, seed=1)
    ps = ProofStream(F)
    indices = fri.prove(cw, ps)
    assert len(indices) == fri.num_colinearity_tests
    assert all(0 <= i < fri.domain_length // 2 for i in indices)

    verifier = ProofStream.deserialize(ps.serialize(), F)
    points = []
    fri.verify(verifier, points)
    values = [int(v) for v in L.mont_to_ints(cw)]
    assert len(points) == 2 * fri.num_colinearity_tests
    for i, v in points:
        assert values[i] == v


def test_commit_adds_no_cached_constant():
    """Each round's folding scalar alpha / offset is a value of the proof: a
    second commit with another transcript (so other alphas) leaves the cache
    of configuration constants (limbs.const) as it was."""
    fri = _fri()
    cw = _codeword(fri, fri.domain_length // 4 - 1, seed=4)
    first = ProofStream(F)
    fri.commit(cw, first)
    size = L._const.cache_info().currsize
    second = ProofStream(F)
    second.push(Root(bytes(64)))
    fri.commit(cw, second)
    # the same first root, then other folds
    assert second.items[1] == first.items[0] and second.items[2] != first.items[1]
    assert L._const.cache_info().currsize == size


def test_high_degree_codeword_rejected():
    fri = _fri()
    cw = _codeword(fri, fri.domain_length // 2, seed=2)
    ps = ProofStream(F)
    fri.prove(cw, ps)
    with pytest.raises(ValueError):
        fri.verify(ProofStream.deserialize(ps.serialize(), F), [])


def test_overlong_last_codeword_rejected(monkeypatch):
    """A last codeword 512 times the honest length, with its root forged to
    match, passes the omega-order check; it is refused before its NTT runs."""
    fri = _fri()
    rounds = fri.num_rounds()
    ps = ProofStream(F)
    fri.prove(_codeword(fri, fri.domain_length // 4 - 1, seed=3), ps)
    honest = ps.items[rounds].values
    assert len(honest) == fri.domain_length >> (rounds - 1)
    long = honest * 512
    assert len(long) > 4096
    forged = ProofStream(F)
    forged.items = (
        ps.items[: rounds - 1]
        + [Root(merkle.commit_ints(long)), Codeword(long)]
        + ps.items[rounds + 1 :]
    )

    def unreachable(*args):
        raise AssertionError("the low-degree check ran")

    monkeypatch.setattr(FRI, "_last_codeword_check", unreachable)
    with pytest.raises(ValueError, match="wrong length"):
        fri.verify(ProofStream.deserialize(forged.serialize(), F), [])


def test_cuda_fri_refuses_domains_beyond_the_kernel():
    """On the card the NTT reaches 2^36 points through the three-pass
    split, so 2^20 and 2^25 domains are taken and a 2^37 one refused up
    front."""
    FRI(F, 1, F.primitive_nth_root(1 << 20).value, 1 << 20, 4, 2, device="cuda")
    FRI(F, 1, F.primitive_nth_root(1 << 25).value, 1 << 25, 4, 2, device="cuda")
    with pytest.raises(NotImplementedError, match="recursive split"):
        FRI(F, 1, F.primitive_nth_root(1 << 37).value, 1 << 37, 4, 2, device="cuda")


def test_query_pushes_what_prove_pushes():
    """FRI.query on the fixture configuration's first round (FRI 512, two
    checks) pushes the items that prove pushed for that round, after the
    same commitment."""
    fri = _fri()
    cw = _codeword(fri, fri.domain_length // 4 - 1, seed=5)
    proved = ProofStream(F)
    top = fri.prove(cw, proved)
    queried = ProofStream(F)
    trees = fri.commit(cw, queried)
    n_commit = len(queried.items)
    assert queried.items == proved.items[:n_commit]
    half = trees[0].n // 2
    indices_c = [i % half for i in top]
    assert fri.query(trees[0], trees[1], indices_c, queried) == (
        indices_c + [i + half for i in indices_c])
    k = fri.num_colinearity_tests
    assert len(queried.items) == n_commit + 4 * k
    assert queried.items[n_commit:] == proved.items[n_commit : n_commit + 4 * k]


def test_evaluate_domain_matches_jax():
    from zk_stark_tpu.field import Field as JField
    from zk_stark_tpu.fri import FRI as JFRI

    fri = _fri(64)
    jfri = JFRI(JField(), fri.offset, fri.omega, 64, 4, 2)
    got = fri.evaluate_domain()
    assert got == jfri.evaluate_domain()
    assert got == [fri.offset * pow(fri.omega, i, P) % P for i in range(64)]
