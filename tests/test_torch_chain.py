"""The port's Rescue-permutation chain (``models/rescue_chain.py``) against
the JAX package's, and the chain proof fixture that the JAX package made
(``tools/make_chain_fixture.py``: chain length 25, FRI 2^14), on the CPU.

On the card, chip_smoke.py reproduces the same fixture and proves the chain
at length 3200 (FRI 2^20).
"""

import hashlib
import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zk_stark_tpu.field import Field as JaxField
from zk_stark_tpu.models.rescue_chain import RescueChain as JaxChain
from zk_stark_tpu.models.rescue_chain import make_chain_stark as jax_make_chain_stark
from zk_stark_tpu.ops import limbs as JL
from zk_stark_tpu_torch.carry import (
    DetRng,
    chain_from_config,
    limbs_from_numpy,
    limbs_to_numpy,
)
from zk_stark_tpu_torch.field import FIELD_PRIME as P
from zk_stark_tpu_torch.field import Field
from zk_stark_tpu_torch.models.rescue_chain import RescueChain
from zk_stark_tpu_torch.models.rescue_prime import RescuePrime
from zk_stark_tpu_torch.ops import limbs as L
from zk_stark_tpu_torch.proof_stream import ProofStream
from zk_stark_tpu_torch.stark import ProvingError, VerificationError

F = Field()
FIXTURES = pathlib.Path(__file__).parent / "fixtures"
#: the JAX package's own chain test configuration (tests/test_chain.py)
SMALL = dict(chain_length=2, expansion_factor=4, num_collinearity_checks=2, security_level=2)


def _rand(seed, n):
    rng = np.random.default_rng(seed)
    hi = rng.integers(0, 1 << 63, size=n, dtype=np.uint64)
    lo = rng.integers(0, 1 << 63, size=n, dtype=np.uint64)
    return [(int(h) << 63 | int(l)) % P for h, l in zip(hi, lo)]


def test_run_and_trace_match_jax():
    jf = JaxField()
    for length, x in ((1, 12345), (2, 7)):
        port, ref = RescueChain(F, length, device="cpu"), JaxChain(jf, length)
        trace = port.trace(x)
        assert len(trace) == port.num_cycles == 27 * length + 1
        assert trace == ref.trace(x)
        assert port.run(x) == ref.run(x) == trace[-1][0]
    assert RescueChain(F, 1, device="cpu").run(1) == RescuePrime(F).hash(1)


def test_evaluate_codewords_matches_jax():
    """The constraints at random points (the verifier's path: the constant
    polynomials evaluated there) equal the JAX package's at the small
    config.  The JAX AIR is handed the port's round-constant polynomials,
    which spares a minute of XLA-CPU compiles of its interpolation, so the
    port's interpolation is held against the JAX package's by
    test_constant_polys_carry, at the fixture config.  The prover's path
    (the constant codewords on the FRI coset) is held by the fixture proof,
    which the JAX package made."""
    jmodel, jstark = jax_make_chain_stark(
        JaxField(), 2, expansion_factor=4, num_collinearity_checks=2, security_level=2
    )
    model, stark = chain_from_config(SMALL, device="cpu")
    assert stark.fri.domain_length == jstark.fri.domain_length == 1024
    assert model.stark_geometry == jmodel._stark_geometry
    jair = jmodel.air(jstark.omicron, jstark.omicron_domain_length)
    air = model.air(stark.omicron, stark.omicron_domain_length)
    jair._const_cache["coeffs"] = jnp.asarray(limbs_to_numpy(air._constant_polys()))
    vals = [_rand(60 + v, 6) for v in range(5)]  # x, cur0, cur1, nxt0, nxt1
    got = air.evaluate_codewords([L.ints_to_mont(v, "cpu") for v in vals])
    want = jair.evaluate_codewords([JL.ints_to_mont(v) for v in vals])
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert np.array_equal(limbs_to_numpy(g), np.asarray(w))


@pytest.fixture(scope="module")
def fixture_proof():
    meta = json.loads((FIXTURES / "chain_meta.json").read_text())
    ref = (FIXTURES / "chain_proof.bin").read_bytes()
    model, stark = chain_from_config(
        meta["config"], device="cpu", rng=DetRng(meta["rng_tag"].encode())
    )
    air = model.air(stark.omicron, stark.omicron_domain_length)
    trace = model.trace(int(meta["input"]))
    boundary = model.boundary_constraints(trace[-1][0])
    proof = stark.prove(trace, air, boundary, ProofStream(F))
    return meta, ref, model, stark, air, proof


def test_chain_fixture_reproduced_byte_for_byte(fixture_proof):
    meta, ref, model, stark, _, proof = fixture_proof
    assert stark.omicron_domain_length == meta["omicron_domain_length"] == 1 << 12
    assert stark.fri.domain_length == meta["fri_domain_length"] == 1 << 14
    assert model.run(int(meta["input"])) == int(meta["output"])
    assert hashlib.sha256(proof).hexdigest() == meta["proof_sha256"]
    assert len(proof) == meta["proof_bytes"]
    assert proof == ref


def test_constant_polys_carry(fixture_proof):
    """The JAX package's round-constant polynomials at the fixture config
    (uint32 [4, 675, 8], saved by tools/make_chain_fixture.py), carried over
    through limbs_from_numpy, equal the port's own interpolation."""
    _, _, _, _, air, _ = fixture_proof
    arr = np.load(FIXTURES / "chain_constant_polys.npy")
    assert arr.shape == (4, 675, 8) and arr.dtype == np.uint32
    assert torch.equal(limbs_from_numpy(arr, "cpu"), air._constant_polys())
    assert np.array_equal(limbs_to_numpy(air._constant_polys()), arr)


def test_chain_fixture_verifies_and_wrong_output_fails(fixture_proof):
    meta, ref, model, stark, air, _ = fixture_proof
    y = int(meta["output"])
    stark.verify(air, model.boundary_constraints(y), ProofStream.deserialize(ref, F))
    with pytest.raises(VerificationError):
        stark.verify(
            air, model.boundary_constraints((y + 1) % P), ProofStream.deserialize(ref, F)
        )


def test_chain_false_witness_rejected():
    """As the JAX package's test: the prover's degree check raises
    ProvingError, or the proof it makes fails verification."""
    model, stark = chain_from_config(SMALL, device="cpu")
    air = model.air(stark.omicron, stark.omicron_domain_length)
    trace = model.trace(42)
    boundary = model.boundary_constraints(trace[-1][0])
    trace[30][1] = (trace[30][1] + 5) % P
    try:
        proof = stark.prove(trace, air, boundary, ProofStream(F))
    except ProvingError:
        return
    with pytest.raises(VerificationError):
        stark.verify(air, boundary, ProofStream.deserialize(proof, F))
