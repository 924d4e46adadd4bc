"""The prover's and verifier's cached segments (``zk_stark_tpu_torch/segments.py``)
on the CPU, where each segment runs its body eagerly on its static buffers.

The card captures each segment once per configuration as a CUDA graph and
replays it; chip_smoke.py's segment phase holds the replayed proofs against
the bodies called directly there.  Here the cache keys, the static input
and output buffers and the proofs made through them are held against the
fixtures.
"""

import json
import pathlib

import pytest
import torch

from zk_stark_tpu.field import Field as JaxField
from zk_stark_tpu.models.air import ConstraintSystemAir as JaxAir
from zk_stark_tpu.models.rescue_prime import RescuePrime as JaxRescuePrime
from zk_stark_tpu_torch import segments
from zk_stark_tpu_torch.carry import DetRng, chain_from_config, rpsss_from_config
from zk_stark_tpu_torch.field import Field
from zk_stark_tpu_torch.models.air import ConstraintSystemAir
from zk_stark_tpu_torch.models.rescue_prime import RescuePrime
from zk_stark_tpu_torch.proof_stream import ProofStream
from zk_stark_tpu_torch.stark import Stark

FIXTURES = pathlib.Path(__file__).parent / "fixtures"
META = json.loads((FIXTURES / "meta.json").read_text())
SIGNATURE = (FIXTURES / "signature.bin").read_bytes()
DOC = META["document"].encode()
#: rng B: another deterministic transcript than the fixture's (rng A)
TAG_B = b"segments-rng-b"


def _sign(tag: bytes = b"zk-stark-fixture", config=None) -> tuple:
    """(rpsss, pk, signature of DOC) from a fresh signer on the CPU."""
    rpsss = rpsss_from_config(config or META["config"], device="cpu", rng=DetRng(tag))
    sk, pk = rpsss.keygen()
    return rpsss, pk, rpsss.sign(sk, DOC)


def _entries(name: str, stark: Stark) -> list:
    return [k for k in Stark._SEG_CACHE if k[:2] == (name, stark._config_key())]


@pytest.fixture(scope="module")
def signature_b() -> bytes:
    """X: the fixture config's signature with rng B, made through freshly
    built segments."""
    Stark._SEG_CACHE.clear()
    return _sign(TAG_B)[2]


def test_segment_buffers_on_cpu():
    """A segment copies each input into its own buffer, runs the body on
    those, and returns the same output tensors at every call, holding the
    last call's values; inputs of other shapes are refused."""
    seen = []

    def body(x, ys):
        seen.append((x, ys))
        return x + 1, [y * 2 for y in ys]

    seg = segments.Segment("test", body, "cpu")
    x, ys = torch.arange(4), [torch.ones(2), torch.zeros(3)]
    out1 = seg(x, ys)
    assert seen[0][0] is seg.inputs[0] and seen[0][0] is not x
    assert torch.equal(out1[0], x + 1) and torch.equal(out1[1][0], 2 * ys[0])
    out2 = seg(x + 10, [torch.full((2,), 5.0), torch.ones(3)])
    assert out2[0] is out1[0] and out2[1][1] is out1[1][1]
    assert torch.equal(out1[0], x + 11) and torch.equal(out1[1][1], 2 * torch.ones(3))
    assert seen[1][0] is seen[0][0]
    with pytest.raises(ValueError, match="static buffers"):
        seg(torch.arange(5), ys)
    assert segments.cache_get({}, ("k",), lambda: seg) is seg


def test_segments_shared_per_configuration():
    """Two Starks of one configuration share one cached segment per name (and
    both sign the fixture); another configuration adds its own entries."""
    Stark._SEG_CACHE.clear()
    first, pk, sig = _sign()
    second, _, sig2 = _sign()
    assert sig == sig2 == SIGNATURE
    assert first.verify(pk, DOC, sig)
    assert first.stark._config_key() == second.stark._config_key()
    for name in ("seg1", "seg2", "verify_seg"):
        assert len(_entries(name, first.stark)) == 1, name
    count = len(Stark._SEG_CACHE)
    other = dict(META["config"], num_collinearity_checks=3)
    third, _, _ = _sign(config=other)
    assert third.stark._config_key() != first.stark._config_key()
    assert len(_entries("seg1", third.stark)) == len(_entries("seg2", third.stark)) == 1
    assert len(Stark._SEG_CACHE) == count + 2


def test_no_stale_static_buffers(signature_b):
    """A prove with rng A, then one with rng B, through the same cached
    segments: the fixture signature, then exactly what rng B gives through
    freshly built segments."""
    Stark._SEG_CACHE.clear()
    assert _sign()[2] == SIGNATURE
    assert _sign(TAG_B)[2] == signature_b


def test_verify_between_proves(signature_b):
    """A verify (its combination segment and the FRI's last-codeword
    segment) between two proves changes neither proof."""
    Stark._SEG_CACHE.clear()
    rpsss, pk, sig = _sign()
    assert sig == SIGNATURE
    assert rpsss.verify(pk, DOC, sig)
    assert not rpsss.verify(pk, b"other document", sig)
    rpsss_b, pk_b, sig_b = _sign(TAG_B)
    assert sig_b == signature_b
    assert rpsss_b.verify(pk_b, DOC, sig_b) and rpsss.verify(pk, DOC, sig)


def test_chain_fixture_twice_through_cached_segments():
    """The chain fixture (made by the JAX package) comes out byte for byte
    twice in a row, the second prove through the first one's segments."""
    meta = json.loads((FIXTURES / "chain_meta.json").read_text())
    ref = (FIXTURES / "chain_proof.bin").read_bytes()
    Stark._SEG_CACHE.clear()
    model, stark = chain_from_config(meta["config"], device="cpu",
                                     rng=DetRng(meta["rng_tag"].encode()))
    air = model.air(stark.omicron, stark.omicron_domain_length)
    trace = model.trace(int(meta["input"]))
    boundary = model.boundary_constraints(trace[-1][0])
    first = stark.prove(trace, air, boundary, ProofStream(stark.field))
    count = len(Stark._SEG_CACHE)
    stark._rng = DetRng(meta["rng_tag"].encode())
    second = stark.prove(trace, air, boundary, ProofStream(stark.field))
    assert first == ref and second == ref
    assert len(Stark._SEG_CACHE) == count


def test_constraint_fingerprint_matches_jax():
    """ConstraintSystemAir.fingerprint() equals the JAX package's for the
    RPSSS constraints at the fixture config."""
    rpsss = rpsss_from_config(META["config"], device="cpu", rng=DetRng())
    omicron, odl = rpsss.stark.omicron, rpsss.stark.omicron_domain_length
    port = ConstraintSystemAir(RescuePrime(Field()).transition_constraints(omicron, odl))
    ref = JaxAir(JaxRescuePrime(JaxField()).transition_constraints(omicron, odl))
    assert port.fingerprint() == ref.fingerprint()
    assert hash(port.fingerprint()) == hash(ref.fingerprint())
