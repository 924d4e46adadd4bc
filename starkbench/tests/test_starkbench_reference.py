"""The plain reference agrees with the repository's fixtures and with the
measured package's host code at small sizes, and rejects what it must."""

from __future__ import annotations

import json
import random

import pytest

from starkbench import harness, yardstick
from starkbench.reference import checks, field, rescue, stark
from starkbench.reference.transcript import Reject, Transcript

FIXTURES = harness.ROOT / "tests" / "fixtures"
META = json.loads((FIXTURES / "meta.json").read_text())
CHAIN_META = json.loads((FIXTURES / "chain_meta.json").read_text())
SIGNATURE = (FIXTURES / "signature.bin").read_bytes()
CHAIN_PROOF = (FIXTURES / "chain_proof.bin").read_bytes()
RESCUE = {"m": 2, "capacity": 1, "N": 27}


def sign_config():
    return dict(META["config"], rescue=RESCUE, proof_bytes=META["signature_bytes"])


def chain_config():
    return dict(CHAIN_META["config"], rescue=RESCUE, proof_bytes=CHAIN_META["proof_bytes"])


def test_rescue_test_vector_and_port():
    from zk_stark_tpu_torch.field import Field
    from zk_stark_tpu_torch.models.rescue_prime import RescuePrime

    assert rescue.Rescue().hash(1) == 244180265933090377212304188905974087294
    rng = random.Random(5)
    for level in (2, 128):
        ours, port = rescue.Rescue(security_level=level), RescuePrime(Field(), 2, 1, level, 27)
        assert ours.mds == port.MDS and ours.round_constants == port.round_constants
        for _ in range(4):
            x = rng.randrange(field.P)
            assert ours.hash(x) == port.hash(x)


def test_chain_output_equals_fixture_and_port():
    from zk_stark_tpu_torch.field import Field
    from zk_stark_tpu_torch.models.rescue_chain import RescueChain

    cfg = chain_config()
    assert checks.chain_output(cfg, int(CHAIN_META["input"])) == int(CHAIN_META["output"])
    port = RescueChain(Field(), 3, 2, 128, device="cpu")
    assert rescue.Rescue().chain_output(987654321, 81) == port.run(987654321)


def test_signature_fixture_accepted_and_tampering_rejected():
    cfg = sign_config()
    sk, doc = int(META["sk"]), META["document"].encode()
    assert checks.check_signature(cfg, sk, doc, SIGNATURE) is None
    assert checks.check_signature(cfg, sk, b"attack at dusk", SIGNATURE) is not None
    assert checks.check_signature(cfg, sk + 1, doc, SIGNATURE) is not None
    for i in (20, len(SIGNATURE) // 3, len(SIGNATURE) // 2, len(SIGNATURE) - 3):
        bad = SIGNATURE[:i] + bytes([SIGNATURE[i] ^ 4]) + SIGNATURE[i + 1:]
        assert checks.check_signature(cfg, sk, doc, bad) is not None, i
    assert checks.check_signature(cfg, sk, doc, SIGNATURE[:-1]) is not None


def test_chain_fixture_accepted_and_tampering_rejected():
    cfg, x = chain_config(), int(CHAIN_META["input"])
    assert checks.check_chain_proofs(cfg, [x], [CHAIN_PROOF], None) == [None]
    bad = CHAIN_PROOF[:5000] + bytes([CHAIN_PROOF[5000] ^ 1]) + CHAIN_PROOF[5001:]
    assert checks.check_chain_proofs(cfg, [x + 1, x], [CHAIN_PROOF, bad], None)[0] is not None
    assert checks.check_chain_proofs(cfg, [x], [bad], None)[0] is not None


def test_challenges_match_the_port_transcript():
    from zk_stark_tpu_torch.field import Field
    from zk_stark_tpu_torch.proof_stream import SignatureProofStream, deserialize_items

    doc = META["document"].encode()
    ours = Transcript(SIGNATURE, doc)
    port = SignatureProofStream(Field(), doc)
    port.items = deserialize_items(SIGNATURE, Field())
    for k in range(0, len(ours.records), 97):
        ours.read, port.read_index = k, k
        assert ours.challenge() == port.fiat_shamir_verifier(32)


def test_columns_equal_lagrange():
    r = rescue.Rescue()
    omicron = field.primitive_root(128)
    table = stark.Columns(r, 54, omicron)
    x = 31337
    z, cols = table.at(x)
    points = [pow(omicron, i, field.P) for i in range(54)]
    expect_z = 1
    for a in points:
        expect_z = expect_z * (x - a) % field.P
    assert z == expect_z
    for col, (half, j) in zip(cols, [(0, 0), (0, 1), (1, 0), (1, 1)]):
        values = [r.constant_column(half, j, i) for i in range(54)]
        assert col == stark._interpolate_at(points, values, x)


def test_digests_against_the_port():
    from zk_stark_tpu_torch.field import Field
    from zk_stark_tpu_torch.models.rescue_prime import RescuePrime
    from zk_stark_tpu_torch.ops import limbs as L

    rp = RescuePrime(Field(), 2, 1, 128, 27)
    keys = L.ints_to_mont([3, 5, field.P - 1, 2 ** 127], "cpu")
    digests = rp.hash_batch_device(keys)
    answer = {"rows": [0, 1, 2, 3], "keys": keys.tolist(), "digests": digests.tolist()}
    cfg = {"security_level": 128, "rescue": RESCUE}
    assert checks.check_digests(cfg, answer) is None
    answer["digests"][2][0] ^= 1
    assert "1 of 4" in checks.check_digests(cfg, answer)


def test_transcript_rejects_malformed():
    with pytest.raises(Reject):
        Transcript(SIGNATURE[:10])
    with pytest.raises(Reject):
        Transcript(b"\x00" * 15 + b"\x01" + SIGNATURE[16:])


def test_yardstick():
    covered, gaps = yardstick.union_seconds([0, 5, 6, 20], [10, 7, 12, 25], 0, 30)
    assert covered == 17e-9 and gaps == [(12, 20), (25, 30)]
    r = rescue.Rescue()
    # x^3: one squaring, one product; x^(1/3): 128 steps, 65 ones -> 7 products
    assert yardstick.exponent_steps(3) == (1, 1)
    assert yardstick.exponent_steps(r.alpha_inv) == (121, 7)
    work = yardstick.rescue_hash_work(2, 27, r.alpha, r.alpha_inv)
    assert work == (27 * 2 * 122, 27 * (2 * 8 + 8), 216)
    assert (yardstick.MONT_MUL_MADS, yardstick.MONT_SQR_MADS) == (41, 29)
    bound = yardstick.rescue_hash_bound_s(1 << 20, 2, 27, r.alpha, r.alpha_inv)
    assert bound == pytest.approx((1 << 20) * (6588 * 29 + 648 * 41) / (132 * 64 * 1.98e9))
    assert yardstick.percentile([1, 2, 3, 4, 5], 50) == 3
    segs = yardstick.innermost_segments([("a", 0, 10), ("b", 2, 4), ("c", 6, 8)])
    assert segs == [(0, 2, "a"), (2, 4, "b"), (4, 6, "a"), (6, 8, "c"), (8, 10, "a")]
    idle = yardstick.idle_by_host_span([(3, 4), (8, 9), (9, 11)], [("a", 0, 10), ("b", 2, 4)])
    assert idle == [["outside any span", 2e-9], ["a", 1e-9], ["b", 1e-9]]


def _cheapest_chain(e: int, extra: int = 2) -> int:
    """The least multiply-adds of any addition chain for e of at most
    ceil(log2 e) + extra steps, a doubling at a squaring's cost, any other
    step at a product's (exhaustive search)."""
    best = [None]
    limit = (e - 1).bit_length() + extra

    def walk(chain, cost):
        if chain[-1] == e:
            best[0] = cost if best[0] is None else min(best[0], cost)
            return
        if len(chain) > limit or (best[0] is not None and cost >= best[0]):
            return
        for i, a in enumerate(chain):
            for b in chain[i:]:
                if chain[-1] < a + b <= e:
                    step = yardstick.MONT_SQR_MADS if a == b else yardstick.MONT_MUL_MADS
                    walk(chain + [a + b], cost + step)

    walk([1], 0)
    return best[0]


@pytest.mark.parametrize("e", [3, 5, 7, 11, 15, 23, 27, 31])
def test_exponent_floor_is_below_every_chain(e):
    squarings, products = yardstick.exponent_steps(e)
    floor = squarings * yardstick.MONT_SQR_MADS + products * yardstick.MONT_MUL_MADS
    assert floor <= _cheapest_chain(e)
