"""Batched Rescue-Prime hashing and its kernels' plain versions, against
the JAX package and the host reference.

Every comparison is exact: field values as integers, digests as bytes.
Nothing here compiles an XLA program beyond the JAX package's eager
constant arrays: the JAX side is its host hash and round function.
"""

import hashlib

import numpy as np
import pytest
import torch

import chip_smoke
from zk_stark_tpu.field import Field as JField
from zk_stark_tpu.models.rescue_prime import RescuePrime as JRescuePrime
from zk_stark_tpu_torch import carry
from zk_stark_tpu_torch.field import FIELD_PRIME as P
from zk_stark_tpu_torch.field import Field
from zk_stark_tpu_torch.models.rescue_prime import RescuePrime
from zk_stark_tpu_torch.ops import blake2b as B
from zk_stark_tpu_torch.ops import limbs as L
from zk_stark_tpu_torch.ops import montmul_chain as MC
from zk_stark_tpu_torch.ops import rescue_ops as R

HASH_A = 57322816861100832358702415967512842988
HASH_1 = 244180265933090377212304188905974087294  # tests/test_rescue.py


@pytest.fixture(scope="module")
def rp():
    return RescuePrime(Field())


@pytest.fixture(scope="module")
def jrp():
    return JRescuePrime(JField())


def test_constants_match_jax(rp, jrp):
    assert rp.alpha == jrp.alpha == 3
    assert rp.alpha_inv == jrp.alpha_inv
    assert rp.MDS == jrp.MDS
    assert rp.round_constants == jrp.round_constants


def test_device_constants_match_jax(rp, jrp):
    mds_j, rc_j = jrp._device_constants()
    mds, rc = carry.rescue_constants_from_jax(np.asarray(mds_j), np.asarray(rc_j), "cpu")
    got_mds, got_rc = rp._device_constants("cpu")
    assert got_mds.shape == (2, 2, L.NLIMB) and got_rc.shape == (108, L.NLIMB)
    assert torch.equal(got_mds, mds) and torch.equal(got_rc, rc)
    assert rp._device_constants("cpu")[0] is got_mds  # cached per device
    with pytest.raises(ValueError):
        carry.rescue_constants_from_jax(np.asarray(mds_j)[0], np.asarray(rc_j), "cpu")


def test_hash_batch_matches_jax_host_hash(rp, jrp):
    inputs = [0, 1, HASH_A, 12345, P - 1]
    got = rp.hash_batch(inputs, device="cpu")
    assert got == [jrp.hash(x) for x in inputs]
    assert got[1] == HASH_1


def test_hash_batch_defaults_to_the_card(rp):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        rp.hash_batch([1])


@pytest.mark.parametrize("rounds", [2, 27])
def test_permutation_matches_jax_rounds(rp, jrp, rounds):
    """8 seeded random full states (m = 2) through the JAX package's host
    round function and through permutation_batch."""
    rng = np.random.default_rng(11)
    states = [[int(rng.integers(0, 1 << 62)) * int(rng.integers(0, 1 << 62)) % P
               for _ in range(2)] for _ in range(8)]
    mds, rc = rp._device_constants("cpu")
    x = L.ints_to_mont([v for s in states for v in s], "cpu").reshape(8, 2, L.NLIMB)
    out = L.mont_to_ints(R.permutation_batch(x, mds, rc, rounds, rp.alpha, rp.alpha_inv))
    for i, s in enumerate(states):
        for r in range(rounds):
            s = jrp._round(s, r)
        assert [int(v) for v in out[i]] == s


def test_permutation_refuses_short_constants(rp):
    mds, rc = rp._device_constants("cpu")
    x = torch.zeros((1, 2, L.NLIMB), dtype=L.DTYPE)
    with pytest.raises(ValueError):
        R.permutation_batch(x, mds, rc[:10], 27, rp.alpha, rp.alpha_inv)


def test_products_per_permutation(rp, monkeypatch):
    """chip_smoke.py's count of a permutation's products and additions (its
    bound) equals what the kernel's exponent chains compute, counted per
    state, and the kernel's rounds compute the plain permutation."""
    # 27 rounds x (2 x (2 for x^3 + 156 for x^alpha_inv) + 2 x 4 for MDS);
    # the plain version's fixed 4-bit window spends 169 on x^alpha_inv
    assert R.chain_products(R.exponent_chain(rp.alpha_inv)) == 156
    assert chip_smoke.permutation_counts(2, 27, rp.alpha, rp.alpha_inv) == (27 * 324, 27 * 8)
    assert R.products_per_permutation(2, 27, rp.alpha, rp.alpha_inv) == 27 * 324
    counts = {"mul": 0, "add": 0}

    def counted(fn, key):
        def wrapper(a, b):
            out = fn(a, b)
            counts[key] += out.numel() // L.NLIMB
            return out
        return wrapper

    mds, rc = rp._device_constants("cpu")
    state = L.ints_to_mont([HASH_A, 7], "cpu").reshape(1, 2, L.NLIMB)
    want = R.permutation_plain(state, mds, rc, 2, rp.alpha, rp.alpha_inv)
    # the plain versions count them: chain_pow and _mds_mul are tensor code
    monkeypatch.setattr(L, "mont_mul_plain", counted(L.mont_mul_plain, "mul"))
    monkeypatch.setattr(L, "add_mod_plain", counted(L.add_mod_plain, "add"))
    s = state
    for r in range(2):  # the kernel's round: chains for the S-boxes
        for e, c0 in ((rp.alpha, 2 * r * 2), (rp.alpha_inv, 2 * r * 2 + 2)):
            s = R.chain_pow(s, R.exponent_chain(e))
            s = L.add_mod(R._mds_mul(s, mds), rc[c0:c0 + 2])
    assert (counts["mul"], counts["add"]) == chip_smoke.permutation_counts(
        2, 2, rp.alpha, rp.alpha_inv)
    assert torch.equal(s, want)


@pytest.mark.parametrize(
    "e", [180331931428153586757283157844700080811, P - 2, 0b1011011, (1 << 9) + 3, 3, 2, 1, 0,
          1 << 127, (1 << 128) - 1],
    ids=["alpha_inv", "p-2", "7-bit", "10-bit", "3", "2", "1", "zero", "2^127", "2^128-1"],
)
def test_exponent_chain(e):
    """The kernel's exponent chain of e, run as tensor code, equals
    pow(x, e, p); it fits the kernel's slots and steps, and spends no more
    products than square-and-multiply."""
    vals = [0, 1, 2, 12345, P - 1, HASH_A]
    steps = R.exponent_chain(e)
    got = L.mont_to_ints(R.chain_pow(L.ints_to_mont(vals, "cpu"), steps))
    assert [int(v) for v in got] == [pow(v, e, P) for v in vals]
    assert 0 < len(steps) <= R.KERNEL_MAX_STEPS
    fields = [((s >> 8) & 0xF, (s >> 12) & 0xF, (s >> 16) & 0xF) for s in steps]
    assert all(f in (R.NONE, R.ONE) or f < R.KERNEL_SLOTS for slots in fields for f in slots)
    assert R.chain_products(steps) <= max(0, e.bit_length() - 1 + bin(e).count("1") - 1)


@pytest.mark.parametrize(
    "e", [180331931428153586757283157844700080811, P - 2, 0b1011011, 0],
    ids=["alpha_inv", "p-2", "7-bit", "zero"],
)
def test_mont_pow_windowed(e):
    vals = [0, 1, 2, 12345, P - 1, HASH_A]
    got = L.mont_to_ints(L.mont_pow_windowed(L.ints_to_mont(vals, "cpu"), e))
    assert [int(v) for v in got] == [pow(v, e, P) for v in vals]


def test_mont_mul_chain_is_a_power():
    vals = [1, 2, 7, P - 1, HASH_A]
    for k in (1, 32):
        got = L.mont_to_ints(MC.mont_mul_chain(L.ints_to_mont(vals, "cpu"), k))
        assert [int(v) for v in got] == [pow(v, k + 1, P) for v in vals]


def _messages(lengths, seed):
    rng = np.random.default_rng(seed)
    msgs = [rng.integers(0, 256, size=t, dtype=np.uint8).tobytes() for t in lengths]
    raw = np.zeros((len(msgs), 128), dtype=np.uint8)
    for i, m in enumerate(msgs):
        raw[i, : len(m)] = np.frombuffer(m, dtype=np.uint8)
    return msgs, torch.from_numpy(raw)


def test_compress_words_matches_hashlib():
    lengths = [0, 1, 40, 127, 128]
    msgs, raw = _messages(lengths, 3)
    mh, ml = B._bytes_to_words(raw)
    t = torch.tensor(lengths, dtype=L.DTYPE)
    hi, lo = B.compress_words(mh, ml, t)
    digests = B.words_to_digest_np(hi, lo)
    for i, m in enumerate(msgs):
        assert digests[i].tobytes() == hashlib.blake2b(m, digest_size=64).digest()
    assert digests[0].tobytes() == hashlib.blake2b(b"", digest_size=64).digest()


def test_node_digest_words_match_node_digests():
    leaves = B.leaf_digests(L.from_numpy(L.ints_to_limbs(range(16)), "cpu"))
    want = B.node_digests(leaves)
    hi, lo = B.leaf_digest_words(L.from_numpy(L.ints_to_limbs(range(16)), "cpu"))
    assert np.array_equal(B.words_to_digest_np(hi, lo), leaves.numpy())
    packed = B.node_digests_packed(torch.stack([hi, lo]))
    assert packed.shape == (2, 8, 8)
    assert np.array_equal(B.words_to_digest_np(packed[0], packed[1]), want.numpy())
    phi, plo = B.node_digest_words(hi, lo)
    assert torch.equal(phi, packed[0]) and torch.equal(plo, packed[1])


def test_kernel_wrappers_refuse_cpu_tensors(rp):
    """The kernel entry points launch on a CUDA tensor or raise; only the
    dispatchers take the plain version, and only for a CPU tensor."""
    mds, rc = rp._device_constants("cpu")
    state = torch.zeros((4, 2, L.NLIMB), dtype=L.DTYPE)
    with pytest.raises(ValueError, match="CUDA"):
        R.permutation_kernel(state, mds, rc, 27, rp.alpha, rp.alpha_inv)
    # wider than any instantiation: refused before the device is looked at
    with pytest.raises(NotImplementedError):
        R.permutation_kernel(torch.zeros((4, R.KERNEL_MAX_M + 1, L.NLIMB), dtype=L.DTYPE), mds,
                             rc, 27, rp.alpha, rp.alpha_inv)
    words = torch.zeros((16, 4), dtype=L.DTYPE)
    with pytest.raises(ValueError, match="CUDA"):
        B.compress_kernel(words, words, torch.zeros(4, dtype=L.DTYPE))
    with pytest.raises(ValueError, match="CUDA"):
        MC.mont_mul_chain_kernel(torch.zeros((4, L.NLIMB), dtype=L.DTYPE))


@pytest.mark.parametrize("m", [3, 4])
def test_wider_states_match_jax(m):
    """RescuePrime at state widths 3 and 4 (capacity 1): the constants
    against the JAX package's (its device arrays carried over), the plain
    batched hash of 8 seeded inputs against its host hash, and a launch
    plan whose blocks hold whole states."""
    rp, jrp = RescuePrime(Field(), m=m), JRescuePrime(JField(), m=m)
    assert rp.MDS == jrp.MDS and rp.round_constants == jrp.round_constants
    mds_j, rc_j = jrp._device_constants()
    mds, rc = carry.rescue_constants_from_jax(np.asarray(mds_j), np.asarray(rc_j), "cpu")
    got_mds, got_rc = rp._device_constants("cpu")
    assert got_mds.shape == (m, m, L.NLIMB) and got_rc.shape == (2 * 27 * m, L.NLIMB)
    assert torch.equal(got_mds, mds) and torch.equal(got_rc, rc)
    rng = np.random.default_rng(20 + m)
    inputs = [0, P - 1] + [int(rng.integers(0, 1 << 62)) * int(rng.integers(0, 1 << 62)) % P
                           for _ in range(6)]
    assert rp.hash_batch(inputs, device="cpu") == [jrp.hash(x) for x in inputs]
    for n in (1, 42, 43, 1 << 20):
        plan = R.launch_plan(n, m)
        assert plan["threads"] % m == 0 and 128 - m < plan["threads"] <= 128
        assert (plan["blocks"] - 1) * plan["threads"] < n * m <= plan["blocks"] * plan["threads"]
    assert R.launch_plan(1 << 20) == {"blocks": (1 << 21) // 128, "threads": 128}
