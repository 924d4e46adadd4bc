"""The port's NTT against the JAX package's (the XLA ntt_mont, which the JAX
tests pin bit-exact to the Pallas kernel) and the reference golden vectors.

On the CPU the port runs its plain version; the CUDA kernel is held against
the same plain version on the card by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from zk_stark_tpu.ops import limbs as JL
from zk_stark_tpu.ops import ntt as JN
from zk_stark_tpu_torch.field import FIELD_PRIME as P
from zk_stark_tpu_torch.field import Field
from zk_stark_tpu_torch.ops import limbs as L
from zk_stark_tpu_torch.ops import ntt as N

F = Field()

# golden vectors of the reference NTT (the same as tests/test_ntt.py)
INPUT_16 = [
    10350860596407318609598574026175964133, 60692809610834653822383343680910625982,
    223446197944610152228521360138425742723, 123599176902523769876954930401435714041,
    233214499950980668770362073427851594143, 197530481770421435151547222505733630031,
    6028204552208455457232478170590637777, 129106051215868132791440857107220454376,
    46875137253396986423834480299002499296, 40573479539486208028801437611599580111,
    177627388180112816822358878396956962568, 63754231379381382860231899477157171256,
    213977912421556511151382836938765186268, 247295448209556494808801789962732329479,
    198078312580458497833840274756537503682, 140348661180454074099943144751461445367,
]
VALUES_16 = [
    219013573292644897785762424283206192714, 28020178707455534238013018981848447223,
    125720672179066355667363683873634014638, 9544075888957995047526079628773702483,
    236214009288214032104373542256167121711, 203576991437594049347129945434757211067,
    161303837601531457486430204397030363075, 8066037348193233635957451882263404827,
    106698173671205255857026330656055139947, 205516443913240407551582667880265743260,
    132452175458644240344865798387130681692, 14403130148933356826258737037147692544,
    103258398926149853393925877736501914903, 241567637358481607032146874821122458208,
    184640833807669488035490783312852642403, 79102880510147994351196921219409543952,
]

INTT_VALUES_16 = [159, 179, 197, 143, 198, 82, 100, 153, 45, 158, 154, 238, 46, 121, 148, 200]
INTT_COEFFS_16 = [
    2321, 46679697743149797158402415879589215379,
    85767599764045409871854383990500128680, 170048455543476672374689900824216177289,
    56517926799859326797837626323965682333, 150718635918560071455504820257610329093,
    149093701728889244918633279335367822666, 266977550113122771518657412035427200127,
    270497897142230380135924736767050120990, 63434915687244166391766073758524869310,
    261359683971832165794823307314869483630, 172866549451408128829178953127270691728,
    213979970342371053338087110443084438582, 83513730222590766426030683639871516493,
    44774808819693939686538502893362807298, 127752053889369146389468687545690486361,
]


def _rand(rng, n):
    hi = rng.integers(0, 1 << 63, size=n, dtype=np.uint64)
    lo = rng.integers(0, 1 << 63, size=n, dtype=np.uint64)
    return [(int(h) << 63 | int(l)) % P for h, l in zip(hi, lo)]


def _ints(t):
    return [int(v) for v in L.mont_to_ints(t)]


def test_golden_16():
    root = F.primitive_nth_root(16).value
    assert _ints(N.ntt_mont(L.ints_to_mont(INPUT_16, "cpu"), root)) == VALUES_16
    got = N.ntt_mont(L.ints_to_mont(INTT_VALUES_16, "cpu"), root)
    assert _ints(got) == INTT_COEFFS_16
    assert _ints(N.intt_mont(got, root)) == INTT_VALUES_16


@pytest.mark.parametrize("n", [16, 64, 512])
def test_ntt_intt_match_jax(n):
    vals = _rand(np.random.default_rng(n), n)
    root = F.primitive_nth_root(n).value
    x = L.ints_to_mont(vals, "cpu")
    got = N.ntt_mont(x, root)
    want = np.asarray(JN.ntt_mont(JL.ints_to_mont(vals), root))
    assert np.array_equal(got.numpy().astype(np.uint32), want)
    back = N.intt_mont(got, root)
    assert np.array_equal(
        back.numpy().astype(np.uint32), np.asarray(JN.intt_mont(want, root))
    )
    assert _ints(back) == vals


@pytest.mark.parametrize("m", [3, 10, 33])
def test_odd_length_equals_zero_padded(m):
    vals = _rand(np.random.default_rng(m), m)
    n = 1 << (m - 1).bit_length()
    root = F.primitive_nth_root(n).value
    got = N.ntt_mont(L.ints_to_mont(vals, "cpu"), root)
    assert torch.equal(got, N.ntt_mont(L.ints_to_mont(vals + [0] * (n - m), "cpu"), root))
    assert _ints(got) == [
        sum(c * pow(root, i * j, P) for j, c in enumerate(vals)) % P for i in range(n)
    ]


@pytest.mark.parametrize("m", [0, 1])
def test_short_inputs(m):
    """Shorter than 2: ntt pads to one element and returns it, intt returns
    its input unchanged, as in the JAX package."""
    vals = [12345][:m]
    x = L.ints_to_mont(vals, "cpu")
    want = np.asarray(JN.ntt_mont(JL.ints_to_mont(vals).reshape(m, 8), 1))
    assert np.array_equal(N.ntt_mont(x, 1).numpy().astype(np.uint32), want)
    assert torch.equal(N.intt_mont(x, 1), x)


def test_batched_transform_is_per_column():
    rng = np.random.default_rng(5)
    n, b = 16, 3
    vals = _rand(rng, n * b)
    root = F.primitive_nth_root(n).value
    x = L.ints_to_mont(vals, "cpu").reshape(n, b, L.NLIMB)
    got = N.ntt_mont(x, root)
    for j in range(b):
        assert torch.equal(got[:, j], N.ntt_mont(x[:, j].contiguous(), root))


def test_powers_and_scalar_mul():
    base = 12345678901234567890
    assert _ints(N.powers_mont(base, 37, "cpu")) == [pow(base, i, P) for i in range(37)]
    assert _ints(N.powers_mont(base, 37, "cpu", scale_int=7)) == [
        7 * pow(base, i, P) % P for i in range(37)
    ]
    x = L.ints_to_mont([1, 2, P - 1], "cpu")
    assert _ints(N.scalar_mul_mont(x, 5)) == [5, 10, P - 5]


def test_kernel_twiddle_table_is_the_plain_power_table():
    """The kernel's [n/2, 4] 32-bit words repack the plain version's limbs."""
    n = 64
    root = F.primitive_nth_root(n).value
    words = N._twiddles_u32(root, n, "cpu").numpy().view(np.uint32)
    limbs = N.powers_mont(root, n // 2, "cpu").numpy()
    assert np.array_equal(words, (limbs[:, 0::2] | (limbs[:, 1::2] << 16)).astype(np.uint32))


def test_kernel_wrapper_refuses_cpu_tensors_and_large_transforms():
    """A CPU tensor is refused; so is a transform beyond the three-pass
    split's 2^36 points, and a batch beyond the grid's y/z limit above a
    single block (meta tensors: no memory behind them)."""
    x = L.ints_to_mont([1, 2, 3, 4], "cpu")
    with pytest.raises(ValueError, match="CUDA tensor"):
        N.ntt_kernel(x, F.primitive_nth_root(4).value)
    n = 2 * N.MAX_KERNEL_N ** 3
    big = torch.empty((n, L.NLIMB), dtype=L.DTYPE, device="meta")
    with pytest.raises(NotImplementedError, match="recursive split"):
        N.ntt_kernel(big, F.primitive_nth_root(n).value)
    for n in (2 * N.MAX_KERNEL_N, 2 * N.MAX_KERNEL_N ** 2):
        wide = torch.empty((n, N.MAX_GRID_YZ + 1, L.NLIMB), dtype=L.DTYPE, device="meta")
        with pytest.raises(ValueError, match="grid"):
            N.ntt_kernel(wide, F.primitive_nth_root(n).value)


@pytest.mark.parametrize("n", [1 << 13, 1 << 14])
def test_four_step_matches_jax(n):
    """Above 2^12 points the CPU path is the four-step glue with plain
    passes; it equals the JAX package's transform (its flat form at these
    sizes) and the port's flat plain transform, forward and inverse."""
    vals = _rand(np.random.default_rng(n), n)
    root = F.primitive_nth_root(n).value
    x = L.ints_to_mont(vals, "cpu")
    got = N.ntt_mont(x, root)
    want = np.asarray(JN.ntt_mont(JL.ints_to_mont(vals), root))
    assert np.array_equal(got.numpy().astype(np.uint32), want)
    assert torch.equal(got, N.ntt_plain(x, root))
    back = N.intt_mont(got, root)
    assert np.array_equal(
        back.numpy().astype(np.uint32), np.asarray(JN.intt_mont(want, root))
    )
    assert _ints(back) == vals


def test_four_step_uneven_split_batched(monkeypatch):
    """With the single-block limit lowered to 2^5, 2^9 points split
    unevenly as 2^5 x 2^4; batched columns transform independently."""
    monkeypatch.setattr(N, "MAX_KERNEL_N", 1 << 5)
    n = 1 << 9
    assert N.four_step_split(n) == (32, 16)
    root = F.primitive_nth_root(n).value
    x = L.ints_to_mont(_rand(np.random.default_rng(9), 3 * n), "cpu").reshape(n, 3, L.NLIMB)
    got = N.ntt_mont(x, root)
    assert torch.equal(got, N.ntt_plain(x, root))
    assert torch.equal(N.intt_mont(got, root), x)
    # beyond the square the recursive split takes over: 2^11 = 32 x (8 x 8)
    assert [p.m for p in N.kernel_passes(1 << 11, 3, root)] == [32, 8, 8]
    with pytest.raises(ValueError, match="four_step_split"):
        N.four_step_split(1 << 11)
    with pytest.raises(NotImplementedError, match="recursive split"):
        N.kernel_passes(1 << 16, 1, root)


@pytest.mark.parametrize("n, batch", [(1 << 9, 3), (1 << 10, 1), (1 << 11, 2), (1 << 12, 1)])
def test_three_pass_matches_jax(monkeypatch, n, batch):
    """With the single-block limit lowered to 2^4, 2^9 to 2^12 points lie
    beyond the four-step's 2^8 and take the three-pass plan (the
    counterpart of the JAX package's _planes_long_ntt, whose own n >= 2^21
    the CPU suite cannot afford): forward and inverse, batched, bit-identical
    to the JAX package's ntt_mont / intt_mont, which the JAX tests pin
    bit-exact to ntt_mont_pallas."""
    monkeypatch.setattr(N, "MAX_KERNEL_N", 1 << 4)
    root = F.primitive_nth_root(n).value
    passes = N.kernel_passes(n, batch, root)
    assert [p.kernel for p in passes] == [N.NTT_TW_KERNEL, N.NTT_LONG_TW_KERNEL, N.NTT_LONG_KERNEL]
    assert passes[0].m == 16 and passes[1].m * passes[2].m == n // 16
    vals = _rand(np.random.default_rng(n + batch), n * batch)
    x = L.ints_to_mont(vals, "cpu").reshape(n, batch, L.NLIMB)
    got = N.ntt_mont(x, root)
    want = np.asarray(JN.ntt_mont(JL.ints_to_mont(vals).reshape(n, batch, L.NLIMB), root))
    assert np.array_equal(got.numpy().astype(np.uint32), want)
    back = N.intt_mont(got, root)
    assert np.array_equal(back.numpy().astype(np.uint32), np.asarray(JN.intt_mont(want, root)))
    assert torch.equal(back, x)


def test_three_pass_in_blocks(monkeypatch):
    """The plain passes and the table builds with their products in blocks
    smaller than one pass (as at 2^25 points on the card) give the same
    transform."""
    monkeypatch.setattr(N, "MAX_KERNEL_N", 1 << 3)
    monkeypatch.setattr(L, "MUL_BLOCK", 48)
    n = 1 << 9
    root = F.primitive_nth_root(n).value
    x = L.ints_to_mont(_rand(np.random.default_rng(3), 2 * n), "cpu").reshape(n, 2, L.NLIMB)
    want = N.ntt_plain(x, root)
    N._four_step_twiddles_u32.cache_clear()
    try:
        assert torch.equal(N.ntt_mont(x, root), want)
    finally:
        N._four_step_twiddles_u32.cache_clear()
    base = 12345678901234567890
    assert _ints(N.pow_by_exponents(L.one_mont("cpu"), base, torch.arange(100), 7)) == [
        pow(base, e, P) for e in range(100)
    ]
    assert torch.equal(N.intt_mont(N.ntt_mont(x, root), root), x)


def test_four_step_twiddles_and_power_tables():
    """The device-built tables (binary-weighted products) equal host
    powers: root^(i2 * k1) in the fused mode's [c, r] layout and words."""
    r, c = 8, 4
    root = F.primitive_nth_root(r * c).value
    table = N._four_step_twiddles(root, r, c, "cpu")
    assert [[int(v) for v in row] for row in L.mont_to_ints(table)] == [
        [pow(root, i2 * k1, P) for k1 in range(r)] for i2 in range(c)
    ]
    words = N._four_step_twiddles_u32(root, r, c, "cpu")
    limbs = table.numpy()
    assert np.array_equal(words.numpy().view(np.uint32),
                          (limbs[..., 0::2] | (limbs[..., 1::2] << 16)).astype(np.uint32))
    assert torch.equal(N._limbs(words), table)
    exps = torch.tensor([0, 1, 5, 1000, 65535])
    got = N.pow_by_exponents(L.one_mont("cpu").expand(5, L.NLIMB), 7, exps, 16)
    assert _ints(got) == [pow(7, int(e), P) for e in exps]
