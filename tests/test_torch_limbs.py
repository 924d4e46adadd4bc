"""The port's limb arithmetic against the JAX package and the host Field.

Inputs are made from a numpy seed and handed to both packages; every
comparison is exact (integer field arithmetic).
"""

import math

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


#: batch_inv's cases: the module's 64 operands; sizes either side of the
#: JAX package's _BATCH_INV_MIN (8), a sign's (284, 512, 1024) and one past
#: a power of two, with zeros first, in the middle and last and 1 and p-1
#: after the first; all-zero inputs
BATCH_INV_SIZES = [1, 2, 7, 8, 9, 284, 512, 1024, 1025]
BATCH_INV_CASES = ([("operands", 64)] + [("zeros", n) for n in BATCH_INV_SIZES]
                   + [("all-zero", n) for n in (1, 8, 284, 1025)])
#: lengths the JAX package compiles batch_inv for: its two forms either side
#: of _BATCH_INV_MIN, and the operands'; other lengths go through in chunks
#: of 64 padded with ones (an inverse depends on its element alone)
JAX_BATCH_INV_LENGTHS = (7, 8, 64)


def _batch_inv_case(operands, case, n):
    if case == "operands":
        return operands[0]
    if case == "all-zero":
        return [0] * n
    vals = _rand_ints(np.random.default_rng(n), n)
    vals[1:3] = [1, P - 1][:max(0, min(2, n - 1))]
    for i in (0, n // 2, n - 1):
        vals[i] = 0
    return vals


def _jax_batch_inv(vals):
    if len(vals) in JAX_BATCH_INV_LENGTHS:
        return np.asarray(JL.batch_inv_jit(JL.ints_to_mont(vals)))
    step = JAX_BATCH_INV_LENGTHS[-1]
    chunks = []
    for lo in range(0, len(vals), step):
        chunk = vals[lo:lo + step]
        padded = JL.ints_to_mont(chunk + [1] * (step - len(chunk)))
        chunks.append(np.asarray(JL.batch_inv_jit(padded))[:len(chunk)])
    return np.concatenate(chunks)


@pytest.mark.parametrize("case, n", BATCH_INV_CASES, ids=[f"{c}-{n}" for c, n in BATCH_INV_CASES])
def test_batch_inv_matches_jax(operands, case, n):
    """The batch inversion kernel's plain version (and the dispatching name
    on the CPU) against the JAX package's batch_inv and Python's pow."""
    vals = _batch_inv_case(operands, case, n)
    got = L.batch_inv_plain(L.ints_to_mont(vals, "cpu"))
    assert torch.equal(L.batch_inv(L.ints_to_mont(vals, "cpu")), got)
    assert np.array_equal(got.numpy(), _jax_batch_inv(vals))
    assert [int(v) for v in L.mont_to_ints(got)] == [pow(v, -1, P) if v else 0 for v in vals]


def test_mont_inv_fermat_plain_matches_jax(operands):
    """The inversion kernel's plain version against the JAX package's
    mont_inv_fermat (and the host Field) on 0, 1, p-1, p-2 and random
    elements."""
    import jax

    a = operands[0][:12]
    got = L.mont_inv_fermat_plain(L.ints_to_mont(a, "cpu"))
    want = jax.jit(JL.mont_inv_fermat)(JL.ints_to_mont(a))
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert [int(v) for v in L.mont_to_ints(got)] == [F.inv(v) for v in a]
    assert torch.equal(L.mont_inv_fermat(L.ints_to_mont(a, "cpu")), got)


@pytest.mark.parametrize("n", [1, 7, 64])
def test_batch_inv_stays_on_its_device(operands, monkeypatch, n):
    """batch_inv inverts its root product with mont_inv_fermat on the
    tensors' device: with the conversions to host integers raising, it
    still runs and equals the host Field's inverses."""
    a, _ = operands
    x = L.ints_to_mont(a[:n], "cpu")

    def refuse(*args):
        raise AssertionError("batch_inv took a value to the host")

    monkeypatch.setattr(L, "mont_to_ints", refuse)
    monkeypatch.setattr(L, "limbs_to_ints", refuse)
    got = L.batch_inv(x)
    monkeypatch.undo()
    assert [int(v) for v in L.mont_to_ints(got)] == [F.inv(v) for v in a[:n]]


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


#: the dispatching names, their plain versions and kernel wrappers, and
#: how many operands they take
DISPATCH = [
    (L.mont_mul, L.mont_mul_plain, L.mont_mul_kernel, 2),
    (L.add_mod, L.add_mod_plain, L.add_mod_kernel, 2),
    (L.sub_mod, L.sub_mod_plain, L.sub_mod_kernel, 2),
    (L.redc, L.redc_plain, L.redc_kernel, 1),
    (L.mont_inv_fermat, L.mont_inv_fermat_plain, L.mont_inv_fermat_kernel, 1),
    (L.batch_inv, L.batch_inv_plain, L.batch_inv_kernel, 1),
]
DISPATCH_IDS = ["mont_mul", "add_mod", "sub_mod", "redc", "mont_inv_fermat", "batch_inv"]


@pytest.mark.parametrize("fn, plain, kernel, arity", DISPATCH, ids=DISPATCH_IDS)
def test_dispatch_on_cpu_is_plain(operands, fn, plain, kernel, arity):
    """On CPU tensors the dispatching names are the plain versions, also
    broadcast ([4, 1, 8] against [16, 8]) and on strided slices."""
    a, b = (_port(v) for v in operands)
    for args in [(a, b), (a[:4].unsqueeze(1), b[:16]), (a[0::2], b[1::2])]:
        assert torch.equal(fn(*args[:arity]), plain(*args[:arity]))


@pytest.mark.parametrize("fn, plain, kernel, arity", DISPATCH, ids=DISPATCH_IDS)
def test_kernel_wrappers_refuse_cpu_and_mixed_devices(operands, fn, plain, kernel, arity):
    """A kernel wrapper takes CUDA tensors only: it raises ValueError on a
    CPU tensor, and on operands of two devices (here the CPU and "meta",
    through the dispatching name too), before any launch."""
    a = _port(operands[0])
    launches = [k.launches for k in L.KERNELS]
    with pytest.raises(ValueError, match="CUDA"):
        kernel(*[a] * arity)
    if arity == 2:
        other = torch.empty_like(a, device="meta")
        for args in [(a, other), (other, a)]:
            with pytest.raises(ValueError):
                fn(*args)
    assert [k.launches for k in L.KERNELS] == launches


def test_limb_kernels_name_their_counterparts():
    assert [k.name for k in L.KERNELS] == [f"limbs_{op}" for op in DISPATCH_IDS]
    assert {k.library for k in L.KERNELS} == {"limbs", "batch_inv"}
    assert all(k.replaces.startswith("zk_stark_tpu/ops/limbs.py:") for k in L.KERNELS)


def test_kernel_plan_collapses_and_copies(operands):
    """kernel_plan merges what it can (a contiguous operand against a
    broadcast element is one dimension), keeps [r, 1] x [1, c] as two, and
    copies an operand whose limbs are not adjacent, one that starts off the
    16-byte grid, or all of them when more than KERNEL_DIMS dimensions
    remain."""
    a = _port(operands[0])
    plan = L.kernel_plan(a.reshape(8, 8, L.NLIMB), a[0])
    assert (plan.ndim, plan.sizes, plan.strides) == (1, [1, 1, 1, 64], [[0, 0, 0, 8], [0, 0, 0, 0]])
    assert plan.divisors == [0, 0, 0, 0]
    plan = L.kernel_plan(a[:4].unsqueeze(1), a[:16].unsqueeze(0))
    assert (plan.ndim, plan.sizes, plan.strides) == (2, [1, 1, 4, 16], [[0, 0, 8, 0], [0, 0, 0, 8]])
    assert plan.divisors == [0, 0, 0, L.divider(16)]
    copies = L.copies
    L.kernel_plan(a.t().contiguous().t(), a)
    assert L.copies == copies + 1
    # [2, 1, 2, 1, 2] against [1, 2, 1, 2, 1]: five dimensions, none mergeable
    plan = L.kernel_plan(a[:8].reshape(2, 1, 2, 1, 2, L.NLIMB),
                         a[:4].reshape(1, 2, 1, 2, 1, L.NLIMB))
    assert L.copies == copies + 3 and (plan.ndim, plan.sizes[-1], math.prod(plan.lead)) == (1, 32, 32)
    assert all(v.is_contiguous() for v in plan.views)
    # a view one limb into its buffer, and one whose element stride is odd
    buf = torch.zeros(64 * L.NLIMB + 1, dtype=L.DTYPE)
    shifted = buf[1:].view(64, L.NLIMB)
    shifted.copy_(a)
    wide = torch.zeros(64, L.NLIMB + 1, dtype=L.DTYPE)[:, :L.NLIMB]
    wide.copy_(a)
    for view in (shifted, wide):
        copies = L.copies
        plan = L.kernel_plan(view, a)
        assert L.copies == copies + 1
        assert plan.views[0].data_ptr() % 16 == 0 and plan.views[0].is_contiguous()
        assert torch.equal(plan.views[0], a) and plan.views[1] is a


def _kernel_offsets(plan, i: np.ndarray) -> list:
    """csrc/limbs.cu's ``offsets``: each operand's element offsets (in limbs)
    of output elements i, dividing by each dimension's size through the
    plan's reciprocals in 32-bit arithmetic."""
    offs = [np.zeros_like(i) for _ in plan.strides]
    for d in range(L.KERNEL_DIMS - 1, L.KERNEL_DIMS - plan.ndim, -1):
        magic, shift = plan.divisors[d] & 0xFFFFFFFF, plan.divisors[d] >> 32
        q = ((((i * magic) >> 32) + i) & 0xFFFFFFFF) >> shift
        r = i - q * plan.sizes[d]
        offs = [o + r * s[d] for o, s in zip(offs, plan.strides)]
        i = q
    outer = L.KERNEL_DIMS - plan.ndim
    return [o + i * s[outer] for o, s in zip(offs, plan.strides)]


@pytest.mark.parametrize("n", [384, 4097])
def test_kernel_plan_gives_the_index_plan(n):
    """On every layout of chip_smoke.py's limb phase, the elements that
    limbs.cu's index arithmetic reaches through kernel_plan's sizes, element
    strides and reciprocals are the broadcast operands' elements, output
    element for output element; and each reciprocal divides exactly."""
    import chip_smoke

    rng = np.random.default_rng(n)
    a, b = (torch.from_numpy(rng.integers(0, 1 << 16, (n, L.NLIMB))) for _ in range(2))
    rows = 24 if n == 384 else 64
    for layout in chip_smoke.LIMB_LAYOUTS:
        operands = chip_smoke.limb_operands(layout, a, b, rows)
        plan = L.kernel_plan(*operands)
        count = math.prod(plan.lead)
        offsets = _kernel_offsets(plan, np.arange(count, dtype=np.int64))
        for op, view, off in zip(operands, plan.views, offsets):
            want = op.expand(plan.lead + (L.NLIMB,)).reshape(count, L.NLIMB)
            flat = view.as_strided((int(off.max(initial=0)) + L.NLIMB,), (1,))
            got = flat[torch.from_numpy(off)[:, None] + torch.arange(L.NLIMB)]
            assert torch.equal(got, want), layout
        assert plan.divisors[:L.KERNEL_DIMS - plan.ndim + 1] == [0] * (L.KERNEL_DIMS - plan.ndim + 1)
        assert plan.divisors[L.KERNEL_DIMS - plan.ndim + 1:] == [
            L.divider(d) for d in plan.sizes[L.KERNEL_DIMS - plan.ndim + 1:]]
    ds = np.concatenate([np.arange(1, 600), rng.integers(1, 1 << 31, 400), [(1 << 31) - 1]])
    xs = np.concatenate([np.arange(0, 5000), rng.integers(0, 1 << 31, 5000),
                         [(1 << 31) - 1]]).astype(np.uint64)  # i * magic < 2^63
    for d in ds.tolist():
        magic, shift = L.divider(d) & 0xFFFFFFFF, L.divider(d) >> 32
        assert magic < 1 << 32
        q = (((xs * np.uint64(magic)) >> np.uint64(32)) + xs) >> np.uint64(shift)
        assert np.array_equal(q, xs // np.uint64(d)), d


def test_plain_versions_reach_no_dispatching_name(monkeypatch, operands):
    """The plain kernel versions that chip_smoke.py holds the kernels
    against on the card run their own tensor code: with the dispatching
    names raising, the plain fold, NTT (its power table built anew), leaf
    and node digests, Rescue permutation, chained product, inversion and
    batch inversion still run and equal what they gave before."""
    from zk_stark_tpu_torch.models.rescue_prime import RescuePrime
    from zk_stark_tpu_torch.ops import blake2b as B
    from zk_stark_tpu_torch.ops import fold as FO
    from zk_stark_tpu_torch.ops import montmul_chain as MC
    from zk_stark_tpu_torch.ops import ntt as N
    from zk_stark_tpu_torch.ops import rescue_ops as R

    n = 64
    cw = _port(operands[0])
    invpows = _port(operands[1][: n // 2])
    ao, two_inv = L.int_to_mont(123456789, "cpu"), L.int_to_mont(pow(2, -1, P), "cpu")
    root = F.primitive_nth_root(n).value
    rp = RescuePrime(F)
    mds, rc = rp._device_constants("cpu")
    state = cw[:6].reshape(3, 2, L.NLIMB)

    def run():
        canon = FO.fold_plain(cw, invpows, ao, two_inv)[1]
        leaves = B.leaf_digests_plain(canon)
        return [*FO.fold_plain(cw, invpows, ao, two_inv), N.ntt_plain(cw, root), leaves,
                B.node_digests_plain(leaves),
                R.permutation_plain(state, mds, rc, 2, rp.alpha, rp.alpha_inv),
                MC.mont_mul_chain_plain(cw, 3), L.mont_inv_fermat_plain(cw[:4]),
                L.batch_inv_plain(cw), L.batch_inv_plain(cw[:7])]

    want = run()

    def refuse(*args):
        raise AssertionError("a plain version reached a dispatching limb name")

    for name in ("mont_mul", "add_mod", "sub_mod", "redc", "mont_inv_fermat", "batch_inv"):
        monkeypatch.setattr(L, name, refuse)
    N._powers_dev.cache_clear()
    try:
        got = run()
    finally:
        N._powers_dev.cache_clear()
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_eq_row_to_int_and_canonical_np_match_jax():
    """limbs.eq, mont_to_canonical_np and row_to_int on 0, 1, p-1, p-2,
    against the JAX package's."""
    a, b = EDGES + EDGES, EDGES + EDGES[::-1]
    got = L.eq(L.ints_to_mont(a, "cpu"), L.ints_to_mont(b, "cpu"))
    want = np.asarray(JL.eq(JL.ints_to_mont(a), JL.ints_to_mont(b)))
    assert got.tolist() == want.tolist() == [x == y for x, y in zip(a, b)]
    canon = L.mont_to_canonical_np(L.ints_to_mont(EDGES, "cpu"))
    jcanon = JL.mont_to_canonical_np(JL.ints_to_mont(EDGES))
    assert canon.dtype == np.uint32 and np.array_equal(canon, jcanon)
    assert [L.row_to_int(r) for r in canon] == [JL.row_to_int(r) for r in jcanon] == EDGES
