"""The NTT stage-variant probe's plain version against the JAX package's
transform, and the probe's control flow on the CPU.

The four kernels run only on the card, where the probe
(``zk_stark_tpu_torch.tools.ntt_variant_probe``, driven by chip_smoke.py)
holds them against the same plain version and ``ntt_kernel``; their
arithmetic is checked here by tests/test_torch_kernels_host.py.
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
from zk_stark_tpu_torch.ops import ntt_variants as V
from zk_stark_tpu_torch.tools import ntt_variant_probe as probe

F = Field()


def _rand(seed, count):
    rng = np.random.default_rng(seed)
    hi = rng.integers(0, 1 << 63, size=count, dtype=np.uint64)
    lo = rng.integers(0, 1 << 63, size=count, dtype=np.uint64)
    return [(int(h) << 63 | int(l)) % P for h, l in zip(hi, lo)]


@pytest.mark.parametrize("n", [16, 64])
def test_plain_stages_match_jax(n):
    """The plain version on [n, 4, 8] natural rows equals, column by column,
    the JAX package's ntt_mont of each column (the JAX probe's result on its
    un-permuted rows); bit-identical limbs.  Every variant is that plain
    version on the CPU."""
    c = 4
    vals = _rand(n, n * c)
    root = F.primitive_nth_root(n).value
    x = L.ints_to_mont(vals, "cpu").reshape(n, c, L.NLIMB)
    got = V.ntt_columns_plain(x, root).numpy().astype(np.uint32)
    jx = np.asarray(JL.ints_to_mont(vals)).reshape(n, c, L.NLIMB)
    for b in range(c):
        assert np.array_equal(got[:, b], np.asarray(JN.ntt_mont(jx[:, b], root)))
    for which in V.VARIANTS:
        assert torch.equal(V.variant_ntt(which, x, root), V.ntt_columns_plain(x, root))


def test_stage_major_table():
    """Kernel b's table holds stage s's twiddles root^(j * n / 2^(s+1))
    from offset 2^s - 1, as 32-bit words."""
    n = 32
    root = F.primitive_nth_root(n).value
    words = V.stage_major_table(root, n, "cpu")
    want = [pow(root, j * n >> (s + 1), P) for s in range(5) for j in range(1 << s)]
    assert words.shape == (n - 1, 4)
    assert [int(v) for v in L.mont_to_ints(N._limbs(words))] == want


def test_wrappers_refuse_what_the_kernels_do_not_take():
    x = L.ints_to_mont(range(16 * 2), "cpu").reshape(16, 2, L.NLIMB)
    root = F.primitive_nth_root(16).value
    for which in V.VARIANTS:
        with pytest.raises(ValueError, match="CUDA tensor"):
            V.variant_kernel(which, x, root)
    with pytest.raises(ValueError, match="unknown variant"):
        V.variant_ntt("e", x, root)
    with pytest.raises(ValueError, match="power of two"):
        V.variant_ntt("d", x[:4], root)


def test_probe_on_the_cpu():
    """The probe's checks on the CPU, d included (every variant is the
    plain version there, nothing is timed); on the card it runs by default
    and raises without one."""
    result = probe.run(n=16, c=4, device="cpu")
    assert result == {w: {"max_abs_err": 0} for w in ("a", "b", "c", "d")}
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        probe.run()


def test_kernel_shape_probe_on_the_cpu():
    """The shape probe needs a card (it raises on the CPU), and the
    statements its split removes from csrc/ntt.cu are still there."""
    from zk_stark_tpu_torch.ops import _build
    from zk_stark_tpu_torch.tools import kernel_shape_probe as ksp

    src = (_build.CSRC / "ntt.cu").read_text()
    assert all(piece in src for piece in (ksp._STAGES, ksp._LOAD, ksp._STORE))
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        ksp.run(device="cpu")
