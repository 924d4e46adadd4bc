"""The port stands alone: it imports neither JAX nor the JAX package, runs
on the card unless asked for the CPU, and carries state across from the
JAX package's numpy arrays."""

import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from zk_stark_tpu.ops import limbs as JL
from zk_stark_tpu_torch import carry
from zk_stark_tpu_torch.field import FIELD_PRIME as P
from zk_stark_tpu_torch.field import Field
from zk_stark_tpu_torch.models.rpsss import RPSSS
from zk_stark_tpu_torch.ops import limbs as L

ROOT = pathlib.Path(__file__).resolve().parent.parent

_PROBE = """
import hashlib, json, sys
sys.path.insert(0, {root!r})
from zk_stark_tpu_torch.carry import DetRng, rpsss_from_config
import zk_stark_tpu_torch.ops.ntt_variants, zk_stark_tpu_torch.tools.ntt_variant_probe
import zk_stark_tpu_torch.tools.kernel_shape_probe, zk_stark_tpu_torch.tools.kernel_times
import zk_stark_tpu_torch.ops.limbs  # the limb kernels' wrappers (csrc/limbs.cu)
import zk_stark_tpu_torch.parallel.collectives, zk_stark_tpu_torch.parallel.dryrun
import zk_stark_tpu_torch.parallel.engine, zk_stark_tpu_torch.parallel.mesh
import zk_stark_tpu_torch.parallel.multihost, zk_stark_tpu_torch.parallel.ntt_dist
import zk_stark_tpu_torch.ops.multipoint, zk_stark_tpu_torch.ops.fft
import zk_stark_tpu_torch.utils.profiling
meta = json.load(open({meta!r}))
rpsss = rpsss_from_config(meta["config"], device="cpu", rng=DetRng())
sk, pk = rpsss.keygen()
sig = rpsss.sign(sk, meta["document"].encode())
print(json.dumps({{
    "sha256": hashlib.sha256(sig).hexdigest(),
    "modules": sorted(sys.modules),
}}))
"""


def test_port_imports_no_jax_and_signs_alone():
    meta_path = ROOT / "tests" / "fixtures" / "meta.json"
    code = _PROBE.format(root=str(ROOT), meta=str(meta_path))
    out = subprocess.run(
        [sys.executable, "-c", code], check=True, capture_output=True, text=True,
        timeout=300, cwd=ROOT,
    )
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["sha256"] == json.loads(meta_path.read_text())["signature_sha256"]
    leaked = [
        m for m in result["modules"]
        if m.split(".")[0] in ("jax", "jaxlib", "zk_stark_tpu")
    ]
    assert leaked == []


def test_port_sources_import_nothing_of_jax():
    sources = list((ROOT / "zk_stark_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    for src in sources:
        for line in src.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]):
                top = words[1].split(".")[0]
                assert top not in ("jax", "jaxlib", "zk_stark_tpu"), f"{src}: {line}"


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        RPSSS(Field())


def test_carry_round_trip():
    rng = np.random.default_rng(9)
    vals = [int(v) % P for v in rng.integers(0, 1 << 62, size=12)] + [P - 1]
    jax_limbs = JL.ints_to_limbs(vals)  # uint32[n, 8], the JAX layout
    t = carry.limbs_from_numpy(jax_limbs, "cpu")
    assert t.dtype == torch.int64 and torch.equal(t, L.from_numpy(L.ints_to_limbs(vals), "cpu"))
    back = carry.limbs_to_numpy(t)
    assert back.dtype == np.uint32 and np.array_equal(back, jax_limbs)
    with pytest.raises(ValueError):
        carry.limbs_from_numpy(np.full((2, 8), 1 << 16, dtype=np.uint32), "cpu")

    config = {
        "expansion_factor": 4,
        "num_collinearity_checks": 2,
        "security_level": 2,
        "transition_constraints_degree": 2,
    }
    rpsss = carry.rpsss_from_config(config, device="cpu", rng=carry.DetRng())
    assert rpsss.device == torch.device("cpu")
    assert rpsss.stark.fri.domain_length == 512
    assert rpsss.stark.omicron_domain_length == 128
