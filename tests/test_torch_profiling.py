"""The port's stage timer and device trace (utils/profiling.py) on the CPU:
the fixture signature signed and verified under a StageTimer reports the
JAX package's stage names and keeps its bytes; device_trace writes a
Chrome trace."""

import json
import pathlib

import pytest
import torch

from zk_stark_tpu_torch.carry import DetRng, rpsss_from_config
from zk_stark_tpu_torch.utils.profiling import StageTimer, device_trace, stage

FIXTURES = pathlib.Path(__file__).parent / "fixtures"
PROVE_STAGES = {"host_inputs", "segment1", "commit_roots", "segment2", "fri_prove", "openings",
                "serialize"}
VERIFY_STAGES = {"v_fri", "v_fri_last_root", "v_fri_lowdeg", "v_fri_colinearity",
                 "v_fri_paths", "v_openings", "v_comb_host", "v_comb_seg"}


@pytest.fixture(scope="module")
def signer():
    meta = json.loads((FIXTURES / "meta.json").read_text())
    rpsss = rpsss_from_config(meta["config"], device="cpu", rng=DetRng())
    return rpsss, meta


def test_stage_timer_reports_the_jax_stages(signer):
    rpsss, meta = signer
    sk, pk = rpsss.keygen()
    doc = meta["document"].encode()
    timer = StageTimer("cpu")
    rpsss.stark.timer = timer
    try:
        sig = rpsss.sign(sk, doc)
        assert set(timer.totals) == PROVE_STAGES
        assert rpsss.verify(pk, doc, sig)
    finally:
        rpsss.stark.timer = None
    assert sig == (FIXTURES / "signature.bin").read_bytes()
    assert set(timer.totals) == PROVE_STAGES | VERIFY_STAGES
    assert rpsss.stark.fri.timer is None
    rounds = rpsss.stark.fri.num_rounds()
    assert timer.counts["segment1"] == 1 and timer.counts["v_fri_paths"] == rounds - 1
    lines = timer.report().splitlines()
    assert len(lines) == len(timer.totals)
    totals = [float(line.split()[1]) for line in lines]
    assert totals == sorted(totals, reverse=True)
    assert all(line.endswith(f"x{timer.counts[line.split()[0]]}") for line in lines)


def test_stage_without_a_timer_times_nothing():
    with stage(None, "anything"):
        pass
    timer = StageTimer()
    with pytest.raises(ValueError), timer.stage("raises"):
        raise ValueError
    assert timer.counts["raises"] == 1


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with device_trace(str(tmp_path)):
        torch.ones(16).sum()
    (trace,) = tmp_path.glob("trace_*.json")
    assert "traceEvents" in json.loads(trace.read_text())
