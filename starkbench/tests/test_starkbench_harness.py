"""The harness finds every file of a cell by name, runs a cell end to end
on the CPU at test size, and sees ``correct`` fail under each fault a cell
can have and under each cell's control."""

from __future__ import annotations

import json
import re
import shutil

import pytest

from starkbench import harness
from starkbench.tests import tiny

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("workload", CELLS)
def test_cell_found_by_name(workload):
    cell = harness.Cell(BENCH, workload)
    assert cell.entry_path.exists()
    entry = cell.entry()
    for fn in ("setup", "answer", "check", "control"):
        assert callable(getattr(entry, fn))
    assert hasattr(entry, "request") or hasattr(entry, "window")
    names = [m["name"] for m in cell.end_to_end]
    assert "setup_s" in names and len(names) >= 2 and cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert callable(cell.reader(m["name"]).read)
        if m in cell.per_layer:
            assert m["moves"] in names


def test_benchmark_json_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({x["name"] for x in BENCH[k]}) == len(BENCH[k])
    for c in BENCH["configs"]:
        assert (harness.ROOT / c["file"]).exists() and c["reduced"] == []
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert 1 <= BENCH["run_seconds"] <= 51


def test_new_traffic_file_picked_up(tmp_path):
    """A later cell is a traffic file and a BENCHMARK.json entry: nothing
    else changes."""
    shutil.copytree(harness.HERE, tmp_path / "starkbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    traffic = json.loads((harness.HERE / "traffic" / "keygen_b2p20.json").read_text())
    (tmp_path / "starkbench" / "traffic" / "keygen_b2p16.json").write_text(
        json.dumps(dict(traffic, batch=1 << 16, why="bulk key generation, 2^16-key batches")))
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "rpsss_128.keygen_b2p16", "config": "rpsss_128",
                               "traffic": "keygen_b2p16", "chips": 1, "why": "smaller batches"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "rpsss_128.keygen_b2p20" in m.get("workloads", []):
            m["workloads"].append("rpsss_128.keygen_b2p16")
    cell = harness.Cell(bench, "rpsss_128.keygen_b2p16", base=tmp_path / "starkbench",
                        root=harness.ROOT)
    assert cell.traffic["batch"] == 1 << 16 and cell.entry_path.name == "hash_batch.py"
    assert {m["name"] for m in cell.end_to_end} == {"setup_s", "hash_rate"}
    assert {m["name"] for m in cell.per_layer} == {"rescue_roofline.keygen", "device_idle.keygen"}


def test_one_process_on_one_card():
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"][0] = dict(bench["workloads"][0], chips=4)
    with pytest.raises(ValueError, match="one client process on one card"):
        harness.Cell(bench, CELLS[0])


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    return tiny.checkout(tmp_path_factory.mktemp("checkout"))


@pytest.mark.parametrize("workload", CELLS + tiny.LATER_CELLS)
def test_rehearsal_prints_the_contract_line(checkout, workload):
    result = tiny.rehearse(checkout, workload)
    line = json.loads(json.dumps(result))
    assert list(line)[:5] == RESULT_KEYS and list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    bench = json.loads((checkout / "BENCHMARK.json").read_text())
    cell = harness.Cell(bench, workload, base=checkout / "starkbench", root=checkout)
    assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert line["device"]["memory_peak_bytes"] == 0  # no card: nothing measured
    assert all(v["value"] > 0 for v in line["metrics"].values())
    assert line["checks"] == {k: {"value": 0, "limit": 0} for k in ("rejected", "failed", "missing")}


@pytest.mark.parametrize("workload", CELLS + tiny.LATER_CELLS)
def test_traced_rehearsal_reads_per_layer_metrics(checkout, workload):
    """The stages and the latency tail of the closed loop are read; the
    card's own metrics need a card, and read nothing here."""
    result = tiny.rehearse(checkout, workload, trace=True)
    assert result["correct"] is True
    if workload in tiny.LATER_CELLS:
        assert set(result["metrics"]) == {"host_inputs_ms.sign", "sign_p95_ms"}
    else:
        assert result["metrics"] == {}
    assert result["device"]["window_s"] > 0 and "breakdown" in result


FAULTS = [
    ("rpsss_128.sign_c1", "altered_signature"),
    ("rpsss_128.keygen_b2p20", "altered_digests"),
    ("rpsss_128.keygen_b2p20", "half_batch"),
]


@pytest.mark.parametrize("workload,fault", FAULTS)
def test_fault_makes_run_incorrect(checkout, workload, fault):
    result = tiny.rehearse(checkout, workload, hook=f"starkbench.tests.faults:{fault}")
    assert result["correct"] is False
    assert result["checks"]["rejected"]["value"] >= 1


@pytest.mark.parametrize("workload", CELLS + tiny.LATER_CELLS)
def test_control_makes_run_incorrect(checkout, workload):
    result = tiny.rehearse(checkout, workload, hook="entry:control")
    assert result["correct"] is False
    assert result["checks"]["rejected"]["value"] >= 1
