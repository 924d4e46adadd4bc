"""On the card, at each cell's own size: a short run comes out correct, and
the cell's control (the program with a lower guarantee than the
configuration states) comes out not correct on three seeds.  Each run's
result line is appended to ``chiprun_out/starkbench_card.jsonl``.

    python3 -m pytest starkbench/tests -m card
"""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from starkbench import harness

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
SEEDS = (2_718_281_828, 3_141_592_653, 1_618_033_988)
SECONDS = 4


def _run(script: str, workload: str, seed: int) -> dict:
    proc = subprocess.run(
        [sys.executable, f"starkbench/{script}.py", "--workload", workload, "--seed", str(seed),
         "--seconds", str(SECONDS), "--trace", "0"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    out = harness.ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    with open(out / "starkbench_card.jsonl", "a") as f:
        f.write(json.dumps({"script": script, "workload": workload, "seed": seed,
                            "result": result}) + "\n")
    return result


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_cell_correct_on_card(card, workload):
    result = _run("run", workload, SEEDS[0])
    assert result["correct"] is True and result["device"]["platform"] == "gpu"


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("seed", SEEDS)
def test_control_not_correct_on_card(card, workload, seed):
    result = _run("control", workload, seed)
    assert result["correct"] is False
    assert result["checks"]["rejected"]["value"] >= 1
