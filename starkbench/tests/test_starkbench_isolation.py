"""Names are compared by their top-level part, whole; a run that loads
JAX in any of its processes prints no result; the reference imports
nothing of the measured package."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from starkbench import harness

from starkbench import isolation
from starkbench.harness import IsolationError
from starkbench.tests import tiny


def test_top_level_names_compared_whole():
    loaded = ["zk_stark_tpu_torch", "zk_stark_tpu_torch.ops", "jaxtyping", "torch",
              "jax.numpy", "jaxlib", "zk_stark_tpu.field", "flax"]
    assert isolation.forbidden_loaded(loaded) == ["flax", "jax.numpy", "jaxlib",
                                                  "zk_stark_tpu.field"]


def test_reference_imports_nothing_of_the_program():
    assert isolation.reference_violations() == {}


def test_planted_import_in_reference_is_found(tmp_path):
    (tmp_path / "ok.py").write_text("from .field import P\nimport hashlib\n")
    (tmp_path / "bad.py").write_text("import jax.numpy as jnp\nfrom zk_stark_tpu_torch import stark\n")
    assert isolation.reference_violations(tmp_path) == {"bad.py": ["jax", "zk_stark_tpu_torch"]}


def test_run_that_imports_jax_fails(tmp_path):
    root = tiny.checkout(tmp_path)
    with pytest.raises(IsolationError) as info:
        tiny.rehearse(root, "rpsss_128.keygen_b2p20", hook="starkbench.tests.faults:imports_jax")
    assert "jax" in info.value.names



#: runs a cell of a checkout on the CPU as ``run.py`` would on the card,
#: through ``run.emit``: argv is the repository, the checkout, the cell
EMIT = """
import json, pathlib, sys, time
sys.path.insert(0, sys.argv[1])
from starkbench import harness, run
root = pathlib.Path(sys.argv[2])
bench = json.loads((root / "BENCHMARK.json").read_text())
cell = harness.Cell(bench, sys.argv[3], base=root / "starkbench", root=root)
sys.exit(run.emit(cell, 3_000_000_001, 1, False, time.monotonic_ns(), device="cpu"))
"""


def _emit(root, workload: str) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", EMIT, str(harness.ROOT), str(root), workload],
                          capture_output=True, text=True, timeout=600)


def _printed_result(proc) -> bool:
    for line in proc.stdout.splitlines():
        try:
            if "correct" in json.loads(line):
                return True
        except (ValueError, TypeError):
            continue
    return False


def test_clean_run_prints_its_result(tmp_path):
    proc = _emit(tiny.checkout(tmp_path), "rpsss_128.keygen_b2p20")
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert _printed_result(proc)


def test_reader_that_imports_jax_prints_no_result(tmp_path):
    root = tiny.checkout(tmp_path)
    reader = root / "starkbench" / "metrics" / "hash_rate.py"
    reader.write_text("import jax  # noqa: F401\n" + reader.read_text())
    proc = _emit(root, "rpsss_128.keygen_b2p20")
    assert proc.returncode == 4 and not _printed_result(proc)
    assert "modules that no run may load: jax" in proc.stderr


def test_reference_worker_that_imports_jax_prints_no_result(tmp_path):
    root = tiny.checkout(tmp_path)
    entry = root / "starkbench" / "entries" / "hash_batch.py"
    text = entry.read_text()
    jobs = "    jobs = [(config, json.loads(payload)) for _, payload in answers]\n"
    assert jobs in text
    entry.write_text(text.replace(jobs, '    pool.starmap(exec, [("import jax",)] * 64)\n' + jobs))
    proc = _emit(root, "rpsss_128.keygen_b2p20")
    assert proc.returncode == 4 and not _printed_result(proc)
    assert "modules that no run may load: jax" in proc.stderr
