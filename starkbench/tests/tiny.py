"""A checkout of the benchmark at test size, and a run of one of its cells
on the CPU through the harness (the card check aside).

The checkout also holds a cell that ``BENCHMARK.json`` does not declare,
``later_cell/``: a closed-loop signer, added as a later change would add
a cell, by new files and entries alone."""

from __future__ import annotations

import json
import pathlib
import shutil
import time

from starkbench import harness

#: the configurations at the sizes of the repository's fixtures
TINY = {
    "rpsss_128": {"num_collinearity_checks": 2, "security_level": 2,
                  "transition_constraints_degree": 2, "proof_bytes": 32546},
}
LATER = pathlib.Path(__file__).parent / "later_cell"
LATER_ENTRIES = json.loads((LATER / "cell.json").read_text())
LATER_CELLS = [w["name"] for w in LATER_ENTRIES["workloads"]]
TRAFFIC = {"sample": 4, "warmup_requests": 1}
HASH_TRAFFIC = {"batch": 64, "pool": 2, "rows": 8, "sample": 2}


def checkout(tmp: pathlib.Path) -> pathlib.Path:
    """BENCHMARK.json and starkbench/ under ``tmp``, every configuration
    and traffic file cut to test size."""
    shutil.copytree(harness.HERE, tmp / "starkbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    for sub in ("entries", "traffic", "metrics"):
        for path in (LATER / sub).iterdir():
            shutil.copy(path, tmp / "starkbench" / sub / path.name)
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    for key, entries in LATER_ENTRIES.items():
        bench[key] += entries
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    for c in bench["configs"]:
        path = tmp / c["file"]
        cfg = json.loads(path.read_text())
        cfg.update(TINY[c["name"]])
        path.write_text(json.dumps(cfg))
    for path in (tmp / "starkbench" / "traffic").glob("*.json"):
        traffic = json.loads(path.read_text())
        traffic.update(TRAFFIC)
        if traffic["entry"] == "hash_batch":
            traffic.update(HASH_TRAFFIC)
        path.write_text(json.dumps(traffic))
    return tmp


def rehearse(root: pathlib.Path, workload: str, seed: int = 3_000_000_001, seconds: int = 1,
             trace: bool = False, hook: str | None = None) -> dict:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell = harness.Cell(bench, workload, base=root / "starkbench", root=root)
    return harness.run_cell(cell, seed, seconds, trace, time.monotonic_ns(), device="cpu",
                            hook=hook)
