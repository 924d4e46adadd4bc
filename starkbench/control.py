"""Run a cell's control: the measured program with the lower guarantee its
entry's ``control`` sets (for ``hash_batch``, Rescue-Prime at half its
rounds), judged by the reference against the configuration as stated.
Its run has to come out not correct.

    python3 starkbench/control.py --workload rpsss_128.keygen_b2p20 --seed 7 --seconds 5

Arguments and result line as ``run.py``'s; the benchmark's own runs never
run it.
"""

from __future__ import annotations

import time

T_START = time.monotonic_ns()

import json  # noqa: E402
import sys  # noqa: E402

import run  # noqa: E402  (starkbench/ is this script's directory)


def main(argv=None) -> int:
    args = run.parse(argv)
    run.set_environment()
    from starkbench import harness

    bench = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    cell = harness.Cell(bench, args.workload)
    return run.emit(cell, args.seed, args.seconds, bool(args.trace), T_START,
                    hook="entry:control")


if __name__ == "__main__":
    sys.exit(main())
