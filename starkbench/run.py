"""Run one cell of the benchmark of zk_stark_tpu_torch on this machine's card.

    python3 starkbench/run.py --workload rpsss_128.keygen_b2p20 --seed 7 --seconds 51 --trace 0

from the root of a checkout.  Prints, as the last line of standard output,
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` a ``breakdown``, and last ``checks``, the
numbers the reference compared, each beside its limit (also the last
lines of standard error).  Exits non-zero and prints no result without a
CUDA card, or when any process of the run (the client, a reference
worker, this one) has loaded JAX or the JAX package.  Build and compile
caches stay inside the checkout.
"""

from __future__ import annotations

import time

T_START = time.monotonic_ns()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: the caches of the program and of the libraries below it, at fixed paths
#: inside the checkout
CACHE = ROOT / ".starkbench_cache"
CACHE_DIRS = {"TORCH_EXTENSIONS_DIR": "torch_extensions", "TRITON_CACHE_DIR": "triton",
              "CUDA_CACHE_PATH": "cuda"}
#: one thread a process: the client and the reference workers share the
#: host's cores
THREAD_VARS = ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS")


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=int, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def set_environment() -> None:
    for var, sub in CACHE_DIRS.items():
        os.environ[var] = str(CACHE / sub)
    for var in THREAD_VARS:
        os.environ[var] = "1"


def main(argv=None) -> int:
    args = parse(argv)
    set_environment()

    from starkbench import harness

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = harness.Cell(bench, args.workload)
    chips = cell.workload["chips"]

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"no CUDA card for {args.workload} (it needs {chips})", file=sys.stderr)
        return 3
    return emit(cell, args.seed, args.seconds, bool(args.trace), T_START)


def emit(cell, seed: int, seconds: int, trace: bool, t_start: int, **options) -> int:
    """Run the cell and print its result line, unless a process of the run
    (the client, a reference worker, or this one up to the print) holds a
    module that no run may load: then name them on standard error and
    return 4."""
    from starkbench import harness, isolation

    try:
        result = harness.run_cell(cell, seed, seconds, trace, t_start, **options)
        forbidden = isolation.forbidden_loaded()
        if forbidden:
            raise harness.IsolationError(forbidden)
    except harness.IsolationError as e:
        print(str(e), file=sys.stderr)
        return 4
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
