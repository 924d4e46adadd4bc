"""The parent of a run: finds the cell's files by name, builds the kernels,
starts the client, opens and closes the window, gathers what it counted,
has the reference judge a sample of the answers, and makes the result
line.

Everything that belongs to one configuration, traffic mix, entry or
metric is a file of its own, found by the name ``BENCHMARK.json`` gives:

* ``<file>`` of the configuration (a JSON object of its parameters);
* ``starkbench/traffic/<traffic>.json``: the entry, the batch, the
  dispatch depth, the warm-up and the sample size;
* ``starkbench/entries/<entry>.py``: ``setup``, ``request`` (or
  ``window``), ``answer``, ``check`` and ``control``;
* ``starkbench/metrics/<metric>.py``: ``read(run)``, the number or None.

A run is one client process on one card: a second process on the card
would take memory and time from the first.
"""

from __future__ import annotations

import json
import multiprocessing
import os
import pathlib
import sys
import time

from starkbench import inputs, isolation, yardstick
from starkbench.client import client_main, load_module

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
#: seconds the client may take to report ready (its set-up, warm-up included)
READY_TIMEOUT_S = 900
#: seconds past the window the client may take to finish and to answer
DONE_TIMEOUT_S = 300


class Cell:
    """One entry of ``workloads``: its configuration, traffic and metrics."""

    def __init__(self, bench: dict, workload: str, base: pathlib.Path = HERE,
                 root: pathlib.Path = ROOT):
        cells = {w["name"]: w for w in bench["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
        self.workload = cells[workload]
        if self.workload["chips"] != 1:
            raise ValueError(f"{workload}: {self.workload['chips']} chips; a run is one "
                             "client process on one card")
        self.name = workload
        configs = {c["name"]: c for c in bench["configs"]}
        self.config_entry = configs[self.workload["config"]]
        self.config = json.loads((root / self.config_entry["file"]).read_text())
        self.traffic = json.loads((base / "traffic" / f"{self.workload['traffic']}.json").read_text())
        self.entry_path = base / "entries" / f"{self.traffic['entry']}.py"
        self.base = base

        def applies(metric):
            return "workloads" not in metric or workload in metric["workloads"]

        self.end_to_end = [m for m in bench["end_to_end"] if applies(m)]
        self.per_layer = [m for m in bench["per_layer"] if applies(m)]

    def reader(self, name: str):
        return load_module(self.base / "metrics" / f"{name}.py", "starkbench_metric")

    def entry(self):
        return load_module(self.entry_path, "starkbench_entry")


class Run:
    """What a run measured, as the metric readers see it."""

    def __init__(self, cell: Cell, setup_s: float, t0: int, client: dict):
        self.config, self.traffic = cell.config, cell.traffic
        self.setup_s, self.t0 = setup_s, t0
        self.client = client
        self.requests = client["requests"]
        self.latencies = client["latencies"]
        self.traced = "trace" in client
        self.window_s = (client["end"] - t0) / 1e9
        self.busy_s, self.gaps, self.device_ns = 0.0, [], {}
        if self.traced:
            trace = client["trace"]
            self.busy_s, self.gaps = yardstick.union_seconds(trace["starts"], trace["ends"], t0,
                                                             client["end"])
            self.device_ns = trace["by_name"]

    def rate(self) -> float:
        """Work per second: the client's units over its span (a closed loop's
        span ends with the answer that passed the window's end)."""
        return self.client["units"] / self.window_s

    def stage_mean_ms(self, stage: str):
        total, count = self.client.get("stages", {}).get(stage, (0, 0))
        return total / count * 1e3 if count else None

    def breakdown(self) -> dict:
        ops = sorted(self.device_ns.items(), key=lambda kv: -kv[1])[:10]
        spans = [tuple(s) for s in self.client["trace"]["spans"]]
        return {"device_ops": [[n, ns / 1e9] for n, ns in ops],
                "idle_gaps": yardstick.idle_by_host_span(self.gaps, spans)}


class IsolationError(RuntimeError):
    def __init__(self, names):
        super().__init__(f"modules that no run may load: {', '.join(names)}")
        self.names = names


def build_kernels() -> None:
    """Compile every kernel library the checkout lacks (the first run of a
    checkout; the libraries stay in ``zk_stark_tpu_torch/build/``)."""
    from zk_stark_tpu_torch.ops import _build

    names = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    logs = _build.build(names)
    if logs:
        print(f"built {sorted(logs)}", file=sys.stderr)


def _recv(conn, timeout: float, what: str):
    if not conn.poll(timeout):
        raise TimeoutError(f"the client sent no {what} within {timeout} s")
    msg = conn.recv()
    if msg[0] == "error":
        raise RuntimeError(f"the client failed:\n{msg[1]}")
    return msg


def run_cell(cell: Cell, seed: int, seconds: int, trace: bool, t_start: int,
             device: str = "cuda", hook: str | None = None) -> dict:
    """Run the cell once; returns the result line's object.  Raises
    :class:`IsolationError` when the client, a reference worker or this
    process has loaded a module that no run may load."""
    if device == "cuda":
        build_kernels()
    spec = {"entry": str(cell.entry_path), "config": cell.config, "traffic": cell.traffic,
            "seed": seed, "device": device, "trace": trace, "hook": hook}
    conn, child = multiprocessing.get_context("spawn").Pipe()
    proc = multiprocessing.get_context("spawn").Process(target=client_main, args=(child, spec),
                                                        daemon=True)
    proc.start()
    child.close()
    try:
        ready = _recv(conn, READY_TIMEOUT_S, "ready")[1]
        t0 = time.monotonic_ns() + 100_000_000
        conn.send(("go", t0, t0 + seconds * 1_000_000_000))
        done = json.loads(_recv(conn, seconds + DONE_TIMEOUT_S, "result")[1])
        print(f"client: {done['requests']} requests in {(done['end'] - t0) / 1e9:.3f} s",
              file=sys.stderr)
        wanted = inputs.draw_sample(seed, done["kept"], cell.traffic["sample"])
        conn.send(("sample", wanted))
        got, client_forbidden = _recv(conn, DONE_TIMEOUT_S, "answers")[1:]
        conn.send(("exit",))
    finally:
        proc.join(timeout=60)
        if proc.is_alive():
            proc.kill()
            proc.join()
    run = Run(cell, (t0 - t_start) / 1e9, t0, done)
    result, worker_forbidden = _judge_and_report(cell, run, seed, wanted, got, ready, trace)
    forbidden = sorted(set(client_forbidden) | set(worker_forbidden)
                       | set(isolation.forbidden_loaded()))
    if forbidden:
        raise IsolationError(forbidden)
    return result


def _report(fn, args):
    """``fn(*args)`` in a reference worker, with the forbidden modules the
    worker holds afterwards."""
    return fn(*args), isolation.forbidden_loaded()


class ReferencePool:
    """The pool of processes the reference runs in: ``starmap`` as a
    ``multiprocessing`` pool's, which also gathers what the workers have
    loaded that no run may load."""

    def __init__(self, workers: int):
        self._pool = multiprocessing.get_context("spawn").Pool(workers)
        self.forbidden: set[str] = set()

    def starmap(self, fn, jobs) -> list:
        out = []
        for value, forbidden in self._pool.starmap(_report, [(fn, tuple(j)) for j in jobs]):
            out.append(value)
            self.forbidden.update(forbidden)
        return out

    def close(self) -> None:
        self._pool.close()
        self._pool.join()


def _judge_and_report(cell: Cell, run: Run, seed: int, wanted, got, ready, trace):
    """(the result line's object, forbidden modules the reference's workers
    loaded)."""
    answers = [(k, got[k]) for k in wanted if k in got]
    pool = ReferencePool(max(1, min(len(os.sched_getaffinity(0)) - 1, 16, len(answers))))
    try:
        verdicts = cell.entry().check(cell.config, seed, answers, pool)
    finally:
        pool.close()
    rejected = [v for v in verdicts if v[1] is not None]
    for k, reason in rejected[:5]:
        print(f"request {k} rejected: {reason}", file=sys.stderr)
    failed = run.client["failed"]
    missing = max(len(wanted), 1) - len(answers)
    checks = {"rejected": {"value": len(rejected), "limit": 0},
              "failed": {"value": failed, "limit": 0},
              "missing": {"value": missing, "limit": 0}}
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = cell.reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu" if ready["device_name"] != "cpu" else "cpu",
              "kind": ready["device_name"], "count": 1,
              "memory_peak_bytes": run.client["memory_peak_bytes"]}
    result = {"correct": all(v["value"] <= v["limit"] for v in checks.values()),
              "attempted": run.requests, "failed": failed, "metrics": metrics, "device": device}
    if trace:
        device["busy_s"], device["window_s"] = run.busy_s, run.window_s
        result["breakdown"] = run.breakdown()
    print(f"sampled {len(answers)} answers of {result['attempted']} requests; "
          f"{len(run.latencies)} latencies", file=sys.stderr)
    for name, v in checks.items():
        print(f"check {name} {v['value']} <= {v['limit']}", file=sys.stderr)
    result["checks"] = checks
    return result, sorted(pool.forbidden)
