"""The client process of a run: the benchmark's side of each call.

The parent starts the client with ``spawn`` and talks to it over a pipe;
only ints, strings, floats and bytes cross.  The client imports the
measured package, builds its entry's state (inputs made from the seed,
warm-up calls that capture the segments), reports ready, waits for the
start, runs its window, and reports what it counted.  In a traced run it
also profiles its CUDA context over the window and sends the device
intervals, the kernel times by name and the program's host spans, all on
the monotonic clock.  Then it sends the answers the parent samples, with
the modules it holds that no run may load, and exits.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import sys
import time
import traceback

#: spans of the program (``record_function``) and of the benchmark kept
#: from a trace to say what the host was doing while the card idled
SPAN_PREFIXES = ("stark.", "chain.", "starkbench.")


def load_module(path, name: str):
    """The Python file at ``path``, loaded as a module named ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def kernel_calls() -> int:
    """Python calls of every kernel of the program so far (``Kernel.calls``)."""
    from zk_stark_tpu_torch.ops._build import Kernel

    return sum(k.calls for k in Kernel.instances)


def closed_loop(entry, state, t0: int, deadline: int, keep: int) -> dict:
    """Request after request until one completes at or after ``deadline``;
    each latency from the call to the answer in hand (monotonic ns).  A
    reservoir from the seed keeps ``keep`` answers."""
    from torch.profiler import record_function

    from starkbench.inputs import Reservoir

    latencies, failed, k = [], 0, 0
    kept = state["answers"] = Reservoir(keep, state["seed"])
    t = t0
    while t < deadline:
        with record_function("starkbench.request"):
            try:
                kept.offer(k, entry.request(state, k))
            except Exception:  # counted as failed; the window goes on
                failed += 1
                traceback.print_exc()
        t1 = time.monotonic_ns()
        latencies.append((t1 - t) / 1e9)
        t, k = t1, k + 1
    return {"requests": k, "failed": failed, "latencies": latencies, "end": t,
            "units": k}


def _trace_payload(prof, anchor_mono: int, lo: int, hi: int) -> dict:
    """The device intervals (monotonic ns, clipped to [lo, hi]), device
    time by operation name and host spans of a finished profile."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    anchors = [e for e in events if e.name() == "starkbench.anchor"]
    a = anchors[-1]
    offset = (a.start_ns() + a.end_ns()) // 2 - anchor_mono
    starts, ends, by_name, spans = [], [], {}, []
    for e in events:
        s, t = e.start_ns() - offset, e.end_ns() - offset
        if e.device_type() == DeviceType.CUDA:
            if e.is_user_annotation() or e.name().startswith(SPAN_PREFIXES):
                continue  # a host span drawn on the device's timeline
            s, t = max(s, lo), min(t, hi)
            if t > s:
                starts.append(s)
                ends.append(t)
                by_name[e.name()] = by_name.get(e.name(), 0) + (t - s)
        elif e.name().startswith(SPAN_PREFIXES) and t > lo and s < hi:
            spans.append([e.name(), s, t])
    return {"starts": starts, "ends": ends, "by_name": by_name, "spans": spans}


def _run(conn, spec: dict) -> None:
    t_start = time.monotonic_ns()
    import torch

    torch.set_num_threads(1)
    entry = load_module(spec["entry"], "starkbench_entry")
    if spec.get("hook"):  # "module:function", or "entry:function" of the cell's entry
        module, _, fn = spec["hook"].partition(":")
        getattr(entry if module == "entry" else importlib.import_module(module), fn)(spec)
    device = torch.device(spec["device"])
    ctx = {k: spec[k] for k in ("config", "traffic", "seed", "device")}
    state = entry.setup(ctx)
    state.setdefault("seed", spec["seed"])
    # what set-up made lives to the end: keep it out of the collector's
    # scans, so that a collection in the window costs what the window made
    gc.collect()
    gc.freeze()
    on_card = device.type == "cuda"
    prof = None
    if spec["trace"]:
        from torch.profiler import ProfilerActivity, profile

        from zk_stark_tpu_torch.utils.profiling import StageTimer

        state["timer"] = StageTimer(device)
        if "stark" in state:
            state["stark"].timer = state["timer"]
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
        prof = profile(activities=activities)
        prof.__enter__()
    if on_card:
        torch.cuda.synchronize(device)
    conn.send(("ready", {
        "setup_s": (time.monotonic_ns() - t_start) / 1e9,
        "device_name": torch.cuda.get_device_name(device) if on_card else "cpu",
    }))
    _, t0, deadline = conn.recv()
    calls0 = kernel_calls()
    time.sleep(max(0, t0 - time.monotonic_ns()) / 1e9)
    anchor = 0
    if prof is not None:
        from torch.profiler import record_function

        for _ in range(2):  # the second is warm: its midpoint ties the clocks
            a0 = time.monotonic_ns()
            with record_function("starkbench.anchor"):
                pass
            anchor = (a0 + time.monotonic_ns()) // 2
    if hasattr(entry, "window"):
        result = entry.window(state, t0, deadline)
    else:
        result = closed_loop(entry, state, t0, deadline, spec["traffic"]["sample"])
    if on_card:
        torch.cuda.synchronize(device)
    result["kernel_calls"] = kernel_calls() - calls0
    result["memory_peak_bytes"] = torch.cuda.max_memory_allocated(device) if on_card else 0
    if prof is not None:
        prof.__exit__(None, None, None)
        result["trace"] = _trace_payload(prof, anchor, t0, result["end"])
        timer = state["timer"]
        result["stages"] = {k: [timer.totals[k], timer.counts[k]] for k in timer.totals}
    result["kept"] = sorted(state.get("answers", {}))
    conn.send(("done", json.dumps(result).encode()))
    _, wanted = conn.recv()
    answers = {k: entry.answer(state, k) for k in wanted}
    from starkbench.isolation import forbidden_loaded

    conn.send(("answers", answers, forbidden_loaded()))
    conn.recv()


def client_main(conn, spec: dict) -> None:
    os.dup2(2, 1)  # the parent's standard output carries the result alone
    sys.stdout = sys.stderr
    try:
        _run(conn, spec)
    except Exception:  # the process boundary: report, then fail
        conn.send(("error", traceback.format_exc()))
        sys.exit(1)
    finally:
        conn.close()
