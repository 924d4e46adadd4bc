"""Entry ``hash_batch``: bulk key generation, pk = Rescue-Prime hash of sk,
through ``RescuePrime.hash_batch_device`` on the RPSSS's own hash.

Set-up makes a pool of ``pool`` batches of ``batch`` secret keys on the
card from the seed (8 limbs of 16 bits, held as the Montgomery form the
entry takes; the top limb below p's, so every key is below p) and warms
up.  The window dispatches batch after batch, each on the next pool slot,
with at most ``depth`` in flight, and ends with a synchronise.  It keeps
``sample`` batches' digests (a reservoir from the seed); an answer is
``rows`` rows of one, drawn from the seed, keys and digests.
"""

from __future__ import annotations

import json
import random
import time
from collections import deque

from starkbench import inputs

#: p's top 16-bit limb: p = 52096 * 2^112 + 1
TOP_LIMB = 52096


def setup(ctx: dict) -> dict:
    import torch

    from zk_stark_tpu_torch.field import Field
    from zk_stark_tpu_torch.models.rpsss import RPSSS

    cfg, traffic, seed = ctx["config"], ctx["traffic"], ctx["seed"]
    device = torch.device(ctx["device"])
    rp = RPSSS(Field(), security_level=cfg["security_level"], device=device).rp
    gen = torch.Generator(device=device)
    gen.manual_seed(inputs.derive_int(seed, "keys"))
    shape = (traffic["pool"], traffic["batch"])
    pool = torch.randint(0, 1 << 16, shape + (8,), generator=gen, device=device)
    pool[..., 7] = torch.randint(0, TOP_LIMB, shape, generator=gen, device=device)
    state = {"rp": rp, "pool": pool, "depth": traffic["depth"], "batch": traffic["batch"],
             "sample": traffic["sample"], "rows": traffic["rows"], "seed": seed,
             "device": device}
    for i in range(traffic["warmup_requests"]):
        rp.hash_batch_device(pool[i % len(pool)])
    return state


def window(state: dict, t0: int, deadline: int) -> dict:
    import torch
    from torch.profiler import record_function

    rp, pool, depth = state["rp"], state["pool"], state["depth"]
    kept = state["answers"] = inputs.Reservoir(state["sample"], state["seed"])
    in_flight: deque = deque()
    n = 0
    while time.monotonic_ns() < deadline:
        if len(in_flight) >= depth:
            with record_function("starkbench.wait"):
                in_flight.popleft().synchronize()
        with record_function("starkbench.dispatch"):
            digests = rp.hash_batch_device(pool[n % len(pool)])
            done = torch.cuda.Event() if state["device"].type == "cuda" else None
            if done is not None:
                done.record()
                in_flight.append(done)
        kept.offer(n, digests)
        n += 1
    if state["device"].type == "cuda":
        torch.cuda.synchronize(state["device"])
    end = time.monotonic_ns()
    return {"requests": n, "failed": 0, "latencies": [], "end": end,
            "units": n * state["batch"]}


def answer(state: dict, k: int) -> bytes:
    """``rows`` rows of batch k: their keys and digests as limb lists."""
    digests = state["answers"][k]
    keys = state["pool"][k % len(state["pool"])]
    rng = random.Random(inputs.derive_int(state["seed"], "rows", k))
    rows = sorted(rng.sample(range(len(keys)), min(state["rows"], len(keys))))
    return json.dumps({"rows": rows, "keys": keys[rows].cpu().tolist(),
                       "digests": digests[rows].cpu().tolist()}).encode()


def check(config: dict, seed: int, answers, pool) -> list:
    from starkbench.reference import checks

    jobs = [(config, json.loads(payload)) for _, payload in answers]
    reasons = pool.starmap(checks.check_digests, jobs)
    return [(k, r) for (k, _), r in zip(answers, reasons)]


def control(spec: dict) -> None:
    """The control: the program's own Rescue-Prime at half its N rounds,
    below the 27 the configuration states."""
    from zk_stark_tpu_torch.models import rescue_prime

    init = rescue_prime.RescuePrime.__init__

    def fewer_rounds(self, *args, **kwargs):
        init(self, *args, **kwargs)
        self.N //= 2

    rescue_prime.RescuePrime.__init__ = fewer_rounds
