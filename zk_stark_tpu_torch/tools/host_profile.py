"""Where the host's time goes in one warm RPSSS sign and one verify on the
card: cProfile's Python functions by cumulative time.

    python3 -m zk_stark_tpu_torch.tools.host_profile [--top 15]

Signs and verifies once at the default configuration (the first call of a
configuration captures its segments), then profiles one more sign and one
more verify, each ending in ``torch.cuda.synchronize()``.  Prints the
card line, each run's wall time and its top functions by cumulative time
(calls, cumulative ms, own ms), and one JSON line of the same.  Needs a
card.
"""

from __future__ import annotations

import argparse
import cProfile
import json
import pstats
import time

import torch

from ..carry import DetRng
from ..field import Field
from ..models.rpsss import RPSSS
from .measure import card_line


def profiled(fn, top: int) -> dict:
    """``fn()`` under cProfile: its wall ms and its ``top`` functions by
    cumulative time."""
    # Python functions only: C calls (the CUDA graph's replay among them)
    # are timed inside their callers
    prof = cProfile.Profile(builtins=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prof.enable()
    fn()
    torch.cuda.synchronize()
    prof.disable()
    wall_ms = (time.perf_counter() - t0) * 1e3
    stats = pstats.Stats(prof)
    rows = []
    for (path, line, name), (_, calls, own, cum, _) in stats.stats.items():
        rows.append({"function": f"{path.split('/')[-1]}:{line}({name})", "calls": calls,
                     "cum_ms": cum * 1e3, "own_ms": own * 1e3})
    rows.sort(key=lambda r: -r["cum_ms"])
    return {"wall_ms": wall_ms, "top": rows[:top]}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--top", type=int, default=15)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("host_profile: no CUDA device")
    doc = b"attack at dawn"
    rpsss = RPSSS(Field(), device="cuda", rng=DetRng(b"host-profile"))
    sk, pk = rpsss.keygen()
    if not rpsss.verify(pk, doc, rpsss.sign(sk, doc)):
        raise SystemExit("host_profile: the first signature was rejected")
    out = {"card": card_line()}
    sigs = []
    out["sign"] = profiled(lambda: sigs.append(rpsss.sign(sk, doc)), args.top)
    ok = []
    out["verify"] = profiled(lambda: ok.append(rpsss.verify(pk, doc, sigs[0])), args.top)
    if ok != [True]:
        raise SystemExit("host_profile: the profiled signature was rejected")
    print(f"card: {out['card']}")
    for run in ("sign", "verify"):
        print(f"{run}: {out[run]['wall_ms']:.3f} ms wall; top {args.top} by cumulative time")
        for r in out[run]["top"]:
            print(f"  {r['cum_ms']:9.3f} ms cum {r['own_ms']:9.3f} ms own {r['calls']:7d} calls  "
                  f"{r['function']}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
