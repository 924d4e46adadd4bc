"""Device times of the limb kernels and the BLAKE2b kernels at the sizes the
main paths give them, to compare two checkouts on one card in one call.

    python3 zk_stark_tpu_torch/tools/kernel_times.py [--root CHECKOUT]

It imports ``zk_stark_tpu_torch`` from CHECKOUT (by default the checkout
that holds this file), so that the same script times an earlier commit and
a change with the same method and the same inputs: every time is queued
(``measure.time_ms(queued=True)``: the card sleeps while the host enqueues
the calls), the median of 5 runs of 20 calls (3 of 5 calls at 2^25).  It
uses only entry points that every commit since the limb kernel has:
``ops.limbs`` ``*_kernel``, ``ops.blake2b`` ``leaf_kernel`` /
``node_kernel`` / ``compress_kernel``.  Prints the card line and one JSON
line; needs a card.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys


def main() -> int:
    default = pathlib.Path(__file__).resolve().parents[2]
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", type=pathlib.Path, default=default)
    args = parser.parse_args()
    sys.path.insert(0, str(args.root.resolve()))

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("kernel_times: no CUDA device")
    from zk_stark_tpu_torch.ops import blake2b as B
    from zk_stark_tpu_torch.ops import limbs as L
    from zk_stark_tpu_torch.tools.measure import card_line, time_ms

    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(7)

    def field(n):  # n random elements below p, as [n, 8] limbs on the card
        limbs = torch.randint(0, 1 << 16, (n, L.NLIMB), dtype=L.DTYPE, generator=gen)
        limbs[:, -1] %= L.P_LIMBS[-1]
        return limbs.to(dev)

    def timed(fn, n):
        reps, runs = (5, 3) if n >= 1 << 24 else (20, 5)
        return time_ms(fn, reps=reps, runs=runs, queued=True)

    out = {"root": str(args.root.resolve()), "limbs": {}, "leaf": {}, "node": {}}
    for n in (1 << 12, 1 << 20, 1 << 25):
        a, b = field(n), field(n)
        out["limbs"][n] = {
            "mont_mul": timed(lambda: L.mont_mul_kernel(a, b), n),
            "mont_mul_broadcast": timed(lambda: L.mont_mul_kernel(a, b[2]), n),
            "add_mod": timed(lambda: L.add_mod_kernel(a, b), n),
            "sub_mod": timed(lambda: L.sub_mod_kernel(a, b), n),
            "redc": timed(lambda: L.redc_kernel(a), n),
        }
        del a, b
    for n in (1 << 12, 1 << 20):
        canon = L.redc_kernel(field(n))
        out["leaf"][n] = timed(lambda: B.leaf_kernel(canon), n)
        level = B.leaf_kernel(canon)
        levels = []
        while level.shape[0] > 1:
            cur = level
            levels.append(timed(lambda: B.node_kernel(cur), n))
            level = B.node_kernel(level)
        out["node"][n] = {"parents": n // 2, "ms": levels[0], "tree_ms": sum(levels),
                          "levels_ms": levels}
    m = 1 << 18
    words = torch.randint(0, 1 << 32, (2, 16, m), dtype=L.DTYPE, generator=gen).to(dev)
    t = torch.full((m,), 128, dtype=L.DTYPE, device=dev)
    out["compress"] = {m: timed(lambda: B.compress_kernel(words[0], words[1], t), m)}
    torch.cuda.synchronize()
    print(f"card: {card_line()}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
