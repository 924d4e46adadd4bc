"""Device times of the limb kernels, the BLAKE2b kernels and the fold at the
sizes the main paths give them, to compare two checkouts on one card in one
call.

    python3 zk_stark_tpu_torch/tools/kernel_times.py [--root CHECKOUT]

It imports ``zk_stark_tpu_torch`` from CHECKOUT (by default the checkout
that holds this file), so that the same script times an earlier commit and
a change with the same method and the same inputs: every time is queued
(``measure.time_ms(queued=True)``: the card sleeps while the host enqueues
the calls), the median of 5 runs of 20 calls (3 of 5 calls at 2^25).  It
uses only entry points that every commit since the limb kernel has
(``ops.limbs`` ``*_kernel``; ``ops.blake2b`` ``leaf_kernel``,
``node_kernel`` for one level, ``compress_kernel``; ``ops.fold``
``fold_kernel``; ``ops.limbs.batch_inv`` at the paths' sizes and 2^20,
behind the longer sleep below: the tree form of earlier commits launches
30-70 kernels a call), ``ops.limbs.mont_inv_fermat_kernel`` (at 1 and 2^14
elements) where the checkout has it, and ``ops.blake2b.tree_kernel``
where the checkout has it: a tree of 2^12 and of 2^20 leaves is timed whole, by ``tree_kernel``
or else by ``node_kernel`` one level at a time (behind a longer sleep of
the card, since one launch a level takes longer on the host than on the
card), and ``ops.rescue_ops.permutation_kernel`` on 256, 2^14 and 2^20
random states of width 2, and of widths 3 and 4 where the checkout's
kernel takes them (``KERNEL_MAX_M``; unqueued, 3 of 3 runs of 3 calls at
2^20), ``ops.ntt.ntt_kernel`` on one column of 4096 and of 2^20 points and
on 1024 columns of 1024 (the stage-variant probe's shape), and
``ops.montmul_chain.mont_mul_chain_kernel`` on 2^18 elements at k = 32 and
1024 (unqueued, 3 of 3 runs of 5 calls at 1024).  Prints the card line and
one JSON line; needs a card.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import sys

#: clock cycles the card sleeps a tree call before its timed calls: ~2 ms
#: at the H100's ~2 GHz, more than 20 host launches
TREE_SLEEP_CYCLES = 4_000_000


def main() -> int:
    default = pathlib.Path(__file__).resolve().parents[2]
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", type=pathlib.Path, default=default)
    args = parser.parse_args()
    sys.path.insert(0, str(args.root.resolve()))

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("kernel_times: no CUDA device")
    from zk_stark_tpu_torch.field import Field
    from zk_stark_tpu_torch.models.rescue_prime import RescuePrime
    from zk_stark_tpu_torch.ops import blake2b as B
    from zk_stark_tpu_torch.ops import fold as FO
    from zk_stark_tpu_torch.ops import limbs as L
    from zk_stark_tpu_torch.ops import montmul_chain as MC
    from zk_stark_tpu_torch.ops import ntt as N
    from zk_stark_tpu_torch.ops import rescue_ops as R
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

    def tree_timed(fn, reps=20, runs=5):
        """Queued as time_ms queues, behind a sleep long enough for a tree's
        host time (one launch a level is ~20 us of host time each, more than
        a narrow level's device time)."""
        fn()
        torch.cuda.synchronize()
        samples = []
        for _ in range(runs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(TREE_SLEEP_CYCLES * reps)
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            torch.cuda.synchronize()
            samples.append(start.elapsed_time(end) / reps)
        return statistics.median(samples)

    out = {"root": str(args.root.resolve()), "limbs": {}, "leaf": {}, "node": {}, "fold": {}}
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
    inv = getattr(L, "mont_inv_fermat_kernel", None)  # the inversion, where the checkout has it
    if inv is not None:
        out["inv"] = {n: timed(lambda: inv(x), n) for n, x in ((1, field(1)), (1 << 14, field(1 << 14)))}

    out["batch_inv"] = {}
    for n in (284, 512, 1024, 86_657, 1 << 17, 1 << 18, 1 << 20):
        x = field(n)
        x[0] = 0
        out["batch_inv"][n] = tree_timed(lambda: L.batch_inv(x))
        del x

    def level_loop(leaves):  # one node_kernel launch a level
        level = leaves
        while level.shape[0] > 1:
            level = B.node_kernel(level)

    tree = getattr(B, "tree_kernel", None) or level_loop
    for n in (1 << 12, 1 << 20):
        canon = L.redc_kernel(field(n))
        out["leaf"][n] = timed(lambda: B.leaf_kernel(canon), n)
        leaves = B.leaf_kernel(canon)
        launches = B.NODE_KERNEL.launches
        tree(leaves)
        out["node"][n] = {"parents": n // 2, "tree": tree.__name__,
                          "tree_launches": B.NODE_KERNEL.launches - launches,
                          "ms": timed(lambda: B.node_kernel(leaves), n),
                          "tree_ms": tree_timed(lambda: tree(leaves))}
        cw, invpows, ao = field(n), field(n // 2), field(1)[0]
        out["fold"][n] = timed(lambda: FO.fold_kernel(cw, invpows, ao, ao), n)
    m = 1 << 18
    words = torch.randint(0, 1 << 32, (2, 16, m), dtype=L.DTYPE, generator=gen).to(dev)
    t = torch.full((m,), 128, dtype=L.DTYPE, device=dev)
    out["compress"] = {m: timed(lambda: B.compress_kernel(words[0], words[1], t), m)}
    del words
    out["rescue"] = {}
    # earlier checkouts' kernel takes m = 2 only
    for width in [w for w in (2, 3, 4) if w <= getattr(R, "KERNEL_MAX_M", 2)]:
        rp = RescuePrime(Field(), m=width)
        mds, rc = rp._device_constants(dev)
        out["rescue"][f"m={width}"] = {}
        for n in (256, 1 << 14, 1 << 20):
            state = field(n * width).reshape(n, width, L.NLIMB)
            reps, runs = (20, 5) if n < 1 << 20 else (3, 3)
            out["rescue"][f"m={width}"][n] = time_ms(
                lambda: R.permutation_kernel(state, mds, rc, rp.N, rp.alpha, rp.alpha_inv),
                reps=reps, runs=runs)
    out["ntt"] = {}
    for n, cols in ((1 << 12, 1), (1 << 20, 1), (1 << 10, 1 << 10)):
        x = field(n * cols).reshape(n, cols, L.NLIMB)
        root = Field().primitive_nth_root(n).value
        out["ntt"][f"{n}x{cols}"] = timed(lambda: N.ntt_kernel(x, root), n * cols)
        del x
    chain = field(1 << 18)
    out["montmul_chain"] = {
        k: time_ms(lambda: MC.mont_mul_chain_kernel(chain, k), **({} if k == 32 else
                                                                  dict(reps=5, runs=3)))
        for k in (32, 1024)}
    torch.cuda.synchronize()
    print(f"card: {card_line()}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
