"""A multi-process dry run of the distributed prover, and its checks.

Counterpart of the JAX package's ``__graft_entry__.dryrun_multichip``.
:func:`dryrun_multichip` starts ``world_size`` processes (``spawn``), each
of which runs :func:`run_rank`: it joins a process group (rendezvous
through a file, so that concurrent runs never share a port), runs its
tasks and writes their results (JSON) for the parent.  The default task
proves a small RescuePrime statement under the distributed engine, checks
it byte for byte against the single-device proof and verifies it with
the engine-free verifier.

The tasks are the functions of :data:`TASKS`.  ``chip_smoke.py`` calls the
same checks in its own process on the card (NCCL at world size 1) and the
CPU tests through :func:`dryrun_multichip` (gloo at world sizes 2 and 4).
A child imports only torch and this package.
"""

from __future__ import annotations

import json
import multiprocessing
import os
import pathlib
import statistics
import tempfile
import time
import traceback
from typing import Callable, Sequence

import torch
import torch.distributed as dist

from .. import segments
from ..carry import DetRng, chain_from_config, rpsss_from_config
from ..field import Field
from ..merkle import DeviceMerkleTree, open_many
from ..models.rescue_chain import make_chain_stark
from ..models.rescue_prime import RescuePrime
from ..models.rpsss import RPSSS
from ..ops import limbs as L
from ..ops.ntt import ntt_mont
from ..proof_stream import ProofStream
from ..stark import Stark
from . import collectives
from .engine import DEFAULT, DistEngine, dist_engine, engine_for_hybrid
from .mesh import block
from .multihost import DCN_AXIS, hybrid_mesh, initialize, shutdown
from .ntt_dist import (
    flatten_natural,
    four_step_geometry,
    four_step_local,
    gather_columns,
    intt_dist,
    ntt_dist,
    twiddle_table,
)

P = L.P


def require(cond: bool, message: str) -> None:
    if not cond:
        raise RuntimeError(message)


def random_mont(n: int, seed: int, device) -> torch.Tensor:
    """n field elements [n, 8] from ``seed`` (the same on every rank), every
    eighth one zero: the top limb below p's keeps each value below p."""
    gen = torch.Generator().manual_seed(seed)
    limbs = torch.randint(0, 1 << 16, (n, L.NLIMB), dtype=L.DTYPE, generator=gen)
    limbs[:, -1] %= L.P_LIMBS[-1]
    limbs[::8] = 0
    return limbs.to(device)


def _counted(fn: Callable, *args):
    """(fn(*args), the collectives it issued by kind)."""
    out, tally = _recorded(fn, *args)
    return out, tally.counts()


def _recorded(fn: Callable, *args):
    """(fn(*args), the :class:`collectives.Tally` of what it issued)."""
    with collectives.record() as tally:
        out = fn(*args)
    return out, tally


def tally_json(tally: collectives.Tally) -> dict:
    """A tally's collectives, received bytes and largest result (rows), by
    kind."""
    return {"collectives": tally.counts(), "received_bytes": tally.received_bytes(),
            "largest_rows": tally.largest_rows()}


def check_ntt_dist(sizes: Sequence[int], device, group=None) -> dict:
    """For each size, this rank's block of a random coefficient matrix
    through :func:`ntt_dist` (twiddles computed in the body) and through
    :func:`four_step_local` with the engine's twiddle table: both equal the
    single-device transform, gathered; :func:`intt_dist` returns the
    block.  The four-step issues one all-to-all and no all-gather."""
    n_dev, index = dist.get_world_size(group), dist.get_rank(group)
    field = Field()
    out = {}
    for n in sizes:
        n1, n2 = four_step_geometry(n)
        root = field.primitive_nth_root(n).value
        x = random_mont(n, n, device)
        x_local = x.reshape(n1, n2, L.NLIMB)[:, block(n2, n_dev, index)]
        z_local, issued = _counted(ntt_dist, x_local, root, group)
        require(issued == {"all_to_all": 1, "permute": 0, "all_gather": 0, "broadcast": 0},
                f"ntt_dist n={n} issued {issued}")
        tw = twiddle_table(root, n1, n2, n_dev, index, device)
        require(torch.equal(four_step_local(x_local, n1, n2, group, root, tw_local=tw),
                            z_local), f"n={n}: the twiddle table and powers differ")
        z = flatten_natural(gather_columns(z_local, group))
        require(torch.equal(z, ntt_mont(x, root)), f"ntt_dist n={n} differs from ntt_mont")
        back = intt_dist(z_local, root, group)
        require(torch.equal(back, x_local), f"intt_dist n={n} does not return the block")
        out[n] = {"n1": n1, "n2": n2, "four_step_collectives": issued}
    return out


def check_engine_ops(engine: DistEngine, sizes: Sequence[int], device) -> dict:
    """``engine``'s ntt, intt, batch_inv, fold_round, combine and move on this
    rank's block of random inputs (the same on every rank) against the same
    rows of the single-device engine's output, bit for bit, with the
    collectives each issued, the bytes they handed this rank and their
    largest result (rows), by kind."""
    field = Field()
    two_inv = L.int_to_mont(pow(2, -1, P), device)
    out = {}
    for n in sizes:
        root = field.primitive_nth_root(n).value
        x = random_mont(n, n + 1, device)
        ao = random_mont(1, n + 2, device)[0]
        # seg2's terms: shorter than n, two of them shifted
        arrs = [random_mont(n // 4 + j, n + 3 + j, device) for j in range(3)]
        shifts = [0, n // 8, n // 2 + 3]
        w = random_mont(len(arrs), n + 6, device)
        xb, rows, half = engine.constrain(x, n), engine.rows(n), engine.rows(n // 2)
        whole_comb = DEFAULT.combine(w, arrs, shifts)
        # rows [3, n/2) of x to the start of a length-n/2 vector; the first
        # two rows of x as a length-2 vector (whole at D = 2 and 4)
        moved = torch.cat([x[3 : n // 2], torch.zeros_like(x[:3])])
        cases = {
            "ntt": (lambda: engine.ntt(xb, root, n), lambda: DEFAULT.ntt(x, root)[rows]),
            "intt": (lambda: engine.intt(xb, root, n), lambda: DEFAULT.intt(x, root)[rows]),
            "batch_inv": (lambda: engine.batch_inv(xb), lambda: DEFAULT.batch_inv(x)[rows]),
            "fold_round": (
                lambda: torch.stack(engine.fold_round(xb, root, ao, two_inv, n)),
                lambda: torch.stack(DEFAULT.fold_round(x, root, ao, two_inv))[:, half]),
            "combine": (
                lambda: engine.combine(w, [engine.constrain(a, n) for a in arrs], shifts, n),
                lambda: engine.constrain(whole_comb, n)),
            "move": (lambda: engine.move(xb, n, n // 2, [(3, 0, n // 2 - 3)])[0],
                     lambda: engine.constrain(moved, n // 2)),
            "move_whole": (lambda: engine.move(xb, n, 2, [(0, 0, 2)])[0],
                           lambda: engine.constrain(x[:2], 2)),
        }
        out[n] = {}
        for name, (dist_op, single_op) in cases.items():
            got, tally = _recorded(dist_op)
            require(torch.equal(got, single_op()),
                    f"DistEngine.{name} n={n} differs from the single engine's rows")
            out[n][name] = tally_json(tally)
    return out


def check_merkle(engine: DistEngine, sizes: Sequence[int], queries: int, device) -> dict:
    """For each size, a tree over this rank's block of a random canonical
    codeword against the tree over the whole one: the same root, the same
    leaves, and :func:`merkle.open_many` of both (beside a whole tree's
    queries) gives the same values and paths.  Returns the collectives of
    the build and of the openings."""
    out = {}
    for n in sizes:
        canon = random_mont(n, 7 * n, device)
        idx = [int(i) for i in torch.randint(0, n, (queries,),
                                             generator=torch.Generator().manual_seed(n))]
        whole = DeviceMerkleTree(canon)
        blocked, built = _recorded(DeviceMerkleTree, engine.constrain(canon, n), n, engine)
        require(blocked.root == whole.root, f"merkle n={n}: the roots differ")
        require(blocked.all_values() == whole.all_values(), f"merkle n={n}: the leaves differ")
        other = sorted(set(idx))[:3]
        got, opened = _recorded(open_many, [(blocked, idx), (whole, other)])
        require(got == open_many([(whole, idx), (whole, other)]),
                f"merkle n={n}: the openings differ")
        out[n] = {"build": built.counts(), "openings": opened.counts()}
    return out


def _with_engine(stark: Stark, engine) -> Stark:
    stark.engine = stark.fri.engine = engine
    return stark


def sign(engine, config: dict, document: str, rng_tag: str, device) -> dict:
    """keygen -> sign through ``rpsss_from_config`` with ``engine`` set on
    the Stark and its FRI after construction."""
    rpsss = rpsss_from_config(config, device=device, rng=DetRng(rng_tag.encode()))
    sk, pk = rpsss.keygen()
    _with_engine(rpsss.stark, engine)
    sig, tally = _recorded(rpsss.sign, sk, document.encode())
    return {"proof": sig.hex(), "sk": str(sk), "pk": str(pk), **tally_json(tally)}


def prove_chain(engine, config: dict, input_element: str, rng_tag: str, device) -> dict:
    """The chain of ``config`` proved from ``input_element`` with ``engine``."""
    model, stark = chain_from_config(config, device=device, rng=DetRng(rng_tag.encode()))
    _with_engine(stark, engine)
    air = model.air(stark.omicron, stark.omicron_domain_length)
    trace = model.trace(int(input_element))
    boundary = model.boundary_constraints(trace[-1][0])
    proof, tally = _recorded(stark.prove, trace, air, boundary, ProofStream(stark.field))
    return {"proof": proof.hex(), "fri_domain_length": stark.fri.domain_length,
            "last_codeword_rows": stark.fri.domain_length >> (stark.fri.num_rounds() - 1),
            # the rows of every all-gather's result, the last FRI codeword's among them
            "all_gather_rows": sorted({rows for kind, _, rows, _ in tally.events
                                       if kind == "all_gather"}),
            **tally_json(tally)}


def small_statement(device, rng, engine=None):
    """(stark, air, boundary, trace) of the JAX package's distributed test
    statement: RescuePrime(2, 1, 2, 27), Stark(4, 2, 2, 2, 28, 2)."""
    field = Field()
    rp = RescuePrime(field, 2, 1, 2, 27)
    inp = field.sample(b"\x42\x17").value
    stark = Stark(field, 4, 2, 2, rp.m, rp.N + 1, 2, rng=rng, device=device, engine=engine)
    air = rp.transition_constraints(stark.omicron, stark.omicron_domain_length)
    return stark, air, rp.boundary_constraints(rp.hash(inp)), rp.trace(inp)


def prove_small(engine, rng_tag: str, device) -> dict:
    """The small statement proved with ``engine`` and DetRng(rng_tag)."""
    stark, air, boundary, trace = small_statement(device, DetRng(rng_tag.encode()), engine)
    proof, issued = _counted(stark.prove, trace, air, boundary, ProofStream(stark.field))
    return {"proof": proof.hex(), "collectives": issued}


# -- tasks: each takes the device and keyword arguments and returns JSON ------


def task_ntt_dist(device, sizes) -> dict:
    return check_ntt_dist(sizes, device)


def task_engine_ops(device, sizes) -> dict:
    engine = dist_engine(dist.get_world_size())
    return {"captures_segments": engine.captures_segments,
            **check_engine_ops(engine, sizes, device)}


def task_merkle(device, sizes, queries) -> dict:
    return check_merkle(dist_engine(dist.get_world_size()), sizes, queries, device)


def task_sign(device, config, document, rng_tag) -> dict:
    return sign(dist_engine(dist.get_world_size()), config, document, rng_tag, device)


def task_chain(device, config, input_element, rng_tag) -> dict:
    return prove_chain(dist_engine(dist.get_world_size()), config, input_element, rng_tag,
                       device)


def task_rank_rng(device, rng_tag) -> dict:
    """The small statement with a different rng on each rank (``rng_tag``
    and the rank): every rank must return rank 0's proof."""
    return prove_small(dist_engine(dist.get_world_size()), f"{rng_tag}-{dist.get_rank()}",
                       device)


def task_hybrid_sign(device, ici_parallelism, config, document, rng_tag) -> dict:
    """The signature through the engine of this rank's row of a hybrid
    mesh, with the global ranks of every group its collectives used."""
    mesh = hybrid_mesh(ici_parallelism)
    row = mesh.get_local_rank(DCN_AXIS)
    engine = engine_for_hybrid(mesh, row)
    before = collectives.issued.copy()
    out = sign(engine, config, document, rng_tag, device)
    out["row"] = row
    out["row_ranks"] = list(engine.devices)
    out["groups"] = sorted({ranks for _, ranks in collectives.issued - before})
    return out


def task_dryrun(device, rng_tag="dryrun") -> dict:
    """The small statement under the distributed engine: byte for byte the
    single-device proof, accepted by the engine-free verifier."""
    got = prove_small(dist_engine(dist.get_world_size()), rng_tag, device)
    want = prove_small(DEFAULT, rng_tag, device)
    require(got["proof"] == want["proof"], "the distributed proof differs from the single one")
    stark, air, boundary, _ = small_statement(device, DetRng(rng_tag.encode()))
    proof = bytes.fromhex(got["proof"])
    stark.verify(air, boundary, ProofStream.deserialize(proof, stark.field))
    return {"proof_bytes": len(proof), "collectives": got["collectives"]}


def task_timed(device, chain_length, runs=3) -> dict:
    """Warm default-config signs and chain proves of ``chain_length``
    under the single engine (every rank alone on its device) and under the
    distributed one, from the same randomness: byte for byte equal, with
    each warm run's host wall clock (ms, the device synchronised at its
    ends), the median, and the first warm distributed run's collectives
    and segment replays."""
    engine = dist_engine(dist.get_world_size())
    rpsss = RPSSS(Field(), device=device, rng=DetRng(b"dist-timed"))
    sk, _ = rpsss.keygen()
    model, stark = make_chain_stark(Field(), chain_length, device=device)
    air = model.air(stark.omicron, stark.omicron_domain_length)
    trace = model.trace(0x5EED)
    boundary = model.boundary_constraints(trace[-1][0])

    def sign(eng):
        rpsss.stark._rng = DetRng(b"dist-timed-sign")
        _with_engine(rpsss.stark, eng)
        return rpsss.sign(sk, b"attack at dawn")

    def prove(eng):
        stark._rng = DetRng(b"dist-timed-chain")
        _with_engine(stark, eng)
        return stark.prove(trace, air, boundary, ProofStream(stark.field))

    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()

    def timed(fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, (time.perf_counter() - t0) * 1e3

    out = {"chain_length": chain_length, "fri_domain_length": stark.fri.domain_length}
    for name, fn in (("sign", sign), ("chain_prove", prove)):
        proofs, row = {}, {}
        for label, eng in (("single", DEFAULT), ("dist", engine)):
            fn(eng)  # cold: the tables, and on the card the captures
            replays = segments.replays
            with collectives.record() as tally:
                proofs[label], first = timed(lambda: fn(eng))
            replays = segments.replays - replays
            times = [first] + [timed(lambda: fn(eng))[1] for _ in range(runs - 1)]
            row[f"{label}_ms"] = statistics.median(times)
            row[f"{label}_ms_runs"] = times
            if label == "dist":
                row.update(tally_json(tally), replays=replays)
        require(proofs["single"] == proofs["dist"],
                f"the distributed {name} differs from the single engine's")
        out[name] = row
    _with_engine(rpsss.stark, DEFAULT)
    _with_engine(stark, DEFAULT)
    return out


TASKS: dict[str, Callable[..., dict]] = {
    "ntt_dist": task_ntt_dist,
    "engine_ops": task_engine_ops,
    "merkle": task_merkle,
    "sign": task_sign,
    "chain": task_chain,
    "rank_rng": task_rank_rng,
    "hybrid_sign": task_hybrid_sign,
    "dryrun": task_dryrun,
    "timed": task_timed,
}


def run_rank(rank: int, world_size: int, init_file: str, device: str,
             tasks: Sequence[tuple[str, dict]], out_dir: str) -> None:
    """One rank of :func:`dryrun_multichip`: join the group, run ``tasks``
    (names of :data:`TASKS` and their keyword arguments), write the results
    to ``out_dir/rank<r>.json`` (or the traceback to ``rank<r>.err``)."""
    torch.set_num_threads(1)
    out = pathlib.Path(out_dir)
    try:
        initialize(f"file://{init_file}", world_size, rank, device)
        results = []
        for name, kwargs in tasks:
            t0 = time.perf_counter()
            result = TASKS[name](device, **kwargs)
            result["seconds"] = time.perf_counter() - t0
            results.append(result)
        (out / f"rank{rank}.json").write_text(json.dumps(results))
    except Exception:
        (out / f"rank{rank}.err").write_text(traceback.format_exc())
        raise
    finally:
        shutdown()


def dryrun_multichip(world_size: int, device="cuda", tasks=None,
                     timeout: float = 600.0) -> list[list[dict]]:
    """Run ``tasks`` (default: the dry run) on ``world_size`` spawned
    ranks; returns each rank's results.  Raises with the ranks' tracebacks
    if one fails, or when the run outlasts ``timeout`` seconds (every rank
    is then stopped)."""
    device = torch.device(device)
    if device.type == "cuda" and torch.cuda.device_count() < world_size:
        raise RuntimeError(f"dryrun_multichip: {world_size} ranks need {world_size} cards, "
                           f"{torch.cuda.device_count()} present")
    tasks = list(tasks) if tasks is not None else [("dryrun", {})]
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        init_file = os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=run_rank,
                             args=(r, world_size, init_file, device.type, tasks, tmp))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            for p in procs:
                p.join(max(0.0, deadline - time.monotonic()))
        finally:
            stuck = [p for p in procs if p.is_alive()]
            for p in stuck:
                p.kill()
                p.join()
        errors = [pathlib.Path(tmp, f"rank{r}.err") for r in range(world_size)]
        failed = [e.read_text() for e in errors if e.exists()]
        if stuck or failed or any(p.exitcode != 0 for p in procs):
            raise RuntimeError(
                f"dryrun_multichip({world_size}): exit codes {[p.exitcode for p in procs]}"
                + (f", {len(stuck)} ranks stopped after {timeout} s" if stuck else "")
                + "".join(f"\n{tb}" for tb in failed))
        return [json.loads(pathlib.Path(tmp, f"rank{r}.json").read_text())
                for r in range(world_size)]


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("world_size", type=int)
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--fixtures", metavar="DIR",
                        help="also prove the signature and chain fixtures of DIR (meta.json, "
                             "signature.bin, chain_meta.json, chain_proof.bin) on every rank, "
                             "and from four ranks on a hybrid mesh of rows of two, each byte for "
                             "byte")
    parser.add_argument("--timed", type=int, metavar="CHAIN_LENGTH",
                        help="also time warm signs and chain proves of CHAIN_LENGTH, the single "
                             "engine against the distributed one (task_timed)")
    parser.add_argument("--timeout", type=float, default=600.0)
    args = parser.parse_args(argv)
    tasks, expect = [("dryrun", {})], [None]
    if args.fixtures:
        fixtures = pathlib.Path(args.fixtures)
        meta = json.loads((fixtures / "meta.json").read_text())
        chain_meta = json.loads((fixtures / "chain_meta.json").read_text())
        sign_args = {"config": meta["config"], "document": meta["document"],
                     "rng_tag": "zk-stark-fixture"}
        tasks += [("sign", sign_args),
                  ("chain", {"config": chain_meta["config"], "input_element": chain_meta["input"],
                             "rng_tag": chain_meta["rng_tag"]})]
        expect += [(fixtures / "signature.bin").read_bytes(),
                   (fixtures / "chain_proof.bin").read_bytes()]
        if args.world_size >= 4 and args.world_size % 2 == 0:
            tasks.append(("hybrid_sign", {"ici_parallelism": 2, **sign_args}))
            expect.append(expect[1])
    if args.timed:
        tasks.append(("timed", {"chain_length": args.timed}))
        expect.append(None)
    if args.device == "cuda":  # build once here, not in every rank
        from ..ops import _build

        _build.build(sorted({k.library for k in _build.Kernel.instances}))
    for rank, results in enumerate(dryrun_multichip(args.world_size, args.device, tasks,
                                                    args.timeout)):
        for (name, _), want, result in zip(tasks, expect, results):
            proof = result.pop("proof", None)
            if want is not None:
                require(bytes.fromhex(proof) == want, f"rank {rank}: the {name} proof differs "
                        "from its fixture")
                result["fixture"] = "reproduced"
            print(f"rank {rank} {name}: {json.dumps(result)}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
