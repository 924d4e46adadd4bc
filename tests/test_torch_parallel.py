"""The distributed prover of the port (``zk_stark_tpu_torch/parallel/``) on
the CPU: ranks are spawned processes joined by gloo.

The JAX package shards its prover over a virtual device mesh
(``tests/test_dist_prover.py``, ``test_collectives.py``,
``test_multihost.py``).  Here its pure host code (the four-step geometry,
which lengths are split, the host grid of a hybrid mesh) is held against
the port's, and its fixtures (made by the JAX package) are reproduced byte
for byte by the port's DistEngine on every rank.  Every cross-rank check
runs in one of two spawned runs: two ranks and four ranks.
"""

import json
import pathlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from zk_stark_tpu.parallel import engine as jax_engine
from zk_stark_tpu.parallel import multihost as jax_multihost
from zk_stark_tpu_torch import segments
from zk_stark_tpu_torch.carry import DetRng
from zk_stark_tpu_torch.ops import fold as FO
from zk_stark_tpu_torch.ops import limbs as L
from zk_stark_tpu_torch.parallel import collectives, multihost
from zk_stark_tpu_torch.parallel.dryrun import dryrun_multichip, prove_small, random_mont
from zk_stark_tpu_torch.parallel.engine import DEFAULT, DistEngine, combine_rows
from zk_stark_tpu_torch.parallel.mesh import block
from zk_stark_tpu_torch.parallel.ntt_dist import four_step_geometry

FIXTURES = pathlib.Path(__file__).parent / "fixtures"
META = json.loads((FIXTURES / "meta.json").read_text())
SIGNATURE = (FIXTURES / "signature.bin").read_bytes()
CHAIN_META = json.loads((FIXTURES / "chain_meta.json").read_text())
CHAIN_PROOF = (FIXTURES / "chain_proof.bin").read_bytes()

SIGN = ("sign", {"config": META["config"], "document": META["document"],
                 "rng_tag": "zk-stark-fixture"})
CHAIN = ("chain", {"config": CHAIN_META["config"], "input_element": CHAIN_META["input"],
                   "rng_tag": CHAIN_META["rng_tag"]})
RANK_RNG_TAG = "dist-rank-rng"
NTT_SIZES = (64, 512, 4096)
ENGINE_SIZES = (64, 512, 4096)
FOUR_RANK_ENGINE_SIZES = (64, 512)
MERKLE_SIZES = (64, 4096)
NONE = {"all_to_all": 0, "permute": 0, "all_gather": 0, "broadcast": 0}
#: every collective a DistEngine operation issues on blocks, by operation: a
#: transform three all-to-alls (natural rows to columns, the four-step's
#: own, columns to natural rows) and no all-gather; the inversion nothing;
#: the fold one permute (the pairs meet); the combination one permute a
#: shifted term (two of the check's three terms are shifted); a move one
#: permute, or one all-gather into a length too short to split
ENGINE_COLLECTIVES = {
    "ntt": {**NONE, "all_to_all": 3},
    "intt": {**NONE, "all_to_all": 3},
    "batch_inv": NONE,
    "fold_round": {**NONE, "permute": 1},
    "combine": {**NONE, "permute": 2},
    "move": {**NONE, "permute": 1},
    "move_whole": {**NONE, "all_gather": 1},
}


@pytest.fixture(scope="module")
def two_ranks():
    """One spawned run of two ranks: (per-rank results by task name)."""
    tasks = [
        ("ntt_dist", {"sizes": list(NTT_SIZES)}),
        ("engine_ops", {"sizes": list(ENGINE_SIZES)}),
        ("merkle", {"sizes": list(MERKLE_SIZES), "queries": 16}),
        SIGN,
        CHAIN,
        ("rank_rng", {"rng_tag": RANK_RNG_TAG}),
    ]
    results = dryrun_multichip(2, "cpu", tasks, timeout=300)
    return [dict(zip([name for name, _ in tasks], r)) for r in results]


@pytest.fixture(scope="module")
def four_ranks():
    """One spawned run of four ranks."""
    hybrid = ("hybrid_sign", {"ici_parallelism": 2, **SIGN[1]})
    tasks = [("engine_ops", {"sizes": list(FOUR_RANK_ENGINE_SIZES)}),
             ("merkle", {"sizes": list(MERKLE_SIZES), "queries": 16}), SIGN, CHAIN, hybrid]
    results = dryrun_multichip(4, "cpu", tasks, timeout=300)
    return [dict(zip([name for name, _ in tasks], r)) for r in results]


# -- host code against the JAX package ------------------------------------------


@pytest.mark.parametrize("n_dev", [1, 2, 4, 8])
def test_geometry_and_split_lengths_match_jax(n_dev):
    lengths = [1 << k for k in range(1, 25)] + [3, 6, 12, 100, 1000, 3 << 10]
    port, ref = SimpleNamespace(n_devices=n_dev), SimpleNamespace(n_devices=n_dev)
    for n in lengths:
        if n & (n - 1) == 0:
            assert four_step_geometry(n) == jax_engine._four_step_geometry(n), n
        assert DistEngine._distributable(port, n) == jax_engine.DistEngine._distributable(
            ref, n), (n, n_dev)


def test_device_grid_and_hybrid_layout_match_jax():
    fakes = [SimpleNamespace(process_index=p, id=4 * p + d)
             for p in (2, 0, 1, 3) for d in (3, 1, 0, 2)]
    ranks = [multihost.Rank(d.process_index, d.id) for d in fakes]
    grid = jax_multihost._device_grid(fakes)
    ids = np.vectorize(lambda d: d.id)(grid)
    assert multihost._device_grid(ranks) == ids.tolist()
    for ici in (1, 2, 4):
        want = ids.reshape(ids.shape[0] * (ids.shape[1] // ici), ici).tolist()
        assert multihost.hybrid_grid(ranks, ici) == want
    with pytest.raises(ValueError, match="uneven"):
        multihost._device_grid(ranks[:-1])
    with pytest.raises(ValueError, match="rows of 3"):
        multihost.hybrid_grid(ranks, 3)


def test_initialize_single_process_noop(monkeypatch):
    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(name, raising=False)
    assert multihost.initialize(device="cpu") is False
    assert not torch.distributed.is_initialized()


def test_dist_engine_raises_without_a_group():
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        DistEngine(1)


def test_backend_follows_the_device():
    collectives.require_backend(torch.device("cpu"), "gloo")
    collectives.require_backend(torch.device("cuda", 0), "nccl")
    with pytest.raises(ValueError, match="NCCL"):
        collectives.require_backend(torch.device("cuda", 0), "gloo")
    with pytest.raises(ValueError, match="gloo"):
        collectives.require_backend(torch.device("cpu"), "nccl")


# -- the split operations' host halves ------------------------------------------


@pytest.mark.parametrize("n_dev", [2, 3, 4])
def test_combination_blocks_make_the_whole(n_dev):
    """Each rank's rows of seg2's weighted combination, laid end to end,
    are the whole combination (the combination of DistEngine.combine)."""
    arrs = [random_mont(n, n, "cpu") for n in (37, 50, 50, 9)]
    shifts = [0, 0, 13, 70]
    w = random_mont(len(arrs), 5, "cpu")
    whole = DEFAULT.combine(w, arrs, shifts)
    assert whole.shape[0] == 79
    rows = -(-79 // n_dev)
    parts = [combine_rows(w, arrs, shifts, min(i * rows, 79), min((i + 1) * rows, 79))
             for i in range(n_dev)]
    assert torch.equal(torch.cat(parts), whole)


@pytest.mark.parametrize("n_dev", [1, 2, 4])
def test_fold_pairs_blocks_make_the_fold(n_dev):
    """Each rank's pairs folded apart (ops.fold.fold_pairs on its lo and hi
    slices) are the blocks of the whole round."""
    n, half = 64, 32
    cw = random_mont(n, 1, "cpu")
    invpows = random_mont(half, 2, "cpu")
    ao = random_mont(1, 3, "cpu")[0]
    two_inv = L.int_to_mont(pow(2, -1, L.P), "cpu")
    folded, canon = FO.fold_plain(cw, invpows, ao, two_inv)
    for i in range(n_dev):
        rows = block(half, n_dev, i)
        f, c = FO.fold_pairs(cw[rows], cw[half + rows.start : half + rows.stop],
                             invpows[rows], ao, two_inv)
        assert torch.equal(f, folded[rows]) and torch.equal(c, canon[rows])
    with pytest.raises(ValueError, match="differ"):
        FO.fold_pairs(cw[:4], cw[4:12], invpows[:4], ao, two_inv)


# -- two ranks -------------------------------------------------------------------


def test_ntt_dist_round_trips_with_one_all_to_all(two_ranks):
    """ntt_dist / intt_dist at 64, 512 and 4096 points with both twiddle
    strategies (checked in the ranks); the four-step issues one all-to-all
    and no all-gather."""
    for rank in two_ranks:
        for n in NTT_SIZES:
            got = rank["ntt_dist"][str(n)]
            assert (got["n1"], got["n2"]) == four_step_geometry(n)
            assert got["four_step_collectives"] == {**NONE, "all_to_all": 1}


def _engine_ops_issue_the_budget(ranks, sizes):
    for rank in ranks:
        assert rank["engine_ops"]["captures_segments"] is False  # gloo: eager segments
        for n in sizes:
            got = rank["engine_ops"][str(n)]
            assert {op: got[op]["collectives"] for op in got} == ENGINE_COLLECTIVES, n


def test_engine_ops_equal_single_engine(two_ranks):
    """DistEngine.ntt, intt, batch_inv, fold_round, combine and move on
    a rank's block equal the same rows of the single engine's output bit for
    bit (checked in the ranks) at 64, 512 and 4096 points, with the
    collectives pinned (:data:`ENGINE_COLLECTIVES`): no operation
    all-gathers."""
    _engine_ops_issue_the_budget(two_ranks, ENGINE_SIZES)


def test_engine_ops_on_four_ranks(four_ranks):
    _engine_ops_issue_the_budget(four_ranks, FOUR_RANK_ENGINE_SIZES)


@pytest.mark.parametrize("ranks", ["two_ranks", "four_ranks"])
def test_engine_ops_bytes_within_budget(ranks, request):
    """A transform of n points hands a rank 3 n/D rows (three all-to-alls of
    its block); the fold at most n/D (its lo and hi rows of the pairs), the
    combination at most the shifts' rows, a move at most its block."""
    results = request.getfixturevalue(ranks)
    d = len(results)
    for rank in results:
        for n in (ENGINE_SIZES if d == 2 else FOUR_RANK_ENGINE_SIZES):
            got = {op: r["received_bytes"] for op, r in rank["engine_ops"][str(n)].items()
                   if op != "captures_segments"}
            assert got["ntt"]["all_to_all"] == got["intt"]["all_to_all"] == 3 * n // d * 64
            assert got["fold_round"]["permute"] <= n // d * 64
            assert got["combine"]["permute"] <= (n // 8 + n // 2 + 3) * 64
            assert got["move"]["permute"] <= n // 2 // d * 64
            assert got["batch_inv"] == NONE


@pytest.mark.parametrize("ranks", ["two_ranks", "four_ranks"])
def test_blocked_merkle_tree_equals_whole(ranks, request):
    """A tree over each rank's block has the whole tree's root, leaves and
    openings (checked in the ranks): one all-gather of the subtree roots to
    build, one for a batch of openings."""
    for rank in request.getfixturevalue(ranks):
        for n in MERKLE_SIZES:
            got = rank["merkle"][str(n)]
            assert got["build"] == {**NONE, "all_gather": 1}
            assert got["openings"] == {**NONE, "all_gather": 1}


def test_shutdown_releases_collective_graphs():
    """A graph that holds NCCL collectives is dropped before its group ends
    (the group hangs on its destruction while one lives): the segment
    captures anew at its next call; without a group shutdown does nothing."""
    seg = segments.Segment("with-collectives", lambda: (), "cpu")
    seg.graph, seg.launches = object(), {"kernel": 1}
    segments._with_collectives.add(seg)
    segments.release_collective_graphs()
    assert seg.graph is None and seg.launches == {}
    assert not list(segments._with_collectives)
    assert not torch.distributed.is_initialized()
    multihost.shutdown()


def test_replays_count_captured_collectives():
    """A captured segment's collectives are kept apart from the counts and
    counted at each replay (the card's NCCL segments; here on host events)."""
    event = ("permute", (0, 1), 3, 192)
    before = collectives.counts()["permute"]
    with collectives.capturing() as captured:
        captured.events.append(event)
    assert collectives.counts()["permute"] == before
    with collectives.record() as seen:
        collectives.replay(captured)
        collectives.replay(captured)
    assert seen.counts() == {**NONE, "permute": 2}
    assert seen.received_bytes()["permute"] == 384 and seen.largest_rows()["permute"] == 3
    assert collectives.counts()["permute"] == before + 2


def test_signature_fixture_on_two_ranks(two_ranks):
    for rank in two_ranks:
        sign = rank["sign"]
        assert bytes.fromhex(sign["proof"]) == SIGNATURE
        assert (sign["sk"], sign["pk"]) == (META["sk"], META["pk"])
        assert sign["collectives"]["broadcast"] == 1  # the prover's random bytes


def test_rank_zero_draws_the_randomness(two_ranks):
    """Each rank's rng gives other bytes; every rank returns the proof of
    rank 0's rng."""
    assert DetRng(f"{RANK_RNG_TAG}-0".encode())(17) != DetRng(f"{RANK_RNG_TAG}-1".encode())(17)
    want = prove_small(DEFAULT, f"{RANK_RNG_TAG}-0", "cpu")["proof"]
    for rank in two_ranks:
        assert rank["rank_rng"]["proof"] == want


# -- four ranks ------------------------------------------------------------------


def test_chain_fixture_on_two_ranks(two_ranks):
    for rank in two_ranks:
        assert bytes.fromhex(rank["chain"]["proof"]) == CHAIN_PROOF


def test_signature_fixture_on_four_ranks(four_ranks):
    for rank in four_ranks:
        assert bytes.fromhex(rank["sign"]["proof"]) == SIGNATURE


def test_chain_prove_gathers_no_codeword(four_ranks):
    """In the 4-rank chain prove (FRI 2^14) no all-gather hands a rank 2^14/4
    rows or more but the last FRI codeword's, and no collective of any kind
    hands it a whole FRI-domain codeword."""
    for rank in four_ranks:
        chain = rank["chain"]
        fri_dl = chain["fri_domain_length"]
        assert fri_dl == 1 << 14
        big = [r for r in chain["all_gather_rows"] if r >= fri_dl // 4]
        assert big in ([], [chain["last_codeword_rows"]]), big
        assert chain["last_codeword_rows"] in chain["all_gather_rows"]
        assert max(chain["largest_rows"].values()) < fri_dl


def test_chain_fixture_on_four_ranks(four_ranks):
    """The chain fixture (chain 25, FRI 2^14: n1 = n2 = 128, a quarter of
    each transform a rank)."""
    for rank in four_ranks:
        assert bytes.fromhex(rank["chain"]["proof"]) == CHAIN_PROOF
        assert rank["chain"]["collectives"]["all_to_all"] > 0


def test_hybrid_rows_prove_apart(four_ranks):
    """A 2 x 2 hybrid mesh: each row's engine reproduces the signature, and
    every collective of a row's proof stays in its row."""
    rows = {}
    for rank, result in enumerate(four_ranks):
        hybrid = result["hybrid_sign"]
        assert bytes.fromhex(hybrid["proof"]) == SIGNATURE
        assert hybrid["row"] == rank // 2 and hybrid["row_ranks"] == [rank // 2 * 2,
                                                                     rank // 2 * 2 + 1]
        assert hybrid["groups"] == [hybrid["row_ranks"]]
        rows.setdefault(hybrid["row"], set()).add(rank)
    assert rows == {0: {0, 1}, 1: {2, 3}}
