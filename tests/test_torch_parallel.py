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
RANK_RNG_TAG = "dist-rank-rng"
NTT_SIZES = (64, 512, 4096)
ENGINE_SIZES = (64, 512)
#: every collective count a DistEngine operation may issue, by operation
ENGINE_COLLECTIVES = {
    "ntt": {"all_to_all": 1, "all_gather": 1, "broadcast": 0},
    "intt": {"all_to_all": 1, "all_gather": 1, "broadcast": 0},
    "batch_inv": {"all_to_all": 0, "all_gather": 1, "broadcast": 0},
    "fold_round": {"all_to_all": 0, "all_gather": 1, "broadcast": 0},
}


@pytest.fixture(scope="module")
def two_ranks():
    """One spawned run of two ranks: (per-rank results by task name)."""
    tasks = [
        ("ntt_dist", {"sizes": list(NTT_SIZES)}),
        ("engine_ops", {"sizes": list(ENGINE_SIZES)}),
        SIGN,
        ("rank_rng", {"rng_tag": RANK_RNG_TAG}),
    ]
    results = dryrun_multichip(2, "cpu", tasks, timeout=300)
    return [dict(zip([name for name, _ in tasks], r)) for r in results]


@pytest.fixture(scope="module")
def four_ranks():
    """One spawned run of four ranks."""
    chain = ("chain", {"config": CHAIN_META["config"], "input_element": CHAIN_META["input"],
                       "rng_tag": CHAIN_META["rng_tag"]})
    hybrid = ("hybrid_sign", {"ici_parallelism": 2, **SIGN[1]})
    tasks = [SIGN, chain, hybrid]
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
            assert got["four_step_collectives"] == {"all_to_all": 1, "all_gather": 0,
                                                    "broadcast": 0}


def test_engine_ops_equal_single_engine(two_ranks):
    """DistEngine.ntt, intt, batch_inv and fold_round equal the single
    engine bit for bit (checked in the ranks) with the collectives pinned:
    a transform one all-to-all and one all-gather, the inversion and the
    fold one all-gather."""
    for rank in two_ranks:
        for n in ENGINE_SIZES:
            assert rank["engine_ops"][str(n)] == ENGINE_COLLECTIVES


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


def test_signature_fixture_on_four_ranks(four_ranks):
    for rank in four_ranks:
        assert bytes.fromhex(rank["sign"]["proof"]) == SIGNATURE


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
