"""The port's BLAKE2b Merkle trees: leaf digests against hashlib, root and
paths against the JAX package's host tree (tree_from_canonical_limbs), on
the CPU."""

import hashlib
import random

import numpy as np
import pytest
import torch

from zk_stark_tpu import merkle as jax_merkle
from zk_stark_tpu_torch import merkle
from zk_stark_tpu_torch.field import FIELD_PRIME as P
from zk_stark_tpu_torch.ops import blake2b as B
from zk_stark_tpu_torch.ops import limbs as L


def _digest(data: bytes) -> bytes:
    return hashlib.blake2b(data, digest_size=64).digest()


def test_leaf_digest_parity():
    random.seed(7)  # the values of tests/test_merkle_device.py
    vals = [0, 1, 9, 10, 99, 100, P - 1, 10**38, 10**38 - 1, 10**37] + [
        random.randrange(P) for _ in range(246)
    ]
    got = B.leaf_digests(L.from_numpy(L.ints_to_limbs(vals), "cpu"))
    assert got.dtype == torch.uint8 and tuple(got.shape) == (len(vals), 64)
    for v, row in zip(vals, got):
        assert row.numpy().tobytes() == _digest(str(v).encode())


def test_node_digest_parity():
    rng = np.random.default_rng(3)
    level = torch.from_numpy(rng.integers(0, 256, size=(16, 64), dtype=np.uint8))
    got = B.node_digests(level)
    for i in range(8):
        pair = level[2 * i].numpy().tobytes() + level[2 * i + 1].numpy().tobytes()
        assert got[i].numpy().tobytes() == _digest(pair)


@pytest.mark.parametrize("log2n", range(12))
def test_tree_plain_matches_host_layers(log2n):
    """The tree entry point on the CPU (the per-level plain loop) gives the
    host MerkleTree's layers, as views of one [n - 1, 64] buffer, for 1 ...
    2^11 leaves; the card's launch plan covers every level once."""
    n = 1 << log2n
    random.seed(log2n)
    vals = [random.randrange(P) for _ in range(n)]
    leaves = B.leaf_digests(L.from_numpy(L.ints_to_limbs(vals), "cpu"))
    inner = B.tree_digests(leaves)
    assert inner.dtype == torch.uint8 and tuple(inner.shape) == (n - 1, 64)
    levels = B.split_levels(leaves, inner)
    assert [tuple(lvl.shape) for lvl in levels] == [(n >> j, 64) for j in range(log2n + 1)]
    assert all(lvl.data_ptr() == inner[B.level_start(n, j)].data_ptr()
               for j, lvl in enumerate(levels[1:], 1))
    assert [[bytes(row) for row in lvl.numpy()] for lvl in levels] == (
        merkle.MerkleTree.from_ints(vals).layers)
    launches = B.tree_launches(n)
    assert [lvl for lvl, _ in launches] == [sum(k for _, k in launches[:i])
                                            for i in range(len(launches))]
    assert sum(k for _, k in launches) == log2n
    assert len(launches) == -(-log2n // B.TREE_LEVELS)
    assert all(0 < k <= B.TREE_LEVELS for _, k in launches)


def test_tree_launches_at_the_paths_sizes():
    """Two launches for a 2^20-leaf tree (ten levels each) and for a sign's
    4096-leaf trees (six each); one up to 2^10 leaves."""
    assert B.tree_launches(1 << 20) == [(0, 10), (10, 10)]
    assert B.tree_launches(1 << 12) == [(0, 6), (6, 6)]
    assert B.tree_launches(1 << 19) == [(0, 10), (10, 9)]
    assert B.tree_launches(1 << 10) == [(0, 10)]
    assert B.tree_launches(2) == [(0, 1)]
    assert B.tree_launches(1) == []


@pytest.fixture(scope="module")
def trees():
    random.seed(8)
    vals = [random.randrange(P) for _ in range(1024)]
    limbs = L.ints_to_limbs(vals)
    port = merkle.DeviceMerkleTree(L.from_numpy(limbs, "cpu"))
    ref = jax_merkle.tree_from_canonical_limbs(limbs.astype(np.uint32))
    return vals, port, ref


def test_root_and_paths_match_jax_tree(trees):
    vals, port, ref = trees
    assert port.root == ref.root
    # the inner levels are views of one buffer, each [m, 64] in natural order
    storage = port.levels[1].untyped_storage().data_ptr()
    assert all(lvl.untyped_storage().data_ptr() == storage for lvl in port.levels[2:])
    assert [tuple(lvl.shape) for lvl in port.levels] == [(1024 >> j, 64) for j in range(11)]
    assert port.root == merkle.MerkleTree.from_ints(vals).root
    idx = [0, 1, 2, 511, 512, 1000, 1023, 5]
    [(values, paths)] = merkle.open_many([(port, idx)])
    assert values == [vals[i] for i in idx]
    for i, path in zip(idx, paths):
        assert path == ref.open(i)
        assert merkle.verify_int(port.root, i, path, vals[i])
        assert jax_merkle.verify_int(port.root, i, path, vals[i])
        assert not merkle.verify_int(port.root, i, path, (vals[i] + 1) % P)


def test_open_many_over_several_trees(trees):
    vals, port, _ = trees
    small_vals = vals[:4]
    small = merkle.DeviceMerkleTree(L.from_numpy(L.ints_to_limbs(small_vals), "cpu"))
    single = merkle.DeviceMerkleTree(L.from_numpy(L.ints_to_limbs(vals[:1]), "cpu"))
    assert single.root == _digest(str(vals[0]).encode())
    out = merkle.open_many([(port, [3, 4]), (small, [2]), (single, [0])])
    host = merkle.MerkleTree.from_ints(small_vals)
    assert out[0][0] == [vals[3], vals[4]]
    assert out[1] == ([small_vals[2]], [host.open(2)])
    assert out[2] == ([vals[0]], [[]])
    assert small.all_values() == small_vals


def test_kernel_wrappers_refuse_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA tensor"):
        B.leaf_kernel(L.from_numpy(L.ints_to_limbs([1, 2]), "cpu"))
    with pytest.raises(ValueError, match="CUDA tensor"):
        B.node_kernel(torch.zeros((2, 64), dtype=torch.uint8))
    with pytest.raises(ValueError, match="CUDA tensor"):
        B.tree_kernel(torch.zeros((4, 64), dtype=torch.uint8))
    with pytest.raises(ValueError, match="power of two"):
        B.tree_kernel(torch.zeros((6, 64), dtype=torch.uint8))


def test_tree_openings_match_open_many_and_the_host_tree(trees):
    """DeviceMerkleTree.openings / paths / values_at / open: one tree's
    queries, as open_many gives them and as the JAX package's host tree
    opens them."""
    vals, port, ref = trees
    idx = [7, 0, 1023, 512]
    values, paths = port.openings(idx)
    assert (values, paths) == merkle.open_many([(port, idx)])[0]
    assert port.values_at(idx) == values == [vals[i] for i in idx]
    assert port.paths(idx) == paths == [ref.open(i) for i in idx]
    assert port.open(5) == ref.open(5)


def test_commit_and_open_ints_match_jax():
    random.seed(9)
    vals = [0, 1, P - 1, P - 2] + [random.randrange(P) for _ in range(12)]
    leaves = [str(v).encode() for v in vals]
    assert merkle.commit(leaves) == jax_merkle.commit(leaves) == merkle.commit_ints(vals)
    for i in (0, 3, 15):
        assert merkle.open_ints(i, vals) == jax_merkle.open_ints(i, vals)
