"""Merkle commitments over BLAKE2b-512.

Same bytes as the JAX package's ``merkle.py``: a leaf hashes the decimal
string of a field element, an inner node ``blake2b512(left + right)``, and
a one-leaf tree's root is the leaf hash.

:class:`DeviceMerkleTree` builds every level on the device of its codeword
(the leaf kernel and a few launches of the node kernel on the card), in
natural order, so the sibling of node ``i`` at every level is ``i ^ 1``.
Only the 64-byte root crosses to the host when the tree is built;
:func:`open_many` gathers the values and sibling paths of many queries on
the device and brings them back with one copy.  Under a distributed engine
a tree over a rank's block of leaves shares its subtree root with the
other ranks (:class:`DeviceMerkleTree`).  The host
:class:`MerkleTree` and :func:`verify_int` serve the verifier.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .ops import blake2b
from .ops import limbs as L
from .parallel import collectives
from .utils.hashing import blake2b512


def leaf_bytes_from_int(value: int) -> bytes:
    """Protocol leaf encoding of a field element: decimal string bytes."""
    return str(value).encode()


class DeviceMerkleTree:
    """Merkle tree over a canonical (non-Montgomery) codeword [n, 8], n a
    power of two, hashed on the codeword's device.

    ``levels[0]`` holds the leaf digests, ``levels[-1]`` the root of the
    tree the rank built, each a ``uint8[m, 64]`` tensor in natural order;
    the inner levels are views of one buffer (``blake2b.tree_digests``).

    Under a distributed engine (``parallel/engine.py``) whose blocks split
    the length n, ``canon`` is the rank's block: the rank hashes its leaves
    and builds its subtree, one all-gather shares the D subtree roots (D x
    64 bytes), and every rank hashes the top log2(D) levels (``top``) to the
    same root.  :func:`open_many` then takes each index's value and lower
    path from the rank that owns it and the top of its path from ``top``.
    """

    __slots__ = ("n", "canon", "levels", "root", "engine", "top")

    def __init__(self, canon: torch.Tensor, n: int | None = None, engine=None):
        n = int(canon.shape[0]) if n is None else n
        assert n >= 1 and n & (n - 1) == 0, "leaf count must be a power of two"
        self.n = n
        self.canon = canon
        #: the distributed engine that holds the leaves in blocks, or None
        self.engine = engine if engine is not None and engine.splits(n) else None
        leaves = blake2b.leaf_digests(canon)
        self.levels = blake2b.split_levels(leaves, blake2b.tree_digests(leaves))
        self.top = None
        root = self.levels[-1]
        if self.engine is not None:
            roots = collectives.all_gather(root, self.engine.group)
            self.top = blake2b.split_levels(roots, blake2b.tree_digests(roots))
            root = self.top[-1]
        self.root = root[0].cpu().numpy().tobytes()

    def openings(self, indices: Sequence[int]) -> tuple[list[int], list[list[bytes]]]:
        """(values, sibling paths) at ``indices``: one gather, one copy."""
        return open_many([(self, indices)])[0]

    def paths(self, indices: Sequence[int]) -> list[list[bytes]]:
        return self.openings(indices)[1]

    def open(self, index: int) -> list[bytes]:
        return self.paths([index])[0]

    def values_at(self, indices: Sequence[int]) -> list[int]:
        return self.openings(indices)[0]

    def all_values(self) -> list[int]:
        """Every leaf's value (gathered from the ranks when in blocks)."""
        canon = self.canon if self.engine is None else self.engine.gather(self.canon, self.n)
        return [int(v) for v in L.limbs_to_ints(canon)]


def open_many(specs) -> list[tuple[list[int], list[list[bytes]]]]:
    """Open many (tree, indices) queries: every value and sibling digest is
    gathered on the trees' device and comes back in one copy.  The values
    and lower paths of trees held in blocks come from the ranks that own
    their indices, each rank contributing its own rows to one all-gather
    for every such tree.  Returns, per
    spec, the values and the bottom-up sibling paths."""
    if not specs:
        return []
    device = specs[0][0].canon.device
    # every row the openings read, in their order: (source uint8[m, 64],
    # slot of its indices, owned); an owned piece's rows come from the
    # ranks that own its indices, each rank reading only its own
    host, pieces, owned_at = [], [], []

    def piece(source, idx, owned=False):
        host.append(np.asarray(idx, dtype=np.int64))
        pieces.append((source, len(host) - 1, owned))

    def values_of(tree):
        return lambda i: tree.canon[i].contiguous().view(torch.uint8).reshape(-1, 64)

    def rows_of(level):
        return lambda i: level[i]

    engine, packed = None, None
    for tree, indices in specs:
        idx = np.asarray(list(indices), dtype=np.int64)
        if tree.engine is None:
            piece(values_of(tree), idx)
            for lvl in range(len(tree.levels) - 1):
                piece(rows_of(tree.levels[lvl]), (idx >> lvl) ^ 1)
            continue
        engine = tree.engine
        if packed is None:  # rows each rank contributes so far
            packed = np.zeros(engine.n_devices, dtype=np.int64)
        size = tree.n // engine.n_devices
        owner = idx // size
        local = idx - owner * size
        # where each index's row lies among its owner's rows of one piece
        within = np.zeros(len(idx), dtype=np.int64)
        for q in range(engine.n_devices):
            within[owner == q] = np.arange(int((owner == q).sum()))
        mine = local[owner == engine.index]
        lower = len(tree.levels) - 1
        for lvl in range(-1, lower):  # the value, then the lower siblings
            owned_at.append((owner, packed[owner] + within))
            packed += np.bincount(owner, minlength=engine.n_devices)
            piece(values_of(tree) if lvl < 0 else rows_of(tree.levels[lvl]),
                  mine if lvl < 0 else (mine >> lvl) ^ 1, owned=True)
        for lvl in range(len(tree.top) - 1):
            piece(rows_of(tree.top[lvl]), (idx >> (lower + lvl)) ^ 1)
    if owned_at:  # the owned rows' places in the all-gather's result
        width = int(packed.max())
        host.append(np.concatenate([q * width + at for q, at in owned_at]))
    all_idx = torch.from_numpy(np.concatenate(host)).to(device)  # the single upload
    offsets = np.cumsum([0] + [len(h) for h in host])

    def slot(j):
        return all_idx[offsets[j] : offsets[j + 1]]

    rows = [source(slot(j)) for source, j, _ in pieces]
    if owned_at:
        mine = torch.cat([r for r, (_, _, owned) in zip(rows, pieces) if owned])
        mine = torch.cat([mine, mine.new_zeros((width - mine.shape[0], 64))])
        picked = collectives.all_gather(mine, engine.group)[slot(len(host) - 1)]
        taken = iter(picked.split([len(at) for _, at in owned_at]))
        rows = [next(taken) if owned else r for r, (_, _, owned) in zip(rows, pieces)]
    flat = torch.cat([r.reshape(-1) for r in rows]).cpu().numpy()  # the single device->host copy

    results, pos = [], 0
    for tree, indices in specs:
        k = len(indices)
        nlev = tree.n.bit_length() - 1
        limbs = flat[pos : pos + 64 * k].view(np.int64).reshape(k, L.NLIMB)
        pos += 64 * k
        values = [int(v) for v in L.limbs_to_ints(limbs)]
        per_level = []
        for _ in range(nlev):
            mat = flat[pos : pos + 64 * k].reshape(k, 64)
            pos += 64 * k
            per_level.append([mat[j].tobytes() for j in range(k)])
        paths = [[per_level[lvl][j] for lvl in range(nlev)] for j in range(k)]
        results.append((values, paths))
    return results


class MerkleTree:
    """Host layered Merkle tree over pre-encoded leaf byte strings."""

    __slots__ = ("layers",)

    def __init__(self, leaf_data: Sequence[bytes]):
        n = len(leaf_data)
        assert n > 0 and n & (n - 1) == 0, "leaf count must be a power of two"
        level = [blake2b512(d) for d in leaf_data]
        layers = [level]
        while len(level) > 1:
            level = [
                blake2b512(level[i] + level[i + 1])
                for i in range(0, len(level), 2)
            ]
            layers.append(level)
        self.layers = layers

    @classmethod
    def from_ints(cls, values: Sequence[int]) -> "MerkleTree":
        return cls([leaf_bytes_from_int(v) for v in values])

    @property
    def root(self) -> bytes:
        return self.layers[-1][0]

    def open(self, index: int) -> list[bytes]:
        """Sibling path bottom-up."""
        n = len(self.layers[0])
        assert 0 <= index < n, "cannot open invalid index"
        path = []
        for level in self.layers[:-1]:
            path.append(level[index ^ 1])
            index >>= 1
        return path


def commit(leaf_data: Sequence[bytes]) -> bytes:
    return MerkleTree(leaf_data).root


def commit_ints(values: Sequence[int]) -> bytes:
    return MerkleTree.from_ints(values).root


def open_ints(index: int, values: Sequence[int]) -> list[bytes]:
    return MerkleTree.from_ints(values).open(index)


def verify(root: bytes, index: int, path: Sequence[bytes], leaf_data: bytes) -> bool:
    """Recompute the root from a leaf and its sibling path."""
    assert index < (1 << len(path)), "cannot verify invalid index"
    node = blake2b512(leaf_data)
    for sibling in path:
        if index % 2 == 0:
            node = blake2b512(node + sibling)
        else:
            node = blake2b512(sibling + node)
        index >>= 1
    return node == root


def verify_int(root: bytes, index: int, path: Sequence[bytes], value: int) -> bool:
    return verify(root, index, path, leaf_bytes_from_int(value))
