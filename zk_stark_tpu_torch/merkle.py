"""Merkle commitments over BLAKE2b-512.

Same bytes as the JAX package's ``merkle.py``: a leaf hashes the decimal
string of a field element, an inner node ``blake2b512(left + right)``, and
a one-leaf tree's root is the leaf hash.

:class:`DeviceMerkleTree` builds every level on the device of its codeword
(the leaf kernel and a few launches of the node kernel on the card), in
natural order, so the sibling of node ``i`` at every level is ``i ^ 1``.
Only the 64-byte root crosses to the host when the tree is built;
:func:`open_many` gathers the values and sibling paths of many queries on
the device and brings them back with one copy.  The host
:class:`MerkleTree` and :func:`verify_int` serve the verifier.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .ops import blake2b
from .ops import limbs as L
from .utils.hashing import blake2b512


def leaf_bytes_from_int(value: int) -> bytes:
    """Protocol leaf encoding of a field element: decimal string bytes."""
    return str(value).encode()


class DeviceMerkleTree:
    """Merkle tree over a canonical (non-Montgomery) codeword [n, 8], n a
    power of two, hashed on the codeword's device.

    ``levels[0]`` holds the n leaf digests, ``levels[-1]`` the root, each a
    ``uint8[m, 64]`` tensor in natural order; the inner levels are views of
    one ``[n - 1, 64]`` buffer (``blake2b.tree_digests``).
    """

    __slots__ = ("n", "canon", "levels", "root")

    def __init__(self, canon: torch.Tensor):
        n = int(canon.shape[0])
        assert n >= 1 and n & (n - 1) == 0, "leaf count must be a power of two"
        self.n = n
        self.canon = canon
        leaves = blake2b.leaf_digests(canon)
        self.levels = blake2b.split_levels(leaves, blake2b.tree_digests(leaves))
        self.root = self.levels[-1][0].cpu().numpy().tobytes()

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
        return [int(v) for v in L.limbs_to_ints(self.canon)]


def open_many(specs) -> list[tuple[list[int], list[list[bytes]]]]:
    """Open many (tree, indices) queries: every value and sibling digest is
    gathered on the trees' device and comes back in one copy.  Returns, per
    spec, the values and the bottom-up sibling paths."""
    if not specs:
        return []
    device = specs[0][0].canon.device
    flat_idx, parts = [], []
    for tree, indices in specs:
        idx = np.asarray(list(indices), dtype=np.int64)
        nlev = len(tree.levels) - 1
        flat_idx.append(idx)
        flat_idx.extend((idx >> lvl) ^ 1 for lvl in range(nlev))
    all_idx = torch.from_numpy(np.concatenate(flat_idx)).to(device)

    off = 0
    for tree, indices in specs:
        k = len(indices)
        nlev = len(tree.levels) - 1
        idx = all_idx[off : off + k]
        off += k
        # int64 limbs as their 8 little-endian bytes each
        parts.append(tree.canon[idx].contiguous().view(torch.uint8).reshape(-1))
        for lvl in range(nlev):
            sib = all_idx[off : off + k]
            off += k
            parts.append(tree.levels[lvl][sib].reshape(-1))
    flat = torch.cat(parts).cpu().numpy()  # the single device->host copy

    results, pos = [], 0
    for tree, indices in specs:
        k = len(indices)
        nlev = len(tree.levels) - 1
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
