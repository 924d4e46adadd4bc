"""Every input of a run, drawn from its seed.

The client makes its inputs here and the parent hands the same ones to
the reference, so only the seed and a request's number cross between
processes.
"""

from __future__ import annotations

import hashlib
import random


def derive(seed: int, *labels, nbytes: int = 32) -> bytes:
    """Bytes that depend on the seed and the labels alone."""
    text = "|".join(["starkbench", str(seed), *map(str, labels)])
    return hashlib.shake_256(text.encode()).digest(nbytes)


def derive_int(seed: int, *labels, bits: int = 63) -> int:
    return int.from_bytes(derive(seed, *labels, nbytes=(bits + 7) // 8), "big") >> (-bits % 8)


class SeededRng:
    """The prover's source of random bytes (its ``rng=``), from the seed:
    buffered, so that a draw costs about what ``os.urandom`` does."""

    def __init__(self, seed: int, *labels):
        self._random = random.Random(derive_int(seed, "rng", *labels, bits=256))
        self._buf = b""
        self._pos = 0

    def __call__(self, n: int) -> bytes:
        if self._pos + n > len(self._buf):
            self._buf = self._buf[self._pos:] + self._random.randbytes(max(1 << 20, n))
            self._pos = 0
        out = self._buf[self._pos:self._pos + n]
        self._pos += n
        return out


def draw_sample(seed: int, kept: list[int], size: int) -> list[int]:
    """``size`` request numbers, drawn from the seed without replacement
    among those the client still holds."""
    rng = random.Random(derive_int(seed, "sample"))
    return sorted(rng.sample(sorted(kept), min(size, len(kept))))


class Reservoir(dict):
    """At most ``size`` of a stream's answers, by their request numbers:
    each answer offered is kept with the same chance, drawn from the seed
    (reservoir sampling), so a client holds a bounded sample."""

    def __init__(self, size: int, seed: int, *labels):
        super().__init__()
        self.size = size
        self._random = random.Random(derive_int(seed, "reservoir", *labels))

    def offer(self, k: int, answer) -> None:
        if len(self) < self.size:
            self[k] = answer
        elif (j := self._random.randrange(k + 1)) < self.size:
            del self[sorted(self)[j]]
            self[k] = answer
