"""Rescue-Prime (Rescue-XLIX) over GF(p): its parameters, one round, the
hash of one element, and the iterated permutation chain."""

from __future__ import annotations

import hashlib

from .field import P, smallest_generator


def _rref(matrix: list[list[int]]) -> None:
    """Reduced row echelon form mod p, in place."""
    lead, rows, cols = 0, len(matrix), len(matrix[0])
    for r in range(rows):
        if cols <= lead:
            return
        i = r
        while matrix[i][lead] % P == 0:
            i += 1
            if i == rows:
                i, lead = r, lead + 1
                if lead == cols:
                    return
        matrix[i], matrix[r] = matrix[r], matrix[i]
        inv = pow(matrix[r][lead], -1, P)
        matrix[r] = [v * inv % P for v in matrix[r]]
        for i in range(rows):
            if i != r:
                hold = matrix[i][lead]
                matrix[i] = [(a - hold * b) % P for a, b in zip(matrix[i], matrix[r])]
        lead += 1


def _inverse(matrix: list[list[int]]) -> list[list[int]]:
    n = len(matrix)
    aug = [list(row) + [int(i == j) for j in range(n)] for i, row in enumerate(matrix)]
    _rref(aug)
    if any(row[:n] != [int(i == j) for j in range(n)] for i, row in enumerate(aug)):
        raise ValueError("singular matrix")
    return [row[n:] for row in aug]


class Rescue:
    """Rescue-Prime with state width m, capacity, security level and N
    rounds: the S-box exponent alpha, its inverse, the systematic
    Vandermonde MDS matrix and SHAKE-256 round constants."""

    def __init__(self, m: int = 2, capacity: int = 1, security_level: int = 128, N: int = 27):
        self.m, self.capacity, self.N = m, capacity, N
        self.alpha = smallest_generator()
        # the inverse of p - alpha mod p, as the published parameters take
        # it; for this p it is also alpha's inverse mod p - 1
        self.alpha_inv = pow((-self.alpha) % P, -1, P)
        vandermonde = [[pow(self.alpha, i * j, P) for j in range(2 * m)] for i in range(m)]
        _rref(vandermonde)
        self.mds = [list(col) for col in zip(*[row[m:] for row in vandermonde])]
        self.mds_inv = _inverse(self.mds)
        bytes_per_int = (P.bit_length() + 7) // 8 + 1
        seed = f"Rescue-XLIX({P},{m},{capacity},{security_level})".encode()
        data = hashlib.shake_256(seed).digest(bytes_per_int * 2 * m * N)
        self.round_constants = [
            sum(pow(256, j, P) * b for j, b in enumerate(data[bytes_per_int * i:bytes_per_int * (i + 1)])) % P
            for i in range(2 * m * N)
        ]

    def round(self, state: list[int], r: int) -> list[int]:
        m, rc = self.m, self.round_constants
        state = [pow(s, self.alpha, P) for s in state]
        state = [(sum(self.mds[j][k] * state[k] for k in range(m)) + rc[2 * r * m + j]) % P
                 for j in range(m)]
        state = [pow(s, self.alpha_inv, P) for s in state]
        return [(sum(self.mds[j][k] * state[k] for k in range(m)) + rc[2 * r * m + m + j]) % P
                for j in range(m)]

    def hash(self, x: int) -> int:
        """One element absorbed into register 0, N rounds, register 0."""
        state = [x % P] + [0] * (self.m - 1)
        for r in range(self.N):
            state = self.round(state, r)
        return state[0]

    def chain_output(self, x: int, num_rounds: int) -> int:
        """Register 0 after ``num_rounds`` rounds from (x, 0, ...), the round
        constants cycling with period N: the chain's public output."""
        state = [x % P] + [0] * (self.m - 1)
        for i in range(num_rounds):
            state = self.round(state, i % self.N)
        return state[0]

    def constant_column(self, half: int, j: int, r: int) -> int:
        """The round constant that step ``r`` adds to register ``j``, before
        (half 0) or after (half 1) the inverse S-box."""
        return self.round_constants[2 * (r % self.N) * self.m + half * self.m + j]
