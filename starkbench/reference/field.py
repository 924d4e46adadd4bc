"""GF(p), p = 1 + 407 * 2^119, on Python ints."""

from __future__ import annotations

from math import gcd

P = 1 + 407 * (1 << 119)
#: generator of the subgroup of order 2^119, also the FRI coset's offset
GENERATOR = 85408008396924667383611388730472331217
#: the inverse of the Montgomery radix 2^128 of a value held as 8 limbs
#: of 16 bits
R_INV = pow(1 << 128, -1, P)


def primitive_root(n: int) -> int:
    """A primitive n-th root of unity, n a power of two up to 2^119."""
    if n & (n - 1) or not 0 < n <= 1 << 119:
        raise ValueError(f"no primitive root of order {n}")
    root, order = GENERATOR, 1 << 119
    while order != n:
        root = root * root % P
        order //= 2
    return root


def smallest_generator() -> int:
    """The smallest k >= 3 coprime to p - 1 (the S-box exponent)."""
    k = 3
    while gcd(k, P - 1) != 1:
        k += 1
    return k


def sample(data: bytes) -> int:
    """Hash-to-field: the bytes big-endian, kept to 128 bits, mod p."""
    return int.from_bytes(data, "big") % (1 << 128) % P


def batch_inverse(values: list[int]) -> list[int]:
    """The inverse of every value (none may be 0), with one exponentiation."""
    prefix, acc = [], 1
    for v in values:
        prefix.append(acc)
        acc = acc * v % P
    inv = pow(acc, P - 2, P)
    out = [0] * len(values)
    for i in range(len(values) - 1, -1, -1):
        out[i] = inv * prefix[i] % P
        inv = inv * values[i] % P
    return out


def from_montgomery(v: int) -> int:
    return v * R_INV % P
