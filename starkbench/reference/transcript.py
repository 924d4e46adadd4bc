"""A proof's wire format, read item by item, and its Fiat-Shamir challenges.

A proof is a 16-byte big-endian header (p, or 0 while no item carries a
field element) and records ``code (1 byte) || size (8 bytes, big-endian)
|| payload``.  The codes: 0 a Merkle root (raw bytes), 1 a codeword and 3
three leaves (16-byte big-endian elements), 2 a Merkle path (each entry
its 8-byte size and its bytes), 4 one element.  A verifier's challenge
after k items is SHAKE-256 over the header of those k items and their
records, behind ``8-byte size || blake2b-512(document)`` for a signature.
"""

from __future__ import annotations

import hashlib

from .field import P

ROOT, CODEWORD, PATH, LEAFS, VALUE = range(5)


class Reject(Exception):
    """The proof is not accepted; the message says why."""


def _elements(payload: bytes) -> list[int]:
    if len(payload) % 16:
        raise Reject("element payload not a multiple of 16 bytes")
    out = [int.from_bytes(payload[i:i + 16], "big") for i in range(0, len(payload), 16)]
    if any(v >= P for v in out):
        raise Reject("element not reduced mod p")
    return out


class Transcript:
    def __init__(self, data: bytes, document: bytes | None = None):
        if len(data) < 16:
            raise Reject("proof shorter than its header")
        header = int.from_bytes(data[:16], "big")
        if header not in (0, P):
            raise Reject("header names another field")
        self.data = data
        self.fs_prefix = b""
        if document is not None:
            digest = hashlib.blake2b(document, digest_size=64).digest()
            self.fs_prefix = len(digest).to_bytes(8, "big") + digest
        #: (code, payload start, payload end) of every record
        self.records: list[tuple[int, int, int]] = []
        pos = 16
        while pos < len(data):
            if pos + 9 > len(data):
                raise Reject("truncated record header")
            code = data[pos]
            size = int.from_bytes(data[pos + 1:pos + 9], "big")
            start, pos = pos + 9, pos + 9 + size
            if pos > len(data):
                raise Reject("record overruns the proof")
            if code > VALUE:
                raise Reject(f"unknown item code {code}")
            self.records.append((code, start, pos))
        carrying = [k for k, (code, s, e) in enumerate(self.records)
                    if code in (LEAFS, VALUE) or (code == CODEWORD and e > s)]
        self.first_carrying = carrying[0] if carrying else len(self.records)
        if header != (P if carrying else 0):
            raise Reject("header does not match the items")
        self.read = 0

    def _pull(self, code: int) -> bytes:
        if self.read >= len(self.records):
            raise Reject("proof ends early")
        got, start, end = self.records[self.read]
        if got != code:
            raise Reject(f"item {self.read} has code {got}, expected {code}")
        self.read += 1
        return self.data[start:end]

    def root(self) -> bytes:
        return self._pull(ROOT)

    def codeword(self) -> list[int]:
        return _elements(self._pull(CODEWORD))

    def leafs(self) -> list[int]:
        out = _elements(self._pull(LEAFS))
        if len(out) != 3:
            raise Reject("leafs item does not hold three elements")
        return out

    def value(self) -> int:
        out = _elements(self._pull(VALUE))
        if len(out) != 1:
            raise Reject("value item does not hold one element")
        return out[0]

    def path(self) -> list[bytes]:
        payload, pos, out = self._pull(PATH), 0, []
        while pos < len(payload):
            if pos + 8 > len(payload):
                raise Reject("truncated path entry")
            size = int.from_bytes(payload[pos:pos + 8], "big")
            pos += 8
            if pos + size > len(payload):
                raise Reject("path entry overruns its item")
            out.append(payload[pos:pos + size])
            pos += size
        return out

    def challenge(self, num_bytes: int = 32) -> bytes:
        """The verifier's Fiat-Shamir bytes over the items read so far."""
        k = self.read
        header = (P if self.first_carrying < k else 0).to_bytes(16, "big")
        end = self.records[k - 1][2] if k else 16
        return hashlib.shake_256(self.fs_prefix + header + self.data[16:end]).digest(num_bytes)

    def finished(self) -> bool:
        return self.read == len(self.records)
