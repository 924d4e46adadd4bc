"""Faults planted in the measured program inside a run's client (each a
``hook``: called in the client before its set-up)."""

from __future__ import annotations


def _flip_middle_byte(data: bytes) -> bytes:
    i = len(data) // 2
    return data[:i] + bytes([data[i] ^ 1]) + data[i + 1:]


def altered_signature(spec) -> None:
    """A signature altered where it is produced."""
    from zk_stark_tpu_torch.models.rpsss import RPSSS

    sign = RPSSS.sign
    RPSSS.sign = lambda self, sk, doc: _flip_middle_byte(sign(self, sk, doc))


def altered_digests(spec) -> None:
    """Every digest of a batch altered where it is produced."""
    from zk_stark_tpu_torch.models.rescue_prime import RescuePrime

    hash_batch = RescuePrime.hash_batch_device

    def altered(self, inputs):
        out = hash_batch(self, inputs).clone()
        out[:, 0] ^= 1
        return out

    RescuePrime.hash_batch_device = altered


def half_batch(spec) -> None:
    """Half of each batch left out: only its first half is hashed."""
    import torch

    from zk_stark_tpu_torch.models.rescue_prime import RescuePrime

    hash_batch = RescuePrime.hash_batch_device

    def half(self, inputs):
        n = inputs.shape[0] // 2
        return torch.cat([hash_batch(self, inputs[:n]), torch.zeros_like(inputs[n:])])

    RescuePrime.hash_batch_device = half


def imports_jax(spec) -> None:
    """A client that loads JAX."""
    import jax  # noqa: F401
