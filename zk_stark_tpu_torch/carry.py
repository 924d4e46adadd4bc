"""Carry inputs and state between the JAX package and the port.

The system has no weights: its state is limb arrays, keys and the
configuration.  The JAX package holds limbs as ``uint32[..., 8]`` arrays
(as numpy on the host); the port holds the same 16-bit limbs in ``int64``
tensors.  Nothing here imports the JAX package: it works on numpy arrays
and plain dictionaries.
"""

from __future__ import annotations

import hashlib
import os
from typing import Callable

import numpy as np
import torch

from .field import Field
from .models.rescue_chain import make_chain_stark
from .models.rpsss import RPSSS


def limbs_from_numpy(arr: np.ndarray, device) -> torch.Tensor:
    """uint32[..., 8] 16-bit limbs (the JAX layout) -> int64 tensor."""
    arr = np.asarray(arr)
    if arr.shape[-1] != 8 or (arr.size and int(arr.max()) > 0xFFFF):
        raise ValueError("expected [..., 8] limbs of 16 bits")
    return torch.from_numpy(arr.astype(np.int64)).to(device)


def limbs_to_numpy(t: torch.Tensor) -> np.ndarray:
    """int64 limb tensor -> uint32[..., 8] numpy array (the JAX layout)."""
    return t.detach().cpu().numpy().astype(np.uint32)


def rescue_constants_from_jax(mds_u32: np.ndarray, rc_u32: np.ndarray, device="cuda"):
    """The JAX package's ``RescuePrime._device_constants()`` (as numpy:
    MDS ``uint32[m, m, 8]``, round constants ``uint32[2Nm, 8]``, Montgomery
    limbs) -> the port's tensors on ``device``, the layout of the port's
    own ``RescuePrime._device_constants(device)``."""
    mds = limbs_from_numpy(mds_u32, device)
    rc = limbs_from_numpy(rc_u32, device)
    if mds.ndim != 3 or mds.shape[0] != mds.shape[1] or rc.ndim != 2:
        raise ValueError(
            f"expected mds [m, m, 8] and round constants [k, 8], got "
            f"{tuple(mds.shape)} and {tuple(rc.shape)}"
        )
    return mds, rc


def rpsss_from_config(
    meta_config: dict, device="cuda", rng: Callable[[int], bytes] = os.urandom
) -> RPSSS:
    """The port's RPSSS for a ``tests/fixtures/meta.json``-style config:
    expansion_factor, num_collinearity_checks, security_level,
    transition_constraints_degree."""
    return RPSSS(
        Field(),
        expansion_factor=meta_config["expansion_factor"],
        num_collinearity_checks=meta_config["num_collinearity_checks"],
        security_level=meta_config["security_level"],
        transition_constraints_degree=meta_config["transition_constraints_degree"],
        rng=rng,
        device=device,
    )


def chain_from_config(
    config: dict, device="cuda", rng: Callable[[int], bytes] = os.urandom
):
    """The port's (RescueChain, Stark) for a ``tests/fixtures/chain_meta.json``
    -style config: chain_length, expansion_factor, num_collinearity_checks,
    security_level.  The state the JAX package's AIR holds for it, the
    round-constant polynomials (``RescueChainAir._constant_polys()``, uint32
    [2m, R, 8]), equals the port's own through :func:`limbs_from_numpy`."""
    return make_chain_stark(
        Field(),
        config["chain_length"],
        expansion_factor=config["expansion_factor"],
        num_collinearity_checks=config["num_collinearity_checks"],
        security_level=config["security_level"],
        rng=rng,
        device=device,
    )


class DetRng:
    """Deterministic byte stream: shake256(tag || counter), the rng that
    made ``tests/fixtures/signature.bin``."""

    def __init__(self, tag: bytes = b"zk-stark-fixture"):
        self.tag = tag
        self.counter = 0

    def __call__(self, n: int) -> bytes:
        out = hashlib.shake_256(self.tag + self.counter.to_bytes(8, "big")).digest(n)
        self.counter += 1
        return out
