"""Iterated Rescue-permutation chain: the long-trace workload.

Counterpart of the JAX package's ``models/rescue_chain.py``.  The model
iterates the Rescue-XLIX round function ``27 * chain_length`` times, the
round constants cycling with period 27, and proves knowledge of an initial
state that reaches a public output.  The trace length, and with it the FRI
domain, scales freely: chain length 3200 gives 86,401 cycles, an omicron
domain of 2^18 and a FRI domain of 2^20.

The AIR has Rescue-Prime's two degree-3 constraints, with round-constant
polynomials that interpolate the periodic constant columns over the whole
trace domain, evaluated in closed form:

    lhs_j = sum_k MDS[j][k] * cur_k^3 + C1_j(x)
    rhs_j = (sum_k MDS_inv[j][k] * (nxt_k - C2_k(x)))^3
    constraint_j = lhs_j - rhs_j

On the prover's FRI coset the C1/C2 codewords come from one structured
interpolation and one coset NTT each, cached per domain in the model; at
the verifier's query points the polynomials are evaluated at log depth
(``evaluate_polys_shared``).  Everything runs on the model's device.
"""

from __future__ import annotations

import os
from typing import Callable, Sequence

import torch
from torch.profiler import record_function

from ..field import Field
from ..ops import limbs as L
from ..ops.poly_ops import (
    DPoly,
    evaluate_polys_shared,
    fast_coset_evaluate,
    interpolate_first_k,
)
from ..stark import Stark, resolve_device
from .rescue_prime import RescuePrime


class RescueChainAir:
    """AIR-protocol object (``models/air.py``) of the permutation chain over
    the trace domain of ``omicron`` (order ``odl``)."""

    def __init__(self, model: "RescueChain", omicron: int, odl: int):
        self.model = model
        self.omicron = omicron
        self.odl = odl

    @property
    def num_constraints(self) -> int:
        return self.model.m

    def degree_bounds(self, point_degrees: Sequence[int]) -> list[int]:
        # the cubed state variables dominate: the round-constant polynomials
        # have degree below the trace degree
        return [3 * point_degrees[1]] * self.model.m

    def fingerprint(self):
        return ("rescue-chain", self.model.m, self.model.num_rounds, self.omicron, self.odl)

    # -- round-constant polynomials ------------------------------------------

    def _constant_polys(self) -> torch.Tensor:
        """Coefficients [2m, R, 8] (Montgomery) of C1_j, then C2_j, over the
        first R = num_rounds powers of omicron; cached in the model."""
        key = self.fingerprint() + ("coeffs",)
        cache = self.model.const_cache
        if key not in cache:
            m, rounds = self.model.m, self.model.num_rounds
            rc, n_rc = self.model.rp.round_constants, self.model.rp.N
            cols = [
                [rc[2 * (i % n_rc) * m + half * m + j] for i in range(rounds)]
                for half in (0, 1)
                for j in range(m)
            ]
            dev = self.model.device
            cache[key] = torch.stack([
                interpolate_first_k(
                    self.omicron, self.odl, rounds, L.ints_to_mont(vals, dev)
                ).padded(rounds)
                for vals in cols
            ])
        return cache[key]

    def _constant_codewords(self, domain_len: int, offset: int, root: int,
                            engine=None) -> torch.Tensor:
        """C1/C2 codewords [2m, domain_len, 8] on the coset, or the engine's
        rows of them (cached per domain and engine)."""
        key = self.fingerprint() + ("cw", domain_len, offset, root) + (
            () if engine is None else (engine.cache_key,))
        cache = self.model.const_cache
        if key not in cache:
            coeffs = self._constant_polys()
            cache[key] = torch.stack([
                fast_coset_evaluate(DPoly(c), offset, root, domain_len, engine=engine)
                for c in coeffs
            ])
        return cache[key]

    # -- evaluation ----------------------------------------------------------

    def _combine(self, point, c1, c2) -> list[torch.Tensor]:
        """Closed-form constraints: point = [x, cur..., nxt...]; c1/c2 the
        constant columns at the same points."""
        m = self.model.m
        dev = point[0].device
        cur = point[1 : 1 + m]
        nxt = point[1 + m : 1 + 2 * m]
        mds, mds_inv = self.model.rp.MDS, self.model.rp.MDS_inv

        cubes = [L.mont_mul(L.mont_mul(c, c), c) for c in cur]
        inner = [L.sub_mod(nxt[k], c2[k]) for k in range(m)]
        out = []
        for j in range(m):
            lhs = None
            for k in range(m):
                term = L.mont_mul(cubes[k], L.int_to_mont(mds[j][k], dev))
                lhs = term if lhs is None else L.add_mod(lhs, term)
            lhs = L.add_mod(lhs, c1[j])

            rhs = None
            for k in range(m):
                term = L.mont_mul(inner[k], L.int_to_mont(mds_inv[j][k], dev))
                rhs = term if rhs is None else L.add_mod(rhs, term)
            rhs = L.mont_mul(L.mont_mul(rhs, rhs), rhs)
            out.append(L.sub_mod(lhs, rhs))
        return out

    def evaluate_codewords(self, point: Sequence[torch.Tensor],
                           engine=None) -> list[torch.Tensor]:
        """The constraints pointwise: on the bound FRI coset from the cached
        constant codewords (the prover's ``engine``'s rows of them),
        elsewhere (the verifier's points) from the constant polynomials."""
        n = point[0].shape[0]
        m = self.model.m
        geometry = self.model.stark_geometry
        if geometry is not None and engine is not None and engine.is_distributed:
            consts = self._constant_codewords(*geometry, engine)
        elif geometry is not None and n == geometry[0]:
            consts = self._constant_codewords(*geometry)
        else:
            consts = evaluate_polys_shared(self._constant_polys(), point[0])
        return self._combine(point, consts[:m], consts[m:])


class RescueChain:
    """Iterated Rescue permutation over ``chain_length`` hash blocks."""

    def __init__(self, field: Field, chain_length: int, m: int = 2,
                 security_level: int = 128, device="cuda"):
        self.field = field
        self.rp = RescuePrime(field, m, 1, security_level, 27)
        self.m = m
        self.chain_length = chain_length
        self.num_rounds = 27 * chain_length
        self.num_cycles = self.num_rounds + 1
        self.device = resolve_device(device)
        #: (fri_domain_len, offset, omega) of the bound prover
        self.stark_geometry = None
        #: constant polynomials and codewords, keyed by AIR fingerprint
        self.const_cache: dict = {}

    # -- execution ------------------------------------------------------------

    def run(self, input_element: int) -> int:
        return self.trace(input_element)[-1][0]

    def trace(self, input_element: int) -> list[list[int]]:
        """num_cycles states, on the host."""
        with record_function("chain.trace"):
            state = [input_element % self.field.order] + [0] * (self.m - 1)
            out = [list(state)]
            for i in range(self.num_rounds):
                state = self.rp._round(state, i % self.rp.N)
                out.append(list(state))
            return out

    # -- AIR -----------------------------------------------------------------

    def air(self, omicron: int, omicron_domain_length: int) -> RescueChainAir:
        return RescueChainAir(self, omicron, omicron_domain_length)

    def bind_stark(self, stark) -> None:
        """Tell the AIR the prover's coset geometry (enables the cached
        constant codewords on the FRI coset)."""
        self.stark_geometry = (stark.fri.domain_length, stark.generator, stark.omega)

    def boundary_constraints(self, output_element: int) -> list[tuple[int, int, int]]:
        return [
            (0, 1, 0),
            (self.num_rounds, 0, output_element % self.field.order),
        ]


def make_chain_stark(
    field: Field,
    chain_length: int,
    expansion_factor: int = 4,
    num_collinearity_checks: int = 64,
    security_level: int = 128,
    rng: Callable[[int], bytes] = os.urandom,
    device="cuda",
):
    """A RescueChain model with a matching Stark on ``device``.

    Chain length 3200 gives an omicron domain of 2^18 and a FRI domain of
    2^20 (``BASELINE.md`` config 5).
    """
    model = RescueChain(field, chain_length, 2, security_level, device=device)
    stark = Stark(
        field,
        expansion_factor,
        num_collinearity_checks,
        security_level,
        model.m,
        model.num_cycles,
        3,
        rng=rng,
        device=model.device,
    )
    model.bind_stark(stark)
    return model, stark
