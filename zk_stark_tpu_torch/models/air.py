"""AIR (algebraic intermediate representation) interface.

Counterpart of the JAX package's ``models/air.py``.  The prover and verifier
accept any object with:

* ``num_constraints`` — number of transition constraints;
* ``degree_bounds(point_degrees)`` — max weighted degree per constraint,
  where ``point_degrees = [1, d, d, ..., d]`` gives weight 1 to the cycle
  variable x and the randomized trace degree d to each register variable;
* ``evaluate_codewords(point, engine=None)`` — all constraints evaluated
  pointwise from per-variable codewords
  ``point = [x, cur_0..cur_{m-1}, nxt_0..nxt_{m-1}]`` (each [N, 8]
  Montgomery tensors), used by the prover on the FRI coset and by the
  verifier on the queried points.  The prover passes its ``engine``
  (``parallel/engine.py``): its codewords are then the engine's rows of the
  coset (a rank's block under a distributed engine), and tables over the
  coset must be taken at the same rows;
* ``fingerprint()`` — a hashable value that is equal for AIRs that evaluate
  alike (part of the key of the prover's and verifier's cached segments).

Plain lists of MPolynomial are wrapped in :class:`ConstraintSystemAir`.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..ops.poly_ops import mpoly_evaluate_codewords
from ..poly import MPolynomial


class ConstraintSystemAir:
    """Adapter: list of sparse multivariate constraints -> AIR protocol."""

    def __init__(self, constraints: Sequence[MPolynomial]):
        assert constraints, "empty transition constraints"
        self.constraints = list(constraints)

    @property
    def num_constraints(self) -> int:
        return len(self.constraints)

    def degree_bounds(self, point_degrees: Sequence[int]) -> list[int]:
        res = []
        for a in self.constraints:
            assert a.dictionary, "cannot calculate max on empty constraint"
            best = 0
            for k in a.dictionary:
                total = sum(r * l for r, l in zip(point_degrees, k))
                best = max(best, total)
            res.append(best)
        return res

    def fingerprint(self):
        """The constraints' terms: equal for equal constraint systems (a key
        of the prover's and verifier's cached segments)."""
        return tuple(
            tuple(sorted((tuple(k), v) for k, v in tc.dictionary.items()))
            for tc in self.constraints
        )

    def evaluate_codewords(self, point: Sequence[torch.Tensor],
                           engine=None) -> list[torch.Tensor]:
        return [
            mpoly_evaluate_codewords(dict(tc.dictionary), point)
            for tc in self.constraints
        ]


def as_air(transition_constraints):
    """Accept either an AIR-protocol object or a list of MPolynomials."""
    if hasattr(transition_constraints, "evaluate_codewords"):
        return transition_constraints
    return ConstraintSystemAir(transition_constraints)
