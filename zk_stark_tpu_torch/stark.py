"""STARK prover and verifier.

Counterpart of the JAX package's ``stark.py``: same transcript bytes, same
degree bookkeeping, same proof format.  The prover keeps the JAX order of
work — first segment (trace interpolation, boundary quotients, codewords,
the AIR on the FRI coset, transition quotients and their degrees) ->
Merkle roots -> weights -> second segment (the weighted combination on the
coset) -> FRI -> openings.  Each segment, and the verifier's combination
check, is a :class:`segments.Segment` cached per configuration in
``Stark._SEG_CACHE`` (the JAX package's ``_seg_cache_get``): on the card
the first call of a configuration captures it as a CUDA graph and later
calls replay it; on the CPU it runs eagerly on the same static buffers.

Transition polynomials come from evaluating the AIR pointwise on the FRI
coset and interpolating back with one iNTT, which equals symbolic
composition because the composition degree fits the coset.

The prover's device work goes through its engine (``parallel/engine.py``,
the JAX package's ``Stark(engine=...)``): the single-device ``DEFAULT``, or
a ``DistEngine`` over the ranks of a process group.  Every rank then runs
``prove`` with the same arguments and returns the same bytes.  Under a
DistEngine every codeword of the FRI domain (the coset x-values, the trace
codewords, the AIR's evaluation, the quotients' and randomizer's
codewords, the combination and every FRI round) and every polynomial a
transform returns is held as the rank's natural block of rows.  Kept
whole on every rank: the host-made polynomials (the trace columns,
boundary interpolants and zerofiers, the randomizer) and the cached
transition zerofier, each at most the randomized trace long, and the
interpolation's cached tables over the omicron domain.  The
Merkle trees hash their blocks and share the top levels, and only the
last FRI codeword is gathered whole.  On NCCL the segments are captured
with their collectives; rank 0 alone draws the prover's random bytes and
hands them to the others.

The verifier reads the proof on the host; its combination check (the
queried trace values, zerofiers and quotients, weighted and summed) runs
on the device as one segment, its inputs in one upload.  It uses no
engine.
"""

from __future__ import annotations

import os
from typing import Callable, Optional, Sequence

import torch
from torch.profiler import record_function

from . import merkle, segments
from .field import Field
from .fri import FRI
from .models.air import as_air
from .ops import limbs as L
from .ops._build import resolve_device
from .ops.poly_ops import (
    DPoly,
    degree_device,
    evaluate_many,
    fast_coset_divide,
    fast_coset_evaluate,
    interpolate_first_k,
    laid,
    zerofier_first_k,
)
from .parallel.engine import DEFAULT
from .poly import MPolynomial, Polynomial
from .proof_stream import Path, ProofStream, Root, Value
from .utils.bits import bit_count
from .utils.hashing import PROOF_BYTES
from .utils.profiling import stage


class ProvingError(Exception):
    """Raised when the prover cannot produce a valid proof (e.g. the degree
    sanity check rejects a false witness)."""


class VerificationError(Exception):
    """Raised when a proof is rejected."""


Boundary = Sequence[tuple[int, int, int]]  # (cycle, register, value)


class Stark:
    def __init__(
        self,
        field: Field,
        expansion_factor: int,
        num_collinearity_checks: int,
        security_level: int,
        num_registers: int,
        num_cycles: int,
        transition_constraints_degree: int,
        rng: Callable[[int], bytes] = os.urandom,
        device="cuda",
        engine=None,
    ):
        assert bit_count(field.order) >= security_level, (
            f"field order must be at least {security_level} bits"
        )
        assert expansion_factor & (expansion_factor - 1) == 0, (
            "expansion factor must be a power of 2"
        )
        assert expansion_factor >= 4, "expansion factor must be at least 4"
        assert num_collinearity_checks * 2 >= security_level, (
            f"number of collinearity checks must be at least half of "
            f"{security_level}"
        )

        self.device = resolve_device(device)
        self.field = field
        self.expansion_factor = expansion_factor
        self.num_registers = num_registers
        self.original_trace_length = num_cycles
        self.num_randomizers = 4 * num_collinearity_checks
        self._rng = rng
        #: the prover's engine (parallel/engine.py); ``stark.engine`` and
        #: ``stark.fri.engine`` may be set after construction
        self.engine = engine if engine is not None else DEFAULT
        #: an optional ``utils.profiling.StageTimer``: prove and verify add
        #: their stages' times to it (the JAX package's stage names), beside
        #: the ``record_function`` spans
        self.timer = None

        randomized_trace_length = num_cycles + self.num_randomizers
        # quirk kept: 1 << bit_count(v) is strictly greater than v even for
        # exact powers of two
        self.omicron_domain_length = 1 << bit_count(
            randomized_trace_length * transition_constraints_degree
        )
        fri_domain_length = self.omicron_domain_length * expansion_factor

        self.generator = field.generator().value
        self.omega = field.primitive_nth_root(fri_domain_length).value
        self.omicron = field.primitive_nth_root(self.omicron_domain_length).value
        # every transform of the prover and verifier is at most the FRI
        # domain, which FRI checks against the NTT kernel's limit
        self.fri = FRI(
            field,
            self.generator,
            self.omega,
            fri_domain_length,
            expansion_factor,
            num_collinearity_checks,
            device=self.device,
            engine=self.engine,
        )

    # -- degree bookkeeping --------------------------------------------------

    def transition_degree_bounds(self, transition_constraints) -> list[int]:
        point_degrees = [1] + [
            self.original_trace_length + self.num_randomizers - 1
        ] * (2 * self.num_registers)
        return as_air(transition_constraints).degree_bounds(point_degrees)

    def transition_quotient_degree_bounds(self, transition_constraints) -> list[int]:
        return [
            d - (self.original_trace_length - 1)
            for d in self.transition_degree_bounds(transition_constraints)
        ]

    def max_degree(self, transition_constraints) -> int:
        md = max(self.transition_degree_bounds(transition_constraints))
        return (1 << bit_count(md)) - 1

    # -- zerofiers / interpolants --------------------------------------------

    def transition_zerofier(self) -> DPoly:
        """Zerofier over omicron^0..^(T-2)."""
        return zerofier_first_k(
            self.omicron,
            self.omicron_domain_length,
            self.original_trace_length - 1,
            self.device,
        )

    def _boundary_domains(self, boundary: Boundary):
        p = self.field.order
        return [
            [pow(self.omicron, c, p) for c, r, _ in boundary if r == s]
            for s in range(self.num_registers)
        ]

    def boundary_zerofiers(self, boundary: Boundary) -> list[Polynomial]:
        return [
            Polynomial.zerofier_domain(self.field, domain)
            for domain in self._boundary_domains(boundary)
        ]

    def boundary_interpolants(self, boundary: Boundary) -> list[Polynomial]:
        out = []
        for s, domain in enumerate(self._boundary_domains(boundary)):
            values = [v for _, r, v in boundary if r == s]
            if not domain:
                # register with no boundary conditions: zero interpolant
                out.append(Polynomial.zero(self.field))
            else:
                out.append(Polynomial.interpolate_domain(self.field, domain, values))
        return out

    def boundary_quotient_degree_bounds(
        self, randomized_trace_length: int, boundary: Boundary
    ) -> list[int]:
        randomized_trace_degree = randomized_trace_length - 1
        return [
            randomized_trace_degree - bz.degree()
            for bz in self.boundary_zerofiers(boundary)
        ]

    def sample_weights(self, number: int, randomness: bytes) -> list[int]:
        """Quirk kept: the i-zero-byte prefix does not change the 128-bit
        fold, so all weights coincide (transcript compatibility)."""
        return [
            self.field.sample(bytes(i) + randomness).value for i in range(number)
        ]

    # -- segments ------------------------------------------------------------

    #: the prover's and verifier's segments, shared by every Stark of one
    #: configuration on one device (the JAX package's ``_SEG_CACHE``)
    _SEG_CACHE: dict = {}

    def _config_key(self) -> tuple:
        return (
            self.field.order,
            self.expansion_factor,
            self.num_registers,
            self.original_trace_length,
            self.num_randomizers,
            self.omicron_domain_length,
            self.fri.domain_length,
            str(self.device),
            self.engine.cache_key,
        )

    def _seg_cache_get(self, name: str, key: tuple, body,
                       capture: bool = True, warm=None) -> segments.Segment:
        """The segment ``name`` of this configuration and ``key``; ``body``
        (a function of tensors) is captured only on the first use of the
        key, so everything it closes over besides its inputs must be fixed
        by the key.  With ``capture`` false it runs eagerly on the card
        too; ``warm`` (the engine's) runs before a capture's warm-up."""
        return segments.cache_get(
            Stark._SEG_CACHE, (name, self._config_key()) + key,
            lambda: segments.Segment(name, body, self.device, capture=capture, warm=warm),
        )

    # -- prover --------------------------------------------------------------

    def _segment1(self, air, trace_cols, bi_arrs, bz_arrs, rand_arr):
        """Trace interpolation -> boundary quotients and their codewords,
        transition quotients (the AIR on the coset + iNTT) and their
        degrees, the randomizer codeword."""
        p = self.field.order
        m = self.num_registers
        odl = self.omicron_domain_length
        fri_dl = self.fri.domain_length
        omicron, omega, g = self.omicron, self.omega, self.generator
        orig_t = self.original_trace_length
        tdb = self.transition_degree_bounds(air)
        T = trace_cols.shape[1]
        eng = self.engine

        def held(poly):
            """A quotient as seg2 takes it: whole under the single engine,
            the rank's block of the FRI domain under a distributed one."""
            return laid(poly, fri_dl, eng) if eng.is_distributed else poly.c

        tps = [interpolate_first_k(omicron, odl, T, trace_cols[s], engine=eng)
               for s in range(m)]

        bqs, bq_cws = [], []
        for s in range(m):
            bq = fast_coset_divide(
                tps[s] - DPoly(bi_arrs[s]),
                DPoly(bz_arrs[s]),
                g,
                omicron,
                odl,
                lhs_degree=T - 1,
                rhs_degree=bz_arrs[s].shape[0] - 1,
                engine=eng,
            )
            bqs.append(bq)
            bq_cws.append(fast_coset_evaluate(bq, g, omega, fri_dl, engine=eng))

        x_cw = eng.powers(omega, fri_dl, self.device, scale_int=g)
        cur = [fast_coset_evaluate(tp, g, omega, fri_dl, engine=eng) for tp in tps]
        nxt = [fast_coset_evaluate(tp.scale(omicron), g, omega, fri_dl, engine=eng)
               for tp in tps]
        point = [x_cw] + cur + nxt

        tz = self.transition_zerofier()
        g_inv = pow(g, -1, p)
        tqs, tq_degs = [], []
        for i, cw in enumerate(air.evaluate_codewords(point, engine=eng)):
            tpoly = DPoly.held(eng.intt(cw, omega, fri_dl), fri_dl, eng).scale(g_inv)
            tq = fast_coset_divide(
                tpoly, tz, g, omicron, odl,
                lhs_degree=tdb[i], rhs_degree=orig_t - 1, engine=eng,
            )
            tqs.append(tq)
            tq_degs.append(degree_device(tq.c, tq.start))

        rand_cw = fast_coset_evaluate(DPoly(rand_arr), g, omega, fri_dl, engine=eng)
        canons = L.from_mont(torch.stack(bq_cws + [rand_cw]))
        return (canons, [held(tq) for tq in tqs], [held(bq) for bq in bqs],
                eng.max_over_ranks(torch.stack(tq_degs)))

    def _segment2(self, w: torch.Tensor, term_arrs, shifts) -> tuple[torch.Tensor]:
        """Weighted combination (weights ``w`` [W, 8]) of the shifted
        quotients and the randomizer, evaluated on the FRI coset."""
        eng, fri_dl = self.engine, self.fri.domain_length
        comb = eng.combine(w, term_arrs, shifts, fri_dl)
        return (fast_coset_evaluate(
            DPoly.held(comb, fri_dl, eng), self.generator, self.omega, fri_dl, engine=eng,
        ),)

    def prove(
        self,
        trace: Sequence[Sequence[int]],
        transition_constraints: Sequence[MPolynomial],
        boundary: Boundary,
        proof_stream: Optional[ProofStream] = None,
    ) -> bytes:
        ps = proof_stream if proof_stream is not None else ProofStream(self.field)

        with record_function("stark.host_inputs"), stage(self.timer, "host_inputs"):
            # every random draw of the proof, in the reference's order: the
            # trace randomizers, then the randomizer polynomial (one
            # broadcast under a DistEngine)
            m = self.num_registers
            transition_constraints_degree = self.max_degree(transition_constraints)
            draws = iter(self.engine.draw(
                self._rng,
                [17] * (self.num_randomizers * m + transition_constraints_degree + 1),
                self.device,
            ))
            # concatenate randomizers - induces zero knowledge
            trace = [list(row) for row in trace]
            for _ in range(self.num_randomizers):
                trace.append([self.field.sample(next(draws)).value for _ in range(m)])
            randomized_trace_length = len(trace)

            boundary_interpolants = self.boundary_interpolants(boundary)
            boundary_zerofiers = self.boundary_zerofiers(boundary)
            randomizer_ints = [
                self.field.sample(next(draws)).value
                for _ in range(transition_constraints_degree + 1)
            ]

            # host tensors, each copied into its segment's buffer on the
            # device; the randomizer goes up once, since both segments read it
            trace_cols = L.ints_to_mont(
                [row[s] for s in range(m) for row in trace], "cpu"
            ).reshape(m, randomized_trace_length, L.NLIMB)
            bi_arrs = [
                L.ints_to_mont(bi.coeffs if bi.coeffs else [0], "cpu")
                for bi in boundary_interpolants
            ]
            bz_arrs = [L.ints_to_mont(bz.coeffs, "cpu") for bz in boundary_zerofiers]
            rand_arr = L.ints_to_mont(randomizer_ints, self.device)

        air = as_air(transition_constraints)
        seg1 = self._seg_cache_get(
            "seg1",
            (
                randomized_trace_length,
                tuple(a.shape[0] for a in bi_arrs),
                tuple(a.shape[0] for a in bz_arrs),
                air.fingerprint(),
            ),
            lambda *args: self._segment1(air, *args),
            capture=self.engine.captures_segments,
            warm=self.engine.warm,
        )
        with record_function("stark.segment1"), stage(self.timer, "segment1"):
            canons, tq_stack, bq_stack, tq_degs = seg1(
                trace_cols, bi_arrs, bz_arrs, rand_arr
            )

        # commit to boundary quotients + randomizer
        fri_dl = self.fri.domain_length
        with record_function("stark.commit"), stage(self.timer, "commit_roots"):
            trees = [merkle.DeviceMerkleTree(canons[s], fri_dl, self.engine)
                     for s in range(m + 1)]
            for tree in trees:
                ps.push(Root(tree.root))
            tq_degrees = [int(d) for d in tq_degs.cpu().tolist()]

        # weights + degree sanity check
        weights = self.sample_weights(
            1 + 2 * air.num_constraints + 2 * self.num_registers,
            ps.fiat_shamir_prover(PROOF_BYTES),
        )
        if any(d < 0 for d in tq_degrees):
            raise ProvingError("failed to get degree of transition quotient")
        tq_bounds = self.transition_quotient_degree_bounds(transition_constraints)
        if tq_degrees != tq_bounds:
            raise ProvingError(
                "transition quotient degrees do not match with expectation"
            )

        # weighted combination
        bq_bounds = self.boundary_quotient_degree_bounds(
            randomized_trace_length, boundary
        )
        # each quotient enters twice, unshifted and shifted: the segment
        # takes each array once (its inputs are copies)
        arrs = [self.engine.constrain(rand_arr, fri_dl)] + list(tq_stack) + list(bq_stack)
        terms, shifts = [0], [0]
        for i, bound in enumerate(tq_bounds + bq_bounds):
            terms.extend([1 + i, 1 + i])
            shifts.extend([0, transition_constraints_degree - bound])
        seg2 = self._seg_cache_get(
            "seg2",
            (tuple(shifts), tuple(int(arrs[t].shape[0]) for t in terms)),
            lambda w, a: self._segment2(w, [a[t] for t in terms], shifts),
            capture=self.engine.captures_segments,
            warm=self.engine.warm,
        )
        with record_function("stark.segment2"), stage(self.timer, "segment2"):
            (combined,) = seg2(L.ints_to_mont(weights, "cpu"), arrs)

        # FRI low-degree proof
        with record_function("stark.fri_prove"), stage(self.timer, "fri_prove"):
            indices = self.fri.prove(combined, ps)

        # open boundary quotients and randomizer
        duplicated_indices = indices + [
            (i + self.expansion_factor) % fri_dl for i in indices
        ]
        quadrupled_indices = sorted(
            duplicated_indices
            + [(i + fri_dl // 2) % fri_dl for i in duplicated_indices]
        )
        with stage(self.timer, "openings"):
            with record_function("stark.openings"):
                opened = merkle.open_many([(tree, quadrupled_indices) for tree in trees])
            for vals, paths in opened:
                for j in range(len(quadrupled_indices)):
                    ps.push(Value(vals[j]))
                    ps.push(Path(tuple(paths[j])))

        with stage(self.timer, "serialize"):
            return ps.serialize()

    # -- verifier ------------------------------------------------------------

    def _combination(
        self, air, packed, K, W, bz_lens, bi_lens, shifts_tq, shifts_bq
    ) -> tuple[torch.Tensor]:
        """The combination check on the device: every input arrives in one
        [total, 8] upload; returns the [K, 8] canonical combination."""
        m = self.num_registers
        off = 0

        def take(n):
            nonlocal off
            out = packed[off : off + n]
            off += n
            return out

        x_cur = take(K)
        x_next = take(K)
        leaf_cur = [take(K) for _ in range(m)]
        leaf_next = [take(K) for _ in range(m)]
        rand_vals = take(K)
        weights = take(W)
        bz = [take(n) for n in bz_lens]
        bi = [take(n) for n in bi_lens]

        # trace = leaf * zerofier(x) + interpolant(x)
        trace_current, trace_next = [], []
        for s in range(m):
            trace_current.append(L.add_mod(
                L.mont_mul(leaf_cur[s], evaluate_many(bz[s], x_cur)),
                evaluate_many(bi[s], x_cur),
            ))
            trace_next.append(L.add_mod(
                L.mont_mul(leaf_next[s], evaluate_many(bz[s], x_next)),
                evaluate_many(bi[s], x_next),
            ))

        point = [x_cur] + trace_current + trace_next
        tz = self.transition_zerofier()
        tz_inv = L.batch_inv(evaluate_many(tz.c, x_cur))

        terms = [rand_vals]
        for s, tcv in enumerate(air.evaluate_codewords(point)):
            quotient = L.mont_mul(tcv, tz_inv)
            terms.append(quotient)
            terms.append(L.mont_mul(quotient, L.mont_pow(x_cur, shifts_tq[s])))
        for s in range(m):
            terms.append(leaf_cur[s])
            terms.append(L.mont_mul(leaf_cur[s], L.mont_pow(x_cur, shifts_bq[s])))

        comb = torch.zeros_like(x_cur)
        for i, term in enumerate(terms):
            comb = L.add_mod(comb, L.mont_mul(term, weights[i]))
        return (L.from_mont(comb),)

    def verify(
        self,
        transition_constraints: Sequence[MPolynomial],
        boundary: Boundary,
        proof_stream: ProofStream,
    ) -> None:
        """Raises VerificationError on rejection."""
        p = self.field.order
        ps = proof_stream

        original_trace_length = 1 + max(c for c, _, _ in boundary)
        randomized_trace_length = original_trace_length + self.num_randomizers

        boundary_quotient_roots = [ps.pull_root() for _ in range(self.num_registers)]
        randomizer_root = ps.pull_root()

        air = as_air(transition_constraints)
        boundary_interpolants = self.boundary_interpolants(boundary)
        weights = self.sample_weights(
            1 + 2 * air.num_constraints + 2 * len(boundary_interpolants),
            ps.fiat_shamir_verifier(PROOF_BYTES),
        )

        points: list[tuple[int, int]] = []
        try:
            with record_function("stark.verify_fri"), stage(self.timer, "v_fri"):
                self.fri.timer = self.timer
                self.fri.verify(ps, points)
        except ValueError as e:
            raise VerificationError(f"FRI verification failed: {e}") from e
        finally:
            self.fri.timer = None
        points.sort(key=lambda t: t[0])
        indices = [i for i, _ in points]
        values = [v for _, v in points]

        duplicated_indices = sorted(
            indices
            + [(i + self.expansion_factor) % self.fri.domain_length for i in indices]
        )

        with stage(self.timer, "v_openings"):
            # boundary quotient leafs
            leafs: list[dict[int, int]] = []
            for bqr in boundary_quotient_roots:
                reg_leafs: dict[int, int] = {}
                for i in duplicated_indices:
                    leaf = ps.pull_value()
                    path = ps.pull_path()
                    if not merkle.verify_int(bqr, i, path, leaf):
                        raise VerificationError(
                            f"boundary quotient root {i} is not verified"
                        )
                    reg_leafs[i] = leaf
                leafs.append(reg_leafs)

            # randomizer leafs
            randomizers: dict[int, int] = {}
            for i in duplicated_indices:
                leaf = ps.pull_value()
                path = ps.pull_path()
                if not merkle.verify_int(randomizer_root, i, path, leaf):
                    raise VerificationError(f"randomizer leaf {i} not verified")
                randomizers[i] = leaf

        if not indices:
            return
        with stage(self.timer, "v_comb_host"):
            boundary_zerofiers = self.boundary_zerofiers(boundary)
            transition_constraints_degree = self.max_degree(transition_constraints)
            tq_bounds = self.transition_quotient_degree_bounds(transition_constraints)
            bq_bounds = self.boundary_quotient_degree_bounds(
                randomized_trace_length, boundary
            )
            shifts_tq = [transition_constraints_degree - b for b in tq_bounds]
            shifts_bq = [transition_constraints_degree - b for b in bq_bounds]

            idx_next = [
                (i + self.expansion_factor) % self.fri.domain_length for i in indices
            ]
            bz_ints = [bz.coeffs if bz.coeffs else [0] for bz in boundary_zerofiers]
            bi_ints = [bi.coeffs if bi.coeffs else [0] for bi in boundary_interpolants]
            flat: list[int] = []
            flat += [self.fri.offset * pow(self.fri.omega, i, p) % p for i in indices]
            flat += [self.fri.offset * pow(self.fri.omega, i, p) % p for i in idx_next]
            for s in range(self.num_registers):
                flat += [leafs[s][i] for i in indices]
            for s in range(self.num_registers):
                flat += [leafs[s][i] for i in idx_next]
            flat += [randomizers[i] for i in indices]
            flat += weights
            for c in bz_ints:
                flat += c
            for c in bi_ints:
                flat += c

        # the transition zerofier uses the CONFIGURED trace length
        # (transition_zerofier), not the boundary-derived one above, which
        # only feeds the randomized trace length and the boundary-quotient
        # degree bounds; using it here would reject valid proofs for an AIR
        # whose boundary leaves the final cycle unconstrained
        K, W = len(indices), len(weights)
        bz_lens = tuple(len(c) for c in bz_ints)
        bi_lens = tuple(len(c) for c in bi_ints)
        seg = self._seg_cache_get(
            "verify_seg",
            (K, W, self.original_trace_length, tuple(shifts_tq), tuple(shifts_bq),
             bz_lens, bi_lens, air.fingerprint()),
            lambda packed: self._combination(
                air, packed, K, W, bz_lens, bi_lens, shifts_tq, shifts_bq
            ),
        )
        with record_function("stark.verify_combination"), stage(self.timer, "v_comb_seg"):
            (canon,) = seg(L.ints_to_mont(flat, "cpu"))
            got = [int(v) for v in L.limbs_to_ints(canon)]
        if got != values:
            raise VerificationError("combination does not match with polynomial value")
