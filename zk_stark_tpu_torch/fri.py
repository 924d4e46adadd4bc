"""FRI low-degree proofs: commit, fold, query, verify.

Counterpart of the JAX package's ``fri.py``: identical transcript bytes,
index sampling and colinearity checks.  Each commit round is one fold (the
fold kernel on the card, through the engine: ``parallel/engine.py``) and
one Merkle tree built on the device; only the root crosses to the host.
Under a distributed engine the codewords stay in the ranks' blocks from
round to round (the JAX package's "the codeword stays block-sharded"), and
the last codeword, pushed whole into the transcript, is the one gathered.
:meth:`FRI.prove` opens every round's queries with one
:func:`merkle.open_many` (:meth:`FRI.query` opens one round alone).  The
verifier runs on the host except for the last-codeword check, whose iNTT,
degree scan and re-evaluation run on the FRI's device as one segment
(``segments.Segment``, the JAX package's ``_lowdeg_kernel``), cached per
codeword length and coset; an optional ``timer``
(``utils.profiling.StageTimer``) collects the verifier's stages under the
JAX package's names.
"""

from __future__ import annotations

import torch

from . import merkle, segments
from .field import Field
from .ops import limbs as L
from .ops.ntt import MAX_KERNEL_N, intt_mont, ntt_mont
from .ops.poly_ops import DPoly, degree_device
from .parallel.engine import DEFAULT
from .poly import Polynomial
from .proof_stream import Codeword, Leafs, Path, ProofStream, Root
from .utils.bits import bit_index
from .utils.hashing import PROOF_BYTES, blake2b512
from .utils.profiling import stage


class FRI:
    #: the last-codeword check's segments, by (length, omega, offset, device)
    _LOWDEG_CACHE: dict = {}

    def __init__(
        self,
        field: Field,
        offset: int,
        omega: int,
        domain_length: int,
        expansion_factor: int,
        num_colinearity_tests: int,
        device="cuda",
        engine=None,
    ):
        self.field = field
        self.offset = offset
        self.omega = omega
        self.domain_length = domain_length
        self.expansion_factor = expansion_factor
        self.num_colinearity_tests = num_colinearity_tests
        self.device = torch.device(device)
        #: the prover's engine for the fold rounds; the verifier uses none
        self.engine = engine if engine is not None else DEFAULT
        #: an optional ``utils.profiling.StageTimer`` for the verifier's
        #: stages (``Stark.verify`` sets it)
        self.timer = None
        if self.device.type == "cuda" and domain_length > MAX_KERNEL_N ** 3:
            raise NotImplementedError(
                f"FRI domain {domain_length} > {MAX_KERNEL_N ** 3} on the card is beyond "
                "one level of the NTT's recursive split"
            )

    def num_rounds(self) -> int:
        codeword_length = self.domain_length
        num = 0
        while (
            codeword_length > self.expansion_factor
            and codeword_length > 4 * self.num_colinearity_tests
        ):
            codeword_length //= 2
            num += 1
        return num

    def evaluate_domain(self) -> list[int]:
        """The coset points offset * omega^i on the host."""
        p = self.field.order
        out, cur = [], self.offset % p
        for _ in range(self.domain_length):
            out.append(cur)
            cur = cur * self.omega % p
        return out

    # -- index sampling ------------------------------------------------------

    def sample_index(self, data: bytes, size: int) -> int:
        assert size != 0, "modulo zero is impossible"
        bytes_num = bit_index(size) // 8 + 1
        tail = data[-bytes_num:] if bytes_num <= len(data) else data
        acc = 0
        for b in tail:
            acc = (acc << 8) ^ b
        return acc % size

    def sample_indices(
        self, seed: bytes, size: int, reduced_size: int, number: int
    ) -> list[int]:
        assert number <= 2 * reduced_size, (
            "not enough entropy in indices wrt last codeword"
        )
        assert number <= reduced_size, (
            "cannot sample more indices than available in last codeword"
        )
        indices: list[int] = []
        reduced_indices: list[int] = []
        counter = 0
        while len(indices) < number:
            # quirk kept from the reference: the counter appends that many
            # zero BYTES, not a counter value
            index = self.sample_index(blake2b512(seed + bytes(counter)), size)
            reduced = index % reduced_size
            counter += 1
            if reduced not in reduced_indices:
                indices.append(index)
                reduced_indices.append(reduced)
        return indices

    # -- prover --------------------------------------------------------------

    def commit(
        self, codeword: torch.Tensor, proof_stream: ProofStream
    ) -> list[merkle.DeviceMerkleTree]:
        """One tree per round, one fold between rounds; returns the trees."""
        p = self.field.order
        omega, offset = self.omega, self.offset
        num_rounds = self.num_rounds()
        two_inv = L.int_to_mont(pow(2, -1, p), self.device)

        committed = []
        cw, canon = codeword, L.from_mont(codeword)
        last = None
        n = self.domain_length
        for r in range(num_rounds):
            assert pow(omega, n - 1, p) == pow(omega, -1, p), (
                "error in commit: omega does not have the right order"
            )
            tree = merkle.DeviceMerkleTree(canon, n, self.engine)
            proof_stream.push(Root(tree.root))

            if r == num_rounds - 1:
                last = tree
                break

            alpha = self.field.sample(
                proof_stream.fiat_shamir_prover(PROOF_BYTES)
            ).value
            committed.append(tree)

            # a value of this proof: uploaded anew, never cached (int_to_mont)
            ao = L.ints_to_mont([alpha * pow(offset, -1, p) % p], self.device)[0]
            cw, canon = self.engine.fold_round(cw, omega, ao, two_inv, n)
            n //= 2
            omega = omega * omega % p
            offset = offset * offset % p

        proof_stream.push(Codeword(tuple(last.all_values())))
        committed.append(last)
        return committed

    @staticmethod
    def _push_round_queries(
        proof_stream, ab_vals, ab_paths, c_vals, c_paths, k: int
    ) -> None:
        """One query round: k Leafs, then k times 3 Paths, in the reference
        order."""
        a_vals, b_vals = ab_vals[:k], ab_vals[k:]
        a_paths, b_paths = ab_paths[:k], ab_paths[k:]
        for s in range(k):
            proof_stream.push(Leafs((a_vals[s], b_vals[s], c_vals[s])))
        for s in range(k):
            proof_stream.push(Path(tuple(a_paths[s])))
            proof_stream.push(Path(tuple(b_paths[s])))
            proof_stream.push(Path(tuple(c_paths[s])))

    def query(
        self,
        current: merkle.DeviceMerkleTree,
        nxt: merkle.DeviceMerkleTree,
        indices_c: list[int],
        proof_stream: ProofStream,
    ) -> list[int]:
        """One round's openings: ``current`` at ``indices_c`` and their
        partners half a codeword on, ``nxt`` at ``indices_c``, pushed as
        :meth:`prove` pushes each round (which opens every round at once);
        returns the indices opened in ``current``."""
        half = current.n // 2
        indices_a = list(indices_c)
        indices_b = [i + half for i in indices_c]
        (ab_vals, ab_paths), (c_vals, c_paths) = merkle.open_many(
            [(current, indices_a + indices_b), (nxt, indices_a)]
        )
        self._push_round_queries(
            proof_stream, ab_vals, ab_paths, c_vals, c_paths, len(indices_c)
        )
        return indices_a + indices_b

    def prove(self, codeword: torch.Tensor, proof_stream: ProofStream) -> list[int]:
        rows = self.engine.rows(self.domain_length)
        assert rows.stop - rows.start == codeword.shape[0], (
            "domain length does not match initial codeword length"
        )
        committed = self.commit(codeword, proof_stream)

        top_level_indices = self.sample_indices(
            proof_stream.fiat_shamir_prover(PROOF_BYTES),
            committed[1].n,
            committed[-1].n,
            self.num_colinearity_tests,
        )
        indices = list(top_level_indices)

        # every round's values and sibling paths in one gather and one copy:
        # the index derivation is host math and the query pushes feed no
        # further Fiat-Shamir draw
        specs = []
        for i in range(len(committed) - 1):
            cur = committed[i]
            half = cur.n // 2
            indices = [idx % half for idx in indices]
            specs.append((cur, indices + [x + half for x in indices]))
            specs.append((committed[i + 1], list(indices)))
        opened = merkle.open_many(specs)
        for i in range(len(committed) - 1):
            ab_vals, ab_paths = opened[2 * i]
            c_vals, c_paths = opened[2 * i + 1]
            self._push_round_queries(
                proof_stream, ab_vals, ab_paths, c_vals, c_paths,
                self.num_colinearity_tests,
            )
        return top_level_indices

    # -- verifier ------------------------------------------------------------

    @staticmethod
    def _lowdeg(cw: torch.Tensor, last_omega: int, last_offset: int) -> tuple[torch.Tensor]:
        """iNTT -> scale by offset^-1 -> degree scan -> scale back ->
        re-evaluate: [n, 8] Montgomery -> [1 + n, 8], row 0 holding the
        degree (-1 for zero) in limb 0, rows 1.. the canonical re-evaluated
        codeword (one tensor, so one copy to the host)."""
        poly = DPoly(intt_mont(cw, last_omega)).scale(pow(last_offset, -1, L.P))
        deg = degree_device(poly.c).reshape(1, 1)
        deg_row = torch.cat([deg, torch.zeros((1, L.NLIMB - 1), dtype=L.DTYPE, device=cw.device)],
                            dim=1)
        canon = L.from_mont(ntt_mont(poly.scale(last_offset).c, last_omega))
        return (torch.cat([deg_row, canon]),)

    def _last_codeword_check(
        self, last_codeword: list[int], last_omega: int, last_offset: int
    ) -> tuple[int, list[int]]:
        """The low-degree check on the device; returns (degree, re-evaluated
        ints)."""
        key = (len(last_codeword), last_omega, last_offset, str(self.device))
        seg = segments.cache_get(FRI._LOWDEG_CACHE, key, lambda: segments.Segment(
            "lowdeg", lambda cw: self._lowdeg(cw, last_omega, last_offset), self.device))
        (packed,) = seg(L.ints_to_mont(last_codeword, "cpu"))
        out = packed.cpu()
        return int(out[0, 0]), [int(v) for v in L.limbs_to_ints(out[1:])]

    def verify(
        self,
        proof_stream: ProofStream,
        polynomial_values: list[tuple[int, int]],
    ) -> None:
        """Raises ValueError on rejection."""
        p = self.field.order
        omega, offset = self.omega, self.offset
        num_rounds = self.num_rounds()

        roots, alphas = [], []
        for _ in range(num_rounds):
            roots.append(proof_stream.pull_root())
            alphas.append(
                self.field.sample(
                    proof_stream.fiat_shamir_verifier(PROOF_BYTES)
                ).value
            )

        last_codeword = list(proof_stream.pull_codeword())
        # an honest prover's last codeword has exactly this length; a longer
        # one could pass the order check below and reach an NTT the card
        # does not run
        if len(last_codeword) != self.domain_length >> (num_rounds - 1):
            raise ValueError("last codeword has the wrong length")
        with stage(self.timer, "v_fri_last_root"):
            if merkle.commit_ints(last_codeword) != roots[-1]:
                raise ValueError("last codeword is not well formed")

        # low-degree check
        degree = len(last_codeword) // self.expansion_factor - 1
        last_omega, last_offset = omega, offset
        for _ in range(num_rounds - 1):
            last_omega = last_omega * last_omega % p
            last_offset = last_offset * last_offset % p

        if pow(last_omega, -1, p) != pow(last_omega, len(last_codeword) - 1, p):
            raise ValueError("omega does not have the right order")

        with stage(self.timer, "v_fri_lowdeg"):
            poly_degree, reeval = self._last_codeword_check(
                last_codeword, last_omega, last_offset
            )
            if poly_degree < 0:
                # zero polynomial: the reference's degree() returns None
                raise ValueError("received none instead of polynomial degree")
            if poly_degree > degree:
                raise ValueError(
                    f"last codeword does not correspond to polynomial of low "
                    f"enough degree (it is {poly_degree} but should be "
                    f"<= {degree})"
                )
            if reeval != last_codeword:
                raise ValueError("re-evaluated codeword does not match original")

        top_level_indices = self.sample_indices(
            proof_stream.fiat_shamir_verifier(PROOF_BYTES),
            self.domain_length >> 1,
            self.domain_length >> (num_rounds - 1),
            self.num_colinearity_tests,
        )

        for r in range(num_rounds - 1):
            indices_c = [
                i % (self.domain_length >> (r + 1)) for i in top_level_indices
            ]
            indices_a = list(indices_c)
            indices_b = [i + (self.domain_length >> (r + 1)) for i in indices_a]

            with stage(self.timer, "v_fri_colinearity"):
                aa, bb, cc = [], [], []
                for s in range(self.num_colinearity_tests):
                    ay, by, cy = proof_stream.pull_leafs()
                    aa.append(ay)
                    bb.append(by)
                    cc.append(cy)
                    if r == 0:
                        polynomial_values.append((indices_a[s], ay))
                        polynomial_values.append((indices_b[s], by))
                    ax = offset * pow(omega, indices_a[s], p) % p
                    bx = offset * pow(omega, indices_b[s], p) % p
                    cx = alphas[r]
                    if not Polynomial.test_colinearity(
                        self.field, [(ax, ay), (bx, by), (cx, cy)]
                    ):
                        raise ValueError("colinearity check failure")

            with stage(self.timer, "v_fri_paths"):
                for i in range(self.num_colinearity_tests):
                    path = proof_stream.pull_path()
                    if not merkle.verify_int(roots[r], indices_a[i], path, aa[i]):
                        raise ValueError("Merkle auth path verification failed for aa")
                    path = proof_stream.pull_path()
                    if not merkle.verify_int(roots[r], indices_b[i], path, bb[i]):
                        raise ValueError("Merkle auth path verification failed for bb")
                    path = proof_stream.pull_path()
                    if not merkle.verify_int(roots[r + 1], indices_c[i], path, cc[i]):
                        raise ValueError("Merkle auth path verification failed for cc")

            omega = omega * omega % p
            offset = offset * offset % p
