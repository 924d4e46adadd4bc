"""Host polynomials over GF(p): dense univariate + sparse multivariate.

Host-side counterpart of the reference polynomial layer
(ref: reference src/field/polynomial.rs:7-356 and
 reference src/m_polynomial.rs:9-301).

These run on Python ints — exact, convenient for the verifier, protocol
bookkeeping, and as the gold reference for parity tests.  Bulk polynomial
work (NTT multiply, coset evaluate/divide, trace interpolation) lives on
device in ``zk_stark_tpu_torch.ops.poly_ops``.

Semantics preserved from the reference where they are protocol-visible:
* ``degree()`` returns None for zero/empty polynomials and otherwise scans for
  the last non-zero coefficient (trailing zeros allowed in storage).
* ``divide_with_rem`` quotient length is ``numer_deg - denom_deg + 1`` with
  explicit zero padding.
"""

from __future__ import annotations

from typing import Optional, Sequence

from .field import Field, FieldElement


class Polynomial:
    """Dense univariate polynomial, lowest-degree-first coefficients."""

    __slots__ = ("field", "coeffs")

    def __init__(self, field: Field, coeffs: Sequence[int]):
        self.field = field
        self.coeffs = [c % field.order for c in coeffs]

    # -- constructors --------------------------------------------------------

    @classmethod
    def from_elements(cls, elements: Sequence[FieldElement]) -> "Polynomial":
        assert elements, "need at least one element to infer the field"
        return cls(elements[0].field, [e.value for e in elements])

    @classmethod
    def zero(cls, field: Field) -> "Polynomial":
        return cls(field, [])

    @classmethod
    def x(cls, field: Field) -> "Polynomial":
        return cls(field, [0, 1])

    # -- inspection ----------------------------------------------------------

    def degree(self) -> Optional[int]:
        """Index of last non-zero coefficient; None if zero polynomial
        (ref: polynomial.rs:46-63)."""
        deg = None
        for i, c in enumerate(self.coeffs):
            if c != 0:
                deg = i
        return deg

    def is_zero(self) -> bool:
        return self.degree() is None

    def leading_coefficient(self) -> Optional[int]:
        d = self.degree()
        if d is None:
            return self.coeffs[-1] if self.coeffs else None
        return self.coeffs[d]

    def __eq__(self, other) -> bool:
        """Value equality (ignores trailing zeros)."""
        if not isinstance(other, Polynomial):
            return NotImplemented
        a, b = self.coeffs, other.coeffs
        n = max(len(a), len(b))
        for i in range(n):
            av = a[i] if i < len(a) else 0
            bv = b[i] if i < len(b) else 0
            if av != bv:
                return False
        return True

    def __hash__(self):
        raise TypeError("Polynomial is mutable-ish; not hashable")

    def __repr__(self) -> str:
        return f"Polynomial({self.coeffs})"

    # -- evaluation ----------------------------------------------------------

    def evaluate(self, point: int) -> int:
        """Horner evaluation (ref: polynomial.rs:76-100)."""
        p = self.field.order
        acc = 0
        for c in reversed(self.coeffs):
            acc = (acc * point + c) % p
        return acc

    def evaluate_domain(self, domain: Sequence[int]) -> list[int]:
        return [self.evaluate(x) for x in domain]

    def scale(self, factor: int) -> "Polynomial":
        """x -> factor*x substitution: coeff_i * factor^i
        (ref: polynomial.rs:109-121)."""
        p = self.field.order
        out, f = [], 1
        for c in self.coeffs:
            out.append(c * f % p)
            f = f * factor % p
        return Polynomial(self.field, out)

    # -- interpolation / zerofiers ------------------------------------------

    @classmethod
    def interpolate_domain(
        cls, field: Field, domain: Sequence[int], values: Sequence[int]
    ) -> "Polynomial":
        """Lagrange interpolation over arbitrary distinct points in O(n^2)
        (ref: polynomial.rs:123-148, which is O(n^3)): the zerofier Z once,
        then for each point Z / (x - x_i) by synthetic division, weighted by
        v_i / Z'(x_i).  Interpolation is unique, so the coefficients are the
        reference's; a repeated point has no inverse and raises ValueError."""
        assert len(domain) == len(values), "domain/values length mismatch"
        assert domain, "cannot interpolate between zero points"
        p = field.order
        k = len(domain)
        z = cls.zerofier_domain(field, domain).coeffs
        acc = [0] * k
        for xi, vi in zip(domain, values):
            q = [0] * k  # Z / (x - xi)
            c = q[k - 1] = z[k]
            for j in range(k - 1, 0, -1):
                c = q[j - 1] = (z[j] + xi * c) % p
            den = 0  # q(xi) = Z'(xi)
            for c in reversed(q):
                den = (den * xi + c) % p
            w = vi * pow(den, -1, p) % p
            for j in range(k):
                acc[j] += w * q[j]
        return cls(field, acc)

    @classmethod
    def zerofier_domain(cls, field: Field, domain: Sequence[int]) -> "Polynomial":
        """prod (x - d) (ref: polynomial.rs:150-159)."""
        p = field.order
        coeffs = [1]
        for d in domain:
            nxt = [0] * (len(coeffs) + 1)
            for k, c in enumerate(coeffs):
                nxt[k] = (nxt[k] - c * d) % p
                nxt[k + 1] = (nxt[k + 1] + c) % p
            coeffs = nxt
        return cls(field, coeffs)

    @staticmethod
    def test_colinearity(field: Field, points: Sequence[tuple[int, int]]) -> bool:
        """Degree-1 check via interpolation (ref: polynomial.rs:161-177).

        Fast path for the 3-point case (every FRI colinearity test): the
        interpolating quadratic has degree exactly 1 iff the cross-form
        determinant ``y0(x1-x2) + y1(x2-x0) + y2(x0-x1)`` vanishes (no
        quadratic term) and the values are not all equal (nonzero slope).
        Equivalent to interpolate-then-degree but needs zero inversions.
        Degenerate domains (repeated x) fall through to interpolation so
        error behavior matches the reference exactly.
        """
        p = field.order
        if len(points) == 3:
            (x0, y0), (x1, y1), (x2, y2) = points
            if len({x0 % p, x1 % p, x2 % p}) == 3:
                det = (y0 * (x1 - x2) + y1 * (x2 - x0) + y2 * (x0 - x1)) % p
                return det == 0 and (y0 - y1) % p != 0
        domain = [x for x, _ in points]
        values = [y for _, y in points]
        poly = Polynomial.interpolate_domain(field, domain, values)
        return poly.degree() == 1

    # -- arithmetic ----------------------------------------------------------

    def __neg__(self) -> "Polynomial":
        p = self.field.order
        return Polynomial(self.field, [(-c) % p for c in self.coeffs])

    def __add__(self, other: "Polynomial") -> "Polynomial":
        if self.degree() is None:
            return Polynomial(other.field, list(other.coeffs))
        if other.degree() is None:
            return Polynomial(self.field, list(self.coeffs))
        p = self.field.order
        n = max(len(self.coeffs), len(other.coeffs))
        out = [0] * n
        for i, c in enumerate(self.coeffs):
            out[i] = (out[i] + c) % p
        for i, c in enumerate(other.coeffs):
            out[i] = (out[i] + c) % p
        return Polynomial(self.field, out)

    def __sub__(self, other: "Polynomial") -> "Polynomial":
        return self + (-other)

    def __mul__(self, other: "Polynomial") -> "Polynomial":
        """Schoolbook product (ref: polynomial.rs:290-315); NTT path is in
        ops.poly_ops.fast_multiply."""
        if not self.coeffs or not other.coeffs:
            return Polynomial.zero(self.field)
        p = self.field.order
        out = [0] * (len(self.coeffs) + len(other.coeffs) - 1)
        for i, a in enumerate(self.coeffs):
            if a == 0:
                continue
            for j, b in enumerate(other.coeffs):
                out[i + j] = (out[i + j] + a * b) % p
        return Polynomial(self.field, out)

    def __pow__(self, exponent: int) -> "Polynomial":
        if self.is_zero():
            return Polynomial.zero(self.field)
        acc = Polynomial(self.field, [1])
        if exponent == 0:
            return acc
        for bit in bin(exponent)[2:]:
            acc = acc * acc
            if bit == "1":
                acc = acc * self
        return acc

    __xor__ = __pow__  # reference uses ^ for pow

    def divide_with_rem(
        self, denominator: "Polynomial"
    ) -> tuple["Polynomial", "Polynomial"]:
        """Schoolbook long division (ref: polynomial.rs:179-224)."""
        denom_degree = denominator.degree()
        if denom_degree is None:
            raise ZeroDivisionError("denominator is zero or empty")
        numer_degree = self.degree()
        if numer_degree is None or numer_degree < denom_degree:
            return Polynomial.zero(self.field), Polynomial(
                self.field, list(self.coeffs)
            )

        p = self.field.order
        remainder = list(self.coeffs)
        steps = numer_degree - denom_degree + 1
        quotient = [0] * steps
        denom_lead_inv = pow(denominator.coeffs[denom_degree], -1, p)
        denom = denominator.coeffs

        for _ in range(steps):
            rdeg = None
            for i, c in enumerate(remainder):
                if c != 0:
                    rdeg = i
            if rdeg is None or rdeg < denom_degree:
                break
            coefficient = remainder[rdeg] * denom_lead_inv % p
            shift = rdeg - denom_degree
            for k in range(denom_degree + 1):
                if denom[k]:
                    remainder[shift + k] = (
                        remainder[shift + k] - coefficient * denom[k]
                    ) % p
            quotient[shift] = coefficient

        return Polynomial(self.field, quotient), Polynomial(self.field, remainder)

    def __mod__(self, other: "Polynomial") -> "Polynomial":
        return self.divide_with_rem(other)[1]

    def __truediv__(self, other: "Polynomial") -> "Polynomial":
        q, r = self.divide_with_rem(other)
        if not r.is_zero():
            raise ValueError("true division leaves a non-zero remainder")
        return q


class MPolynomial:
    """Sparse multivariate polynomial: {exponent tuple -> coefficient int}.

    (ref: m_polynomial.rs:9-301).  Exponent tuples may have different lengths
    within one dictionary (the reference allows this); arithmetic pads with
    zeros to the longest key, matching reference semantics.
    """

    __slots__ = ("field", "dictionary")

    def __init__(self, field: Field, dictionary: dict[tuple[int, ...], int]):
        self.field = field
        self.dictionary = {
            tuple(k): v % field.order for k, v in dictionary.items()
        }

    @classmethod
    def zero(cls, field: Field) -> "MPolynomial":
        return cls(field, {})

    @classmethod
    def constant(cls, field: Field, value: int) -> "MPolynomial":
        return cls(field, {(0,): value})

    @classmethod
    def variables(cls, num_variables: int, field: Field) -> list["MPolynomial"]:
        out = []
        for i in range(num_variables):
            exp = [0] * num_variables
            exp[i] = 1
            out.append(cls(field, {tuple(exp): 1}))
        return out

    @classmethod
    def lift(cls, polynomial: Polynomial, variable_index: int) -> "MPolynomial":
        """Univariate -> multivariate in variable ``variable_index``
        (ref: m_polynomial.rs:65-81)."""
        field = polynomial.field
        if polynomial.is_zero():
            return cls.zero(field)
        dictionary: dict[tuple[int, ...], int] = {}
        nvars = variable_index + 1
        for i, c in enumerate(polynomial.coeffs):
            if c == 0:
                continue
            exp = [0] * nvars
            exp[variable_index] = i
            key = tuple(exp)
            dictionary[key] = (dictionary.get(key, 0) + c) % field.order
        return cls(field, dictionary)

    def is_zero(self) -> bool:
        return all(v == 0 for v in self.dictionary.values())

    def num_variables(self) -> int:
        return max((len(k) for k in self.dictionary), default=0)

    def __eq__(self, other) -> bool:
        if not isinstance(other, MPolynomial):
            return NotImplemented

        def norm(d):
            n = max((len(k) for k in d), default=0)
            return {
                tuple(k) + (0,) * (n - len(k)): v
                for k, v in d.items()
                if v != 0
            }

        return norm(self.dictionary) == norm(other.dictionary)

    def __repr__(self) -> str:
        return f"MPolynomial({self.dictionary})"

    # -- evaluation ----------------------------------------------------------

    def evaluate(self, point: Sequence[int]) -> int:
        """Evaluate at a scalar point (ref: m_polynomial.rs:94-122)."""
        p = self.field.order
        acc = 0
        for exponents, coeff in self.dictionary.items():
            prod = coeff
            for index, exponent in enumerate(exponents):
                prod = prod * pow(point[index], exponent, p) % p
            acc = (acc + prod) % p
        return acc

    def evaluate_symbolic(self, point: Sequence[Polynomial]) -> Polynomial:
        """Compose with univariate polynomials (ref: m_polynomial.rs:124-139).

        Host reference implementation; the prover computes the same polynomial
        via pointwise codeword evaluation + iNTT on device.
        """
        acc = Polynomial.zero(self.field)
        for exponents, coeff in self.dictionary.items():
            prod = Polynomial(self.field, [coeff])
            for index, exponent in enumerate(exponents):
                prod = prod * (point[index] ** exponent)
            acc = acc + prod
        return acc

    # -- arithmetic ----------------------------------------------------------

    def __neg__(self) -> "MPolynomial":
        p = self.field.order
        return MPolynomial(
            self.field, {k: (-v) % p for k, v in self.dictionary.items()}
        )

    def __add__(self, other: "MPolynomial") -> "MPolynomial":
        if not self.dictionary:
            return MPolynomial(other.field, dict(other.dictionary))
        if not other.dictionary:
            return MPolynomial(self.field, dict(self.dictionary))
        p = self.field.order
        nvars = max(self.num_variables(), other.num_variables())
        out: dict[tuple[int, ...], int] = {}
        for k, v in self.dictionary.items():
            key = tuple(k) + (0,) * (nvars - len(k))
            out[key] = (out.get(key, 0) + v) % p
        for k, v in other.dictionary.items():
            key = tuple(k) + (0,) * (nvars - len(k))
            out[key] = (out.get(key, 0) + v) % p
        return MPolynomial(self.field, out)

    def __sub__(self, other: "MPolynomial") -> "MPolynomial":
        return self + (-other)

    def __mul__(self, other: "MPolynomial") -> "MPolynomial":
        p = self.field.order
        nvars = max(self.num_variables(), other.num_variables())
        out: dict[tuple[int, ...], int] = {}
        for k0, v0 in self.dictionary.items():
            if v0 == 0:
                continue
            for k1, v1 in other.dictionary.items():
                exp = [0] * nvars
                for i, e in enumerate(k0):
                    exp[i] += e
                for i, e in enumerate(k1):
                    exp[i] += e
                key = tuple(exp)
                out[key] = (out.get(key, 0) + v0 * v1) % p
        return MPolynomial(self.field, out)

    def __pow__(self, exponent: int) -> "MPolynomial":
        if self.is_zero():
            return MPolynomial.zero(self.field)
        nvars = len(next(iter(self.dictionary)))
        acc = MPolynomial(self.field, {(0,) * nvars: 1})
        if exponent == 0:
            return acc
        for bit in bin(exponent)[2:]:
            acc = acc * acc
            if bit == "1":
                acc = acc * self
        return acc

    __xor__ = __pow__
