"""Lookup-argument utilities: univariate polys, eq kernel, fractions.
Host QM31 scalars only (reference lookups/utils.ts).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

from ..fields import QM31


def horner_eval(coeffs: Sequence[QM31], x: QM31) -> QM31:
    acc = QM31.zero()
    for c in reversed(coeffs):
        acc = acc * x + c
    return acc


class UnivariatePoly:
    """QM31 polynomial in monomial basis (reference lookups/utils.ts:6)."""

    def __init__(self, coeffs: Sequence[QM31]):
        self.coeffs = list(coeffs)
        self._truncate()

    def _truncate(self):
        while self.coeffs and self.coeffs[-1].is_zero():
            self.coeffs.pop()

    @staticmethod
    def zero() -> "UnivariatePoly":
        return UnivariatePoly([])

    @staticmethod
    def from_value(v: QM31) -> "UnivariatePoly":
        return UnivariatePoly([v])

    def eval_at_point(self, x: QM31) -> QM31:
        return horner_eval(self.coeffs, x)

    def degree(self) -> int:
        i = len(self.coeffs) - 1
        while i >= 0 and self.coeffs[i].is_zero():
            i -= 1
        return max(0, i)

    def is_zero(self) -> bool:
        return all(c.is_zero() for c in self.coeffs)

    def mul_scalar(self, v: QM31) -> "UnivariatePoly":
        return UnivariatePoly([c * v for c in self.coeffs])

    def add(self, o: "UnivariatePoly") -> "UnivariatePoly":
        n = max(len(self.coeffs), len(o.coeffs))
        out = []
        for i in range(n):
            a = self.coeffs[i] if i < len(self.coeffs) else QM31.zero()
            b = o.coeffs[i] if i < len(o.coeffs) else QM31.zero()
            out.append(a + b)
        return UnivariatePoly(out)

    def mul(self, o: "UnivariatePoly") -> "UnivariatePoly":
        if not self.coeffs or not o.coeffs:
            return UnivariatePoly([])
        out = [QM31.zero()] * (len(self.coeffs) + len(o.coeffs) - 1)
        for i, a in enumerate(self.coeffs):
            for j, b in enumerate(o.coeffs):
                out[i + j] = out[i + j] + a * b
        return UnivariatePoly(out)

    @staticmethod
    def interpolate_lagrange(xs: Sequence[QM31],
                             ys: Sequence[QM31]) -> "UnivariatePoly":
        if len(xs) != len(ys):
            raise ValueError("xs/ys length mismatch")
        if not xs:
            raise ValueError("cannot interpolate with empty arrays")
        acc = UnivariatePoly.zero()
        for i, (xi, yi) in enumerate(zip(xs, ys)):
            prod = yi
            for j, xj in enumerate(xs):
                if i != j:
                    prod = prod * (xi - xj).inverse()
            term = UnivariatePoly([prod])
            for j, xj in enumerate(xs):
                if i != j:
                    term = term.mul(UnivariatePoly([-xj, QM31.one()]))
            acc = acc.add(term)
        return acc

    def get_coeffs(self) -> List[QM31]:
        return list(self.coeffs)


def random_linear_combination(values: Sequence[QM31], alpha: QM31) -> QM31:
    """p_0 + alpha p_1 + ... (reference lookups/utils.ts:214-216)."""
    return horner_eval(values, alpha)


def random_linear_combination_polys(polys: Sequence[UnivariatePoly],
                                    alpha: QM31) -> UnivariatePoly:
    acc = UnivariatePoly.zero()
    for p in reversed(polys):
        acc = acc.mul_scalar(alpha).add(p)
    return acc


def eq(x: Sequence[QM31], y: Sequence[QM31]) -> QM31:
    """Lagrange kernel of the boolean hypercube
    (reference lookups/utils.ts:222-253)."""
    if len(x) != len(y):
        raise ValueError("x and y must have the same length")
    # NOTE: empty points return one (the empty product) -- the GKR batch
    # verifier evaluates eq over the instance-used suffix, which is empty
    # for the largest instance.  (The reference TS throws here; that guard
    # is a TS-ism, not Rust behavior.)
    one = QM31.one()
    acc = one
    for xi, yi in zip(x, y):
        acc = acc * (xi * yi + (one - xi) * (one - yi))
    return acc


def fold_mle_evals(assignment: QM31, eval0, eval1) -> QM31:
    """eq(0,a)*e0 + eq(1,a)*e1 (reference lookups/utils.ts:256-279)."""
    e0 = eval0 if isinstance(eval0, QM31) else QM31.from_base(eval0)
    e1 = eval1 if isinstance(eval1, QM31) else QM31.from_base(eval1)
    return assignment * (e1 - e0) + e0


@dataclass
class Fraction:
    """Projective fraction (reference lookups/utils.ts:282)."""

    numerator: QM31
    denominator: QM31

    def __add__(self, o: "Fraction") -> "Fraction":
        return Fraction(
            o.denominator * self.numerator + self.denominator * o.numerator,
            self.denominator * o.denominator,
        )

    @staticmethod
    def zero() -> "Fraction":
        return Fraction(QM31.zero(), QM31.one())

    def is_zero(self) -> bool:
        return self.numerator.is_zero() and not self.denominator.is_zero()


@dataclass
class Reciprocal:
    """1/x (reference lookups/utils.ts:379)."""

    x: QM31

    def __add__(self, o: "Reciprocal") -> Fraction:
        return Fraction(self.x + o.x, self.x * o.x)

    def __sub__(self, o: "Reciprocal") -> Fraction:
        return Fraction(o.x - self.x, self.x * o.x)
