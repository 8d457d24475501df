"""Lookup-argument utilities (reference lookups/utils.ts): the projective
fraction the constraint framework's LogUp surface sums."""
from __future__ import annotations

from dataclasses import dataclass

from ..fields import QM31


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
