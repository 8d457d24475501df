"""LogUp lookup surface of the constraint framework (Rust stwo
constraint_framework/logup.rs): the parts the evaluators use.

  * `LookupElements` -- channel-drawn (z, alpha); combine(v) = sum_i
    alpha^i * v_i - z.
  * `RelationEntry` -- (relation, multiplicity, values) added to the
    running LogUp sum by `EvalAtRow.add_to_relation`.
  * `LogupAtRow` -- per-evaluation state: collected fractions and the
    cumsum shift (claimed_sum / 2^log_size), finalized into constraints.

The interaction-trace generator is not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

from ..fields import M31, QM31
from ..lookups.utils import Fraction

P = (1 << 31) - 1


class LookupElements:
    """Channel-drawn lookup randomness (stwo logup.rs `LookupElements<N>`)."""

    def __init__(self, z: QM31, alpha: QM31, n: int):
        self.z = z
        self.alpha = alpha
        self.alpha_powers: List[QM31] = []
        cur = QM31.one()
        for _ in range(n):
            self.alpha_powers.append(cur)
            cur = cur * alpha

    @staticmethod
    def draw(channel, n: int) -> "LookupElements":
        z, alpha = channel.draw_felts(2)
        return LookupElements(z, alpha, n)

    @staticmethod
    def dummy(n: int) -> "LookupElements":
        return LookupElements(QM31.one(), QM31.one(), n)

    def get_size(self) -> int:
        return len(self.alpha_powers)

    def get_name(self) -> str:
        return f"lookup_elements_{len(self.alpha_powers)}"

    def combine(self, values: Sequence):
        """sum_i alpha^i * v_i - z, for host QM31 scalars or device column
        expressions (values lead the products so expression __mul__ wins)."""
        if len(values) > len(self.alpha_powers):
            raise ValueError(
                f"relation of size {len(self.alpha_powers)} combining "
                f"{len(values)} values")
        acc = None
        for v, power in zip(values, self.alpha_powers):
            term = v * power
            acc = term if acc is None else acc + term
        return acc - self.z

    def bind(self, evaluator) -> "_BoundRelation":
        """Materialize (z, alpha_powers) through the evaluator's
        `secure_param` hook: host values on the point/assert paths, traced
        kernel arguments on the domain path (keeps the jitted constraint
        kernel reusable across proofs with fresh channel randomness)."""
        return _BoundRelation(
            [evaluator.secure_param(p) for p in self.alpha_powers],
            evaluator.secure_param(self.z))

    def __eq__(self, o) -> bool:
        return (isinstance(o, LookupElements) and o.z == self.z
                and o.alpha == self.alpha
                and len(o.alpha_powers) == len(self.alpha_powers))


class _BoundRelation:
    """LookupElements view with evaluator-materialized randomness."""

    def __init__(self, alpha_powers, z):
        self.alpha_powers = alpha_powers
        self.z = z

    def combine(self, values: Sequence):
        if len(values) > len(self.alpha_powers):
            raise ValueError("combining more values than relation size")
        acc = None
        for v, power in zip(values, self.alpha_powers):
            term = v * power
            acc = term if acc is None else acc + term
        return acc - self.z


@dataclass
class RelationEntry:
    """One use of a relation at a row: multiplicity / combine(values)
    (stwo constraint_framework RelationEntry::new)."""

    relation: LookupElements
    multiplicity: object
    values: Sequence


class LogupAtRow:
    """Running LogUp state inside an evaluator (stwo logup.rs LogupAtRow).

    The claimed sum is spread evenly over the rows as `cumsum_shift =
    claimed_sum / 2^log_size`, so the last cumulative column sums to zero
    around the coset and no `is_first` preprocessed column is needed."""

    def __init__(self, interaction: int, claimed_sum: QM31, log_size: int):
        self.interaction = interaction
        self.claimed_sum = claimed_sum
        self.log_size = log_size
        self.cumsum_shift = claimed_sum.mul_m31(
            M31.from_int(1 << log_size).inverse()) if log_size else QM31.zero()
        self.fracs: List[Fraction] = []
        self.is_finalized = True  # becomes False on the first write

    @staticmethod
    def dummy() -> "LogupAtRow":
        from ..air import INTERACTION_TRACE_IDX

        return LogupAtRow(INTERACTION_TRACE_IDX, QM31.zero(), 0)
