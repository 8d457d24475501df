"""LogUp lookup surface of the constraint framework (Rust stwo
constraint_framework/logup.rs): the parts the evaluators use.

  * `LookupElements` -- channel-drawn (z, alpha); combine(v) = sum_i
    alpha^i * v_i - z.
  * `RelationEntry` -- (relation, multiplicity, values) added to the
    running LogUp sum by `EvalAtRow.add_to_relation`.
  * `LogupAtRow` -- per-evaluation state: collected fractions and the
    cumsum shift (claimed_sum / 2^log_size), finalized into constraints.
  * `LogupTraceGenerator` -- builds the interaction-trace secure columns:
    per-batch column = running column sum of num/denom per row; the last
    column additionally takes a coset-order inclusive prefix sum with the
    per-row cumsum shift subtracted, so the grand total telescopes to zero
    around the coset.

Array-first: a "row write" is a whole-column write; fractions accumulate
projectively on the columns' device (QM31 SoA int32 [4, n] tensors).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import torch

from ..circle import CanonicCoset
from ..fields import M31, QM31
from ..lookups.utils import Fraction
from ..ops import qm31 as qm31_ops
from ..ops.prefix_sum import inclusive_prefix_sum_bit_rev_circle
from ..poly.circle_poly import CircleEvaluation
from ..tracing import count, span
from ..utils import entry_device, to_host_list

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

    def combine_cols(self, cols: Sequence[torch.Tensor]) -> torch.Tensor:
        """Device-column combine for interaction-trace generation: cols are
        int32 [n] base columns or int32 [4, n] secure columns; returns the
        QM31 column sum_i alpha^i * col_i - z as int32 [4, n]."""
        if len(cols) > len(self.alpha_powers):
            raise ValueError("combining more columns than relation size")
        acc = None
        for v, power in zip(cols, self.alpha_powers):
            arr = qm31_ops.from_m31(v) if v.dim() == 1 else v
            term = qm31_ops.mul(arr, qm31_ops.scalar(power, device=v.device)
                                [:, None])
            acc = term if acc is None else qm31_ops.add(acc, term)
        return qm31_ops.sub(acc, qm31_ops.scalar(self.z, device=acc.device)
                            [:, None])

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


class LogupColGenerator:
    """One interaction column: fractions accumulate projectively per row."""

    def __init__(self, gen: "LogupTraceGenerator"):
        self.gen = gen
        self._num = None  # int32 [4, n], or [4, 1] for a scalar
        self._den = None

    def _coerce(self, x) -> torch.Tensor:
        device = self.gen.device
        if isinstance(x, QM31):
            return qm31_ops.scalar(x, device=device)[:, None]
        if isinstance(x, (int, M31)):
            v = x.value if isinstance(x, M31) else x % P
            return qm31_ops.scalar(QM31.from_u32_unchecked(v, 0, 0, 0),
                                   device=device)[:, None]
        return qm31_ops.from_m31(x) if x.dim() == 1 else x

    def write_frac(self, numerator, denominator) -> None:
        """Add numerator/denominator (whole columns, or scalars broadcast
        over all rows) to this column's per-row fraction."""
        num, den = self._coerce(numerator), self._coerce(denominator)
        count("logup_fractions", 1 << self.gen.log_size)
        if self._num is None:
            self._num, self._den = num, den
        else:
            self._num = qm31_ops.add(qm31_ops.mul(num, self._den),
                                     qm31_ops.mul(self._num, den))
            self._den = qm31_ops.mul(self._den, den)

    def finalize_col(self) -> None:
        if self._num is None:
            raise ValueError("finalize_col before any write_frac")
        n = 1 << self.gen.log_size
        col = qm31_ops.mul(self._num, qm31_ops.inv(self._den))
        col = col.expand(4, n).contiguous()
        if self.gen._cols:
            col = qm31_ops.add(col, self.gen._cols[-1])
        self.gen._cols.append(col)
        count("logup_columns", 1)


class LogupTraceGenerator:
    """Builds the LogUp interaction trace (stwo logup.rs
    LogupTraceGenerator): one secure column per finalize batch; columns are
    running column sums; `finalize_last` prefix-sums the final column in
    coset order and returns (base-coordinate evaluations, claimed_sum).
    Scalars written to a column are placed on `device`, the device of the
    trace columns: CUDA device 0 unless the caller names one
    (`utils.entry_device`)."""

    def __init__(self, log_size: int, device=None):
        self.log_size = log_size
        self.device = entry_device(device)
        self._cols: List[torch.Tensor] = []
        self._span = None  # `interaction_trace`: first column to the end

    def new_col(self) -> LogupColGenerator:
        if self._span is None:
            self._span = span("interaction_trace")
            self._span.__enter__()
        return LogupColGenerator(self)

    def finalize_last(self):
        try:
            return self._finalize_last()
        finally:
            if self._span is not None:
                self._span.__exit__(None, None, None)
                self._span = None

    def _finalize_last(self):
        if not self._cols:
            raise ValueError("no interaction columns written")
        last = self._cols[-1]
        # claimed sum: exact coordinate-wise total; each coordinate sums
        # fewer than 2^32 values below 2^31 in int64, then one reduction
        # and one transfer
        totals = to_host_list(last.to(torch.int64).sum(dim=1) % P)
        claimed_sum = QM31.from_ints(totals)
        cumsum_shift = claimed_sum.mul_m31(
            M31.from_int(1 << self.log_size).inverse())
        shifted = qm31_ops.sub(
            last, qm31_ops.scalar(cumsum_shift, device=last.device)[:, None])
        self._cols[-1] = inclusive_prefix_sum_bit_rev_circle(
            shifted, self.log_size)
        domain = CanonicCoset.new(self.log_size).circle_domain()
        evals = [CircleEvaluation(domain, col[c])
                 for col in self._cols for c in range(4)]
        return evals, claimed_sum
