"""Accumulators for random linear combinations of constraint quotients.

f(p) = sum_i alpha^{N-1-i} u_i(p)  (reference air/accumulator.ts).
"""
from __future__ import annotations

from typing import List, Optional

import torch

from ..circle import CanonicCoset
from ..fields import QM31
from ..ops import qm31 as qm31_ops
from ..poly.circle_poly import SecureCirclePoly, SecureEvaluation
from ..poly.twiddles import TwiddleTree
from ..utils import entry_device


class PointEvaluationAccumulator:
    """Horner accumulation at a point (reference air/accumulator.ts:33-80)."""

    def __init__(self, random_coeff: QM31):
        self.random_coeff = random_coeff
        self.accumulation = QM31.zero()

    def accumulate(self, evaluation: QM31) -> None:
        self.accumulation = self.accumulation * self.random_coeff + evaluation

    def finalize(self) -> QM31:
        return self.accumulation


class ColumnAccumulator:
    """Per-log-size accumulation target (reference air/accumulator.ts:91).

    Writes flow back into the parent accumulator's sub-accumulation.
    """

    def __init__(self, random_coeff_powers: List[QM31], parent, log_size: int):
        self.random_coeff_powers = random_coeff_powers
        self._parent = parent
        self._log_size = log_size

    @property
    def col(self) -> torch.Tensor:
        return self._parent.sub_accumulations[self._log_size]

    @col.setter
    def col(self, values: torch.Tensor) -> None:
        self._parent.sub_accumulations[self._log_size] = values

    def accumulate_column(self, values: torch.Tensor) -> None:
        self._parent.sub_accumulations[self._log_size] = qm31_ops.add(
            self.col, values)


class DomainEvaluationAccumulator:
    """reference air/accumulator.ts:91-250."""

    def __init__(self, random_coeff: QM31, max_log_size: int,
                 total_columns: int, twiddles: Optional[TwiddleTree] = None,
                 device=None):
        self.random_coeff_powers = generate_secure_powers(
            random_coeff, total_columns)
        self.sub_accumulations: List[Optional[torch.Tensor]] = (
            [None] * (max_log_size + 1))
        self.twiddles = twiddles
        self.device = entry_device(device)

    def columns(self, n_cols_per_size) -> List[ColumnAccumulator]:
        """Hand out accumulators; the i-th column overall gets
        alpha^{N-1-i} (coeff list is consumed from the END)."""
        log_sizes = [ls for ls, _ in n_cols_per_size]
        if len(set(log_sizes)) != len(log_sizes):
            raise ValueError("duplicate log sizes")
        out = []
        for log_size, n_cols in n_cols_per_size:
            if n_cols > len(self.random_coeff_powers):
                raise ValueError("not enough random coefficients")
            coeffs = self.random_coeff_powers[-n_cols:]
            del self.random_coeff_powers[-n_cols:]
            if self.sub_accumulations[log_size] is None:
                self.sub_accumulations[log_size] = qm31_ops.zeros(
                    (1 << log_size,), self.device)
            out.append(ColumnAccumulator(coeffs, self, log_size))
        return out

    def log_size(self) -> int:
        return len(self.sub_accumulations) - 1

    def finalize(self) -> SecureCirclePoly:
        """Combine sub-accumulations small->large by evaluate-and-add
        (reference air/accumulator.ts:193-250)."""
        if self.random_coeff_powers:
            raise ValueError("not all random coefficients were used")
        cur_poly: Optional[SecureCirclePoly] = None
        for log_size in range(1, self.log_size() + 1):
            values = self.sub_accumulations[log_size]
            if values is None:
                continue
            domain = CanonicCoset.new(log_size).circle_domain()
            if cur_poly is not None:
                prev_eval = cur_poly.evaluate(domain, self.twiddles)
                values = qm31_ops.add(values, prev_eval.values)
            cur_poly = SecureEvaluation(domain, values).interpolate(self.twiddles)
        if cur_poly is None:
            return SecureCirclePoly(qm31_ops.zeros((1,), self.device))
        return cur_poly


def generate_secure_powers(felt: QM31, n_powers: int) -> List[QM31]:
    """[1, felt, felt^2, ...] (reference air/accumulator.ts:258-268)."""
    out = []
    cur = QM31.one()
    for _ in range(n_powers):
        out.append(cur)
        cur = cur * felt
    return out
