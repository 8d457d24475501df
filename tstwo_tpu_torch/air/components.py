"""Components / ComponentProvers aggregation (reference air/components.ts)."""
from __future__ import annotations

from typing import List

from ..fields import QM31
from ..pcs.utils import TreeVec, concat_cols
from . import PREPROCESSED_TRACE_IDX, Trace
from .accumulator import (DomainEvaluationAccumulator,
                          PointEvaluationAccumulator)


class Components:
    def __init__(self, components: List, n_preprocessed_columns: int):
        self.components = list(components)
        self.n_preprocessed_columns = n_preprocessed_columns

    def composition_log_degree_bound(self) -> int:
        return max(c.max_constraint_log_degree_bound() for c in self.components)

    def mask_points(self, point) -> TreeVec:
        """Concat component masks; preprocessed columns used by any component
        get [point] (reference air/components.ts:84-113)."""
        mask_points = concat_cols([c.mask_points(point) for c in self.components])
        if len(mask_points) > PREPROCESSED_TRACE_IDX:
            preprocessed = [[] for _ in range(self.n_preprocessed_columns)]
            for c in self.components:
                for idx in c.preprocessed_column_indices():
                    preprocessed[idx] = [point]
            mask_points[PREPROCESSED_TRACE_IDX] = preprocessed
        return mask_points

    def eval_composition_polynomial_at_point(self, point, mask_values,
                                             random_coeff: QM31) -> QM31:
        acc = PointEvaluationAccumulator(random_coeff)
        for c in self.components:
            c.evaluate_constraint_quotients_at_point(point, mask_values, acc)
        return acc.finalize()

    def column_log_sizes(self) -> TreeVec:
        """reference air/components.ts:135-185."""
        preprocessed_sizes = [None] * self.n_preprocessed_columns
        per_component = []
        for c in self.components:
            sizes = c.trace_log_degree_bounds()
            idxs = c.preprocessed_column_indices()
            pre = sizes[PREPROCESSED_TRACE_IDX] if len(sizes) else []
            for i, col_idx in enumerate(idxs):
                ls = pre[i]
                if preprocessed_sizes[col_idx] is not None:
                    if preprocessed_sizes[col_idx] != ls:
                        raise ValueError(
                            f"preprocessed column size mismatch at {col_idx}")
                else:
                    preprocessed_sizes[col_idx] = ls
            per_component.append(sizes)
        if any(s is None for s in preprocessed_sizes):
            raise ValueError("column size not set for preprocessed column")
        out = concat_cols(per_component)
        out[PREPROCESSED_TRACE_IDX] = preprocessed_sizes
        return out


class ComponentProvers(Components):
    def compute_composition_polynomial(self, random_coeff: QM31,
                                       trace: Trace, twiddles=None):
        total_constraints = sum(c.n_constraints() for c in self.components)
        acc = DomainEvaluationAccumulator(
            random_coeff, self.composition_log_degree_bound(),
            total_constraints, twiddles, trace.device())
        for c in self.components:
            c.evaluate_constraint_quotients_on_domain(trace, acc)
        return acc.finalize()
