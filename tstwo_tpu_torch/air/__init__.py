"""AIR traits: components, traces, accumulators.

reference air/index.ts:26-135.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Protocol, runtime_checkable

from ..pcs.utils import TreeVec

PREPROCESSED_TRACE_IDX = 0
ORIGINAL_TRACE_IDX = 1
INTERACTION_TRACE_IDX = 2


@dataclass
class Trace:
    """Polynomials + evaluations per commitment tree
    (reference air/index.ts Trace: the two TreeVecs must share their
    tree/column structure)."""

    polys: TreeVec
    evals: TreeVec

    def device(self):
        """The device the trace's columns live on (cpu for an empty trace)."""
        for tree in self.polys:
            for p in tree:
                return p.coeffs.device
        return "cpu"

    def __post_init__(self):
        if len(self.polys) != len(self.evals):
            raise ValueError("polys/evals tree structure mismatch")
        for t, (p, e) in enumerate(zip(self.polys, self.evals)):
            if len(p) != len(e):
                raise ValueError(
                    f"polys/evals column structure mismatch in tree {t}")


@runtime_checkable
class Component(Protocol):
    def n_constraints(self) -> int: ...

    def max_constraint_log_degree_bound(self) -> int: ...

    def trace_log_degree_bounds(self) -> TreeVec: ...

    def mask_points(self, point) -> TreeVec: ...

    def preprocessed_column_indices(self) -> List[int]: ...

    def evaluate_constraint_quotients_at_point(
        self, point, mask, evaluation_accumulator) -> None: ...


@runtime_checkable
class ComponentProver(Component, Protocol):
    def evaluate_constraint_quotients_on_domain(
        self, trace: Trace, evaluation_accumulator) -> None: ...


from .accumulator import (ColumnAccumulator,  # noqa: E402,F401
                          DomainEvaluationAccumulator,
                          PointEvaluationAccumulator)
from .components import Components, ComponentProvers  # noqa: E402,F401
