"""Constraint framework: define AIR components by a single `evaluate`
function, run through interchangeable evaluators.

The user writes `evaluate(eval)` once against the EvalAtRow interface; it is
executed with:
  * InfoEvaluator   -- counts constraints and mask structure,
  * PointEvaluator  -- OODS evaluation on host QM31 scalars,
  * ProgramRecorder -- lowers the constraints once to a constraint
                       program (program.py), which the prover runs over
                       the whole evaluation domain in one kernel launch
                       (ops/constraint_eval.py),
  * DomainEvaluator -- whole-domain evaluation on device columns, every
                       constraint once over all rows, eagerly (the analog
                       of Rust's SimdDomainEvaluator; the programs' oracle),
  * AssertEvaluator -- debug: checks constraints vanish on the trace domain.

reference constraint_framework/index.ts (whose domain path is a TS
placeholder; semantics re-derived from Rust stwo constraint_framework).
"""
from __future__ import annotations

from functools import lru_cache
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..air import (INTERACTION_TRACE_IDX, ORIGINAL_TRACE_IDX,
                   PREPROCESSED_TRACE_IDX, Trace)
from ..air.accumulator import (DomainEvaluationAccumulator,
                               PointEvaluationAccumulator)
from ..circle import CanonicCoset, CirclePoint
from ..constraints import coset_vanishing
from ..fields import M31, QM31
from ..lookups.utils import Fraction
from ..ops import constraint_eval
from ..ops import qm31 as qm31_ops
from ..pcs import TreeSubspan
from ..pcs.utils import TreeVec
from ..tracing import count
from ..utils import bit_reverse_permutation, upload
from .expr import BaseExpr, SecureExpr
from .logup import LogupAtRow, LookupElements, RelationEntry
from .preprocessed import PreProcessedColumnId

P = (1 << 31) - 1


class TraceLocationAllocator:
    """Allocates column spans in commitment trees to components
    (Rust constraint_framework TraceLocationAllocator).  Preprocessed
    columns are global, id-addressed slots in tree 0: static mode (ids
    given up front) rejects unknown ids; dynamic mode appends them."""

    def __init__(self, preprocessed_columns: Optional[
            Sequence[PreProcessedColumnId]] = None):
        self.next_tree_offsets: List[int] = []
        self.preprocessed_columns: List[PreProcessedColumnId] = list(
            preprocessed_columns or [])
        self._static = preprocessed_columns is not None

    @staticmethod
    def new_with_preprocessed_columns(
            ids: Sequence[PreProcessedColumnId]) -> "TraceLocationAllocator":
        return TraceLocationAllocator(ids)

    def preprocessed_index(self, cid: PreProcessedColumnId) -> int:
        for i, c in enumerate(self.preprocessed_columns):
            if c == cid:
                return i
        if self._static:
            raise ValueError(
                f"preprocessed column {cid.id} not declared in allocator")
        self.preprocessed_columns.append(cid)
        return len(self.preprocessed_columns) - 1

    def next_for_structure(self, structure: TreeVec) -> List[TreeSubspan]:
        while len(self.next_tree_offsets) < len(structure):
            self.next_tree_offsets.append(0)
        out = []
        for tree_index, cols in enumerate(structure):
            start = self.next_tree_offsets[tree_index]
            end = start + len(cols)
            self.next_tree_offsets[tree_index] = end
            out.append(TreeSubspan(tree_index, start, end))
        return out


class _LogupEvalMixin:
    """Shared EvalAtRow LogUp surface (stwo constraint_framework logup.rs):
    `add_to_relation` collects fractions; `finalize_logup*` emits the
    cumulative-sum constraints over the interaction trace."""

    def _init_logup(self, claimed_sum: Optional[QM31], log_size: int):
        self.logup = LogupAtRow(
            INTERACTION_TRACE_IDX,
            claimed_sum if claimed_sum is not None else QM31.zero(),
            log_size)

    @staticmethod
    def _coerce_multiplicity(m):
        if isinstance(m, bool) or isinstance(m, int):
            return QM31.from_u32_unchecked(m % P, 0, 0, 0)
        if isinstance(m, M31):
            return QM31.from_base(m)
        return m

    def secure_param(self, value: QM31):
        """Register a per-proof secure-field scalar (channel-drawn
        randomness such as lookup elements).  The domain path turns it
        into a device scalar; elsewhere the host value is returned as-is."""
        return value

    def add_to_relation(self, *entries: RelationEntry) -> None:
        for e in entries:
            den = e.relation.bind(self).combine(list(e.values))
            self.write_logup_frac(
                Fraction(self._coerce_multiplicity(e.multiplicity), den))

    def write_logup_frac(self, frac: Fraction) -> None:
        self.logup.is_finalized = False
        self.logup.fracs.append(frac)

    def next_extension_interaction_mask(self, interaction: int,
                                        offsets: Sequence[int]):
        """Read one secure column (4 base coordinate columns) of the
        interaction trace at the given offsets."""
        coords = [self.next_interaction_mask(interaction, offsets)
                  for _ in range(4)]
        return [self.combine_ef([coords[c][j] for c in range(4)])
                for j in range(len(offsets))]

    def finalize_logup_batched(self, batching: Sequence[int]) -> None:
        lg = self.logup
        if lg.is_finalized:
            raise ValueError("logup already finalized (or no fracs written)")
        if len(batching) != len(lg.fracs):
            raise ValueError(
                f"batching len {len(batching)} != {len(lg.fracs)} fracs")
        n_batches = max(batching) + 1
        sums: List[Optional[Fraction]] = [None] * n_batches
        for b, frac in zip(batching, lg.fracs):
            sums[b] = frac if sums[b] is None else sums[b] + frac
        if any(s is None for s in sums):
            raise ValueError("empty logup batch")
        prev_col_cumsum = None
        for i, frac in enumerate(sums):
            if i == n_batches - 1:
                # last column: prev-row mask + evenly-spread claimed sum
                cur, prev_row = self.next_extension_interaction_mask(
                    lg.interaction, [0, -1])
                diff = cur - prev_row
                if prev_col_cumsum is not None:
                    diff = diff - prev_col_cumsum
                diff = diff + lg.cumsum_shift
            else:
                (cur,) = self.next_extension_interaction_mask(
                    lg.interaction, [0])
                diff = (cur if prev_col_cumsum is None
                        else cur - prev_col_cumsum)
                prev_col_cumsum = cur
            self.add_constraint(diff * frac.denominator - frac.numerator)
        lg.is_finalized = True

    def finalize_logup(self) -> None:
        self.finalize_logup_batched(list(range(len(self.logup.fracs))))

    def finalize_logup_in_pairs(self) -> None:
        self.finalize_logup_batched(
            [i // 2 for i in range(len(self.logup.fracs))])


class _Anything:
    """Absorbing symbolic value for InfoEvaluator."""

    def _op(self, *_):
        return self

    __add__ = __radd__ = __sub__ = __rsub__ = __mul__ = __rmul__ = _op
    __neg__ = _op

    def square(self):
        return self


class InfoEvaluator(_LogupEvalMixin):
    """Counts constraints and mask offsets per interaction."""

    def __init__(self, log_size: int = 0):
        self.mask_offsets = TreeVec()
        self.n_constraints = 0
        self.preprocessed_columns: List[PreProcessedColumnId] = []
        self.secure_params: List[QM31] = []
        self._init_logup(None, 0)  # structure only; shift is absorbed

    def secure_param(self, value: QM31) -> QM31:
        self.secure_params.append(value)
        return value

    def get_preprocessed_column(self, cid: PreProcessedColumnId):
        self.preprocessed_columns.append(cid)
        return _Anything()

    def _ensure(self, interaction: int):
        while len(self.mask_offsets) <= interaction:
            self.mask_offsets.append([])

    def next_trace_mask(self):
        return self.next_interaction_mask(ORIGINAL_TRACE_IDX, [0])[0]

    def next_interaction_mask(self, interaction: int,
                              offsets: Sequence[int]):
        self._ensure(interaction)
        self.mask_offsets[interaction].append(list(offsets))
        return [_Anything() for _ in offsets]

    def add_constraint(self, _constraint) -> None:
        self.n_constraints += 1

    @staticmethod
    def combine_ef(values):
        return _Anything()


class PointEvaluator(_LogupEvalMixin):
    """Mask-value evaluation at the OODS point (host scalars)."""

    def __init__(self, mask: TreeVec, accumulator: PointEvaluationAccumulator,
                 denom_inverse: QM31, claimed_sum: Optional[QM31] = None,
                 log_size: int = 0):
        self.mask = mask
        self.accumulator = accumulator
        self.denom_inverse = denom_inverse
        self.col_index = [0] * len(mask)
        self._init_logup(claimed_sum, log_size)

    def get_preprocessed_column(self, cid: PreProcessedColumnId) -> QM31:
        return self.next_interaction_mask(PREPROCESSED_TRACE_IDX, [0])[0]

    def next_trace_mask(self) -> QM31:
        return self.next_interaction_mask(ORIGINAL_TRACE_IDX, [0])[0]

    def next_interaction_mask(self, interaction: int,
                              offsets: Sequence[int]) -> List[QM31]:
        idx = self.col_index[interaction]
        self.col_index[interaction] += 1
        values = self.mask[interaction][idx]
        if len(values) != len(offsets):
            raise ValueError("mask length mismatch")
        return list(values)

    def add_constraint(self, constraint: QM31) -> None:
        self.accumulator.accumulate(self.denom_inverse * constraint)

    @staticmethod
    def combine_ef(values: Sequence[QM31]) -> QM31:
        return QM31.from_partial_evals(list(values))


@lru_cache(maxsize=None)
def _offset_perm(trace_log: int, eval_log: int, offset: int) -> np.ndarray:
    """Committed row i of the eval domain reads row perm[i] for a mask at
    `offset` trace steps: the values of the JAX package's per-row loop
    (utils.offset_bit_reversed_circle_domain_index, or the coset walk when
    the domains are equal), computed with whole-array numpy."""
    n = 1 << eval_log
    rev = bit_reverse_permutation(eval_log)  # rev[i] = bit_reverse_index(i)
    if trace_log == eval_log:
        # same-domain mask offset: walk the canonic coset order directly
        k = np.where(rev < n // 2, 2 * rev, 2 * (n - 1 - rev) + 1)
        k2 = (k + offset) % n
        perm = rev[np.where(k2 % 2 == 0, k2 // 2, (2 * n - k2) >> 1)]
    else:
        half = n >> 1
        step = offset * (1 << (eval_log - trace_log - 1))
        moved = np.where(rev < half, (rev + step) % half,
                         (rev - step) % half + half)
        perm = rev[moved]
    return perm.astype(np.int32)


def _shifted(col: torch.Tensor, trace_log: int, eval_log: int,
             offset: int) -> BaseExpr:
    """The mask of `col` at `offset` trace steps (offset 0 is `col`)."""
    if offset == 0:
        return BaseExpr(col)
    perm = upload(torch.from_numpy(
        _offset_perm(trace_log, eval_log, offset)).to(torch.int64), col.device)
    return BaseExpr(col.index_select(-1, perm))


class DomainEvaluator(_LogupEvalMixin):
    """Whole-domain constraint evaluation on device columns.

    random_coeff_powers: int32 [n_constraints, 4] (reversed order, so
    constraint 0 gets the highest power); cumsum_shift: int32 [4]
    (claimed_sum / 2^log_size); secure_params: int32 [k, 4]; all on the
    trace's device.
    """

    def __init__(self, trace_evals, trace_domain_log_size: int,
                 eval_domain_log_size: int,
                 random_coeff_powers, cumsum_shift=None, secure_params=None):
        self.trace_evals = trace_evals  # per interaction: list of int32 [n]
        self.trace_domain_log_size = trace_domain_log_size
        self.eval_domain_log_size = eval_domain_log_size
        self.random_coeff_powers = random_coeff_powers
        self.col_index = [0] * len(trace_evals)
        self.constraint_index = 0
        n = 1 << eval_domain_log_size
        self.row_res = SecureExpr(qm31_ops.zeros(
            (n,), random_coeff_powers.device))
        self.logup = LogupAtRow.dummy()
        if cumsum_shift is not None:
            self.logup.cumsum_shift = SecureExpr(cumsum_shift[:, None])
        self._secure_params = secure_params  # int32 [k, 4]
        self._param_index = 0

    def secure_param(self, value: QM31) -> SecureExpr:
        i = self._param_index
        self._param_index += 1
        return SecureExpr(self._secure_params[i][:, None])

    def get_preprocessed_column(self, cid: PreProcessedColumnId) -> BaseExpr:
        return self.next_interaction_mask(PREPROCESSED_TRACE_IDX, [0])[0]

    def next_trace_mask(self) -> BaseExpr:
        return self.next_interaction_mask(ORIGINAL_TRACE_IDX, [0])[0]

    def next_interaction_mask(self, interaction: int,
                              offsets: Sequence[int]) -> List[BaseExpr]:
        idx = self.col_index[interaction]
        self.col_index[interaction] += 1
        col = self.trace_evals[interaction][idx]
        return [_shifted(col, self.trace_domain_log_size,
                         self.eval_domain_log_size, off) for off in offsets]

    def add_constraint(self, constraint) -> None:
        coeff = self.random_coeff_powers[self.constraint_index]  # [4]
        self.constraint_index += 1
        if isinstance(constraint, BaseExpr):
            constraint = SecureExpr(qm31_ops.from_m31(constraint.arr))
        self.row_res = SecureExpr(qm31_ops.add(
            self.row_res.arr, qm31_ops.mul(constraint.arr, coeff[:, None])))

    @staticmethod
    def combine_ef(values: Sequence[BaseExpr]) -> SecureExpr:
        return SecureExpr(torch.stack([v.arr for v in values]))


class AssertEvaluator(_LogupEvalMixin):
    """Debug evaluator: constraints must vanish on the trace domain
    (Rust constraint_framework assert.rs).  trace_evals: per interaction, a
    list of int32 [2^log_size] columns in bit-reversed order."""

    def __init__(self, trace_evals: TreeVec, log_size: int,
                 claimed_sum: Optional[QM31] = None):
        self.trace_evals = trace_evals
        self.log_size = log_size
        self.col_index = [0] * len(trace_evals)
        self._init_logup(claimed_sum, log_size)

    def get_preprocessed_column(self, cid: PreProcessedColumnId) -> BaseExpr:
        return self.next_interaction_mask(PREPROCESSED_TRACE_IDX, [0])[0]

    def next_trace_mask(self) -> BaseExpr:
        return self.next_interaction_mask(ORIGINAL_TRACE_IDX, [0])[0]

    def next_interaction_mask(self, interaction: int,
                              offsets: Sequence[int]) -> List[BaseExpr]:
        idx = self.col_index[interaction]
        self.col_index[interaction] += 1
        col = self.trace_evals[interaction][idx]
        return [_shifted(col, self.log_size, self.log_size, off)
                for off in offsets]

    def add_constraint(self, constraint) -> None:
        arr = constraint.arr if isinstance(constraint, (BaseExpr, SecureExpr)) \
            else constraint
        if bool(torch.as_tensor(arr).any()):
            raise AssertionError("constraint does not vanish on trace domain")

    @staticmethod
    def combine_ef(values: Sequence[BaseExpr]) -> SecureExpr:
        return SecureExpr(torch.stack([v.arr for v in values]))


def assert_constraints(trace_evals: TreeVec, log_size: int, framework_eval,
                       claimed_sum: Optional[QM31] = None) -> None:
    """Check all constraints vanish on the trace domain (debug aid)."""
    ev = AssertEvaluator(trace_evals, log_size, claimed_sum)
    framework_eval.evaluate(ev)
    if not ev.logup.is_finalized:
        raise AssertionError("logup fractions written but never finalized")


class FrameworkEval:
    """User-implemented component description (Rust FrameworkEval trait)."""

    def log_size(self) -> int:
        raise NotImplementedError

    def max_constraint_log_degree_bound(self) -> int:
        raise NotImplementedError

    def evaluate(self, evaluator):
        raise NotImplementedError

    def kernel_cache_key(self):
        """Optional: a hashable key naming everything `evaluate` records
        besides the sizes.  Components whose evals return the same non-None
        key (and type) share one constraint program, so repeated proves
        lower nothing.  None (the default): one program a component."""
        return None


# constraint programs shared by components whose evals give a
# kernel_cache_key(): (eval type, key, trace_log, eval_log) -> program
_PROGRAM_CACHE: dict = {}


class FrameworkComponent:
    """Component + ComponentProver from a FrameworkEval
    (Rust constraint_framework component.rs)."""

    def __init__(self, allocator: TraceLocationAllocator, eval: FrameworkEval,
                 claimed_sum: QM31 = None):
        self.eval = eval
        self.claimed_sum = claimed_sum if claimed_sum is not None else QM31.zero()
        info = InfoEvaluator(eval.log_size())
        eval.evaluate(info)
        if not info.logup.is_finalized:
            raise ValueError("logup fractions written but never finalized")
        # every component owns (empty) spans in the preprocessed + trace trees
        while len(info.mask_offsets) < 2:
            info.mask_offsets.append([])
        # move the implicit preprocessed interaction first if absent
        self.info = info
        self.trace_locations = allocator.next_for_structure(info.mask_offsets)
        self._preprocessed_indices: List[int] = [
            allocator.preprocessed_index(cid)
            for cid in info.preprocessed_columns]
        # per-proof channel randomness captured at construction
        self._secure_params: List[QM31] = list(info.secure_params)
        self._programs: dict = {}  # (trace_log, eval_log) -> program

    # -- Component ----------------------------------------------------------
    def n_constraints(self) -> int:
        return self.info.n_constraints

    def max_constraint_log_degree_bound(self) -> int:
        return self.eval.max_constraint_log_degree_bound()

    def trace_log_degree_bounds(self) -> TreeVec:
        out = TreeVec()
        for i, tree in enumerate(self.info.mask_offsets):
            n_cols = (len(self._preprocessed_indices)
                      if i == PREPROCESSED_TRACE_IDX else len(tree))
            out.append([self.eval.log_size()] * n_cols)
        return out

    def mask_points(self, point) -> TreeVec:
        trace_step = CanonicCoset.new(self.eval.log_size()).step()
        zero = CirclePoint.zero_m31()
        out = TreeVec()
        for tree in self.info.mask_offsets:
            cols = []
            for col_offsets in tree:
                pts = []
                for off in col_offsets:
                    shift = trace_step.mul_signed(off, zero)
                    pts.append(point + shift.into_ef(QM31.from_base))
                cols.append(pts)
            out.append(cols)
        if len(out) > PREPROCESSED_TRACE_IDX:
            out[PREPROCESSED_TRACE_IDX] = [
                [point] for _ in self._preprocessed_indices]
        return out

    def preprocessed_column_indices(self) -> List[int]:
        return list(self._preprocessed_indices)

    def _sub_tree(self, tree_vec: TreeVec) -> TreeVec:
        out = TreeVec()
        for loc in self.trace_locations:
            tree = tree_vec[loc.tree_index] if loc.tree_index < len(tree_vec) else []
            if loc.tree_index == PREPROCESSED_TRACE_IDX:
                # preprocessed columns are global id-addressed slots
                out.append([tree[i] for i in self._preprocessed_indices])
            else:
                out.append(list(tree[loc.col_start: loc.col_end]))
        return out

    def evaluate_constraint_quotients_at_point(
            self, point, mask: TreeVec,
            accumulator: PointEvaluationAccumulator) -> None:
        trace_coset = CanonicCoset.new(self.eval.log_size()).coset
        denom_inverse = coset_vanishing(trace_coset, point).inverse()
        ev = PointEvaluator(self._sub_tree(mask), accumulator, denom_inverse,
                            self.claimed_sum, self.eval.log_size())
        self.eval.evaluate(ev)
        if not ev.logup.is_finalized:
            raise ValueError("logup fractions written but never finalized")

    # -- ComponentProver ----------------------------------------------------
    def constraint_program(self, trace_log: int, eval_log: int):
        """This component's constraints lowered to a constraint program
        (program.py) for a trace of 2^trace_log rows evaluated on 2^eval_log
        points.  Lowered once a component and size; an eval whose
        `kernel_cache_key()` is not None shares it with every component of
        the same eval type and key, so a warm proof lowers nothing."""
        from .program import lower

        program = self._programs.get((trace_log, eval_log))
        if program is not None:
            return program
        shared = self.eval.kernel_cache_key()
        if shared is not None:
            shared = (type(self.eval), shared, trace_log, eval_log)
            program = _PROGRAM_CACHE.get(shared)
        if program is None:
            program = lower(self.eval, trace_log, eval_log)
            count("constraint_programs_built", 1)
            if shared is not None:
                _PROGRAM_CACHE[shared] = program
        self._programs[(trace_log, eval_log)] = program
        return program

    def evaluate_constraint_quotients_on_domain(
            self, trace: Trace,
            accumulator: DomainEvaluationAccumulator) -> None:
        """Add this component's constraint quotients on the evaluation
        domain into `accumulator`: the trace extended (one batched CFFT an
        interaction), then the constraint program over every row, one
        `constraint_eval` launch on the card (the plain executor on the
        CPU)."""
        from ..poly.circle_poly import evaluate_values

        eval_log = self.max_constraint_log_degree_bound()
        trace_log = self.eval.log_size()
        eval_domain = CanonicCoset.new(eval_log).circle_domain()
        device = trace.device()
        stacks = []  # per interaction: the extended columns, [B, n]
        for tree in self._sub_tree(trace.polys):
            stacks.append(evaluate_values(
                torch.stack([p.coeffs for p in tree]), eval_domain,
                accumulator.twiddles) if tree else None)
        (accum,) = accumulator.columns([(eval_log, self.n_constraints())])
        program = self.constraint_program(trace_log, eval_log)
        for i, cols in enumerate(program.columns):
            if cols > (0 if i >= len(stacks) or stacks[i] is None
                       else stacks[i].shape[0]):
                raise ValueError(f"the constraints read {cols} columns of "
                                 f"interaction {i}; the trace has fewer")
        cumsum_shift = self.claimed_sum.mul_m31(
            M31.from_int(1 << trace_log).inverse())
        scalars = upload(torch.from_numpy(program.scalars(
            accum.random_coeff_powers, self._secure_params, cumsum_shift)),
            device)
        count("constraints_fused", program.n_constraints)
        accum.col = constraint_eval.evaluate(
            program.device_code(device), program.device_loads(device),
            program.n_slots, stacks, scalars, program.denom_off, trace_log,
            eval_log, accum.col)
