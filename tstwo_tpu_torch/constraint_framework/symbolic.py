"""Symbolic constraint expressions (Rust stwo `constraint_framework/expr`).

Runs a FrameworkEval's `evaluate` with an ExprEvaluator to obtain the
constraint polynomials as ASTs instead of numbers: used for degree-bound
analysis (validating `max_constraint_log_degree_bound`), human-readable
constraint formatting, and simplification checked by random evaluation.
Symbols pinned by reference roadmap/deps_map.json keys
`stwo_prover::constraint_framework::expr::*` (BaseExpr, ExtExpr,
ColumnExpr, ExprEvaluator, FormalLogupAtRow, degree::NamedExprs,
assignment::ExprVariables).  Host only: the expressions hold field
scalars (fields.M31 / QM31), never tensors; the same trees and strings as
tstwo_tpu/constraint_framework/symbolic.py.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

from ..air import INTERACTION_TRACE_IDX, ORIGINAL_TRACE_IDX
from ..fields import M31, QM31
from . import _LogupEvalMixin

P = (1 << 31) - 1


@dataclass(frozen=True)
class ColumnExpr:
    """A mask cell: (interaction tree, column index, row offset)."""

    interaction: int
    idx: int
    offset: int

    def name(self) -> str:
        return f"trace_{self.interaction}_column_{self.idx}_offset_{self.offset}"


class _Expr:
    """Shared operator plumbing for Base/Ext expression ASTs."""

    def _lift(self, other):
        if isinstance(other, _Expr):
            return other
        if isinstance(other, int):
            return Const(M31.from_int(other))
        if isinstance(other, M31):
            return Const(other)
        if isinstance(other, QM31):
            return ExtConst(other)
        return NotImplemented

    def __add__(self, other):
        o = self._lift(other)
        return NotImplemented if o is NotImplemented else Add(self, o)

    __radd__ = __add__

    def __sub__(self, other):
        o = self._lift(other)
        return NotImplemented if o is NotImplemented else Sub(self, o)

    def __rsub__(self, other):
        o = self._lift(other)
        return NotImplemented if o is NotImplemented else Sub(o, self)

    def __mul__(self, other):
        o = self._lift(other)
        return NotImplemented if o is NotImplemented else Mul(self, o)

    __rmul__ = __mul__

    def __neg__(self):
        return Neg(self)

    def square(self):
        return Mul(self, self)

    def inverse(self):
        return Inv(self)

    # -- analysis ------------------------------------------------------------
    def degree_bound(self) -> int:
        raise NotImplementedError

    def collect_variables(self) -> "ExprVariables":
        out = ExprVariables()
        self._collect(out)
        return out

    def _collect(self, out: "ExprVariables") -> None:
        raise NotImplementedError

    def eval_expr(self, assignment: "Assignment") -> QM31:
        raise NotImplementedError

    def random_eval(self, seed: int = 0) -> QM31:
        return self.eval_expr(
            self.collect_variables().random_assignment(seed))

    def simplify(self) -> "_Expr":
        return _simplify(self)

    def format_expr(self) -> str:
        raise NotImplementedError

    def simplify_and_format(self) -> str:
        return self.simplify().format_expr()

    def __repr__(self) -> str:  # pragma: no cover
        return self.format_expr()


@dataclass(frozen=True)
class Col(_Expr):
    col: ColumnExpr

    def degree_bound(self) -> int:
        return 1

    def _collect(self, out):
        out.cols.add(self.col)

    def eval_expr(self, a):
        return a.cols[self.col]

    def format_expr(self) -> str:
        return self.col.name()


@dataclass(frozen=True)
class Const(_Expr):
    value: M31

    def degree_bound(self) -> int:
        return 0

    def _collect(self, out):
        pass

    def eval_expr(self, a):
        return QM31.from_base(self.value)

    def format_expr(self) -> str:
        return str(self.value.value)


@dataclass(frozen=True)
class ExtConst(_Expr):
    value: QM31

    def degree_bound(self) -> int:
        return 0

    def _collect(self, out):
        pass

    def eval_expr(self, a):
        return self.value

    def format_expr(self) -> str:
        return f"qm31{self.value.to_ints()}"


@dataclass(frozen=True)
class Param(_Expr):
    name: str

    def degree_bound(self) -> int:
        return 0

    def _collect(self, out):
        out.params.add(self.name)

    def eval_expr(self, a):
        return a.params[self.name]

    def format_expr(self) -> str:
        return self.name


@dataclass(frozen=True)
class SecureCol(_Expr):
    """An extension-field value assembled from 4 base expressions
    (one per QM31 coordinate)."""

    coords: Tuple[_Expr, _Expr, _Expr, _Expr]

    def degree_bound(self) -> int:
        return max(c.degree_bound() for c in self.coords)

    def _collect(self, out):
        for c in self.coords:
            c._collect(out)

    def eval_expr(self, a):
        return QM31.from_partial_evals([c.eval_expr(a) for c in self.coords])

    def format_expr(self) -> str:
        inner = ", ".join(c.format_expr() for c in self.coords)
        return f"SecureCol({inner})"


@dataclass(frozen=True)
class Add(_Expr):
    a: _Expr
    b: _Expr

    def degree_bound(self) -> int:
        return max(self.a.degree_bound(), self.b.degree_bound())

    def _collect(self, out):
        self.a._collect(out)
        self.b._collect(out)

    def eval_expr(self, asg):
        return self.a.eval_expr(asg) + self.b.eval_expr(asg)

    def format_expr(self) -> str:
        return f"({self.a.format_expr()} + {self.b.format_expr()})"


@dataclass(frozen=True)
class Sub(_Expr):
    a: _Expr
    b: _Expr

    def degree_bound(self) -> int:
        return max(self.a.degree_bound(), self.b.degree_bound())

    def _collect(self, out):
        self.a._collect(out)
        self.b._collect(out)

    def eval_expr(self, asg):
        return self.a.eval_expr(asg) - self.b.eval_expr(asg)

    def format_expr(self) -> str:
        return f"({self.a.format_expr()} - {self.b.format_expr()})"


@dataclass(frozen=True)
class Mul(_Expr):
    a: _Expr
    b: _Expr

    def degree_bound(self) -> int:
        return self.a.degree_bound() + self.b.degree_bound()

    def _collect(self, out):
        self.a._collect(out)
        self.b._collect(out)

    def eval_expr(self, asg):
        return self.a.eval_expr(asg) * self.b.eval_expr(asg)

    def format_expr(self) -> str:
        return f"({self.a.format_expr()} * {self.b.format_expr()})"


@dataclass(frozen=True)
class Neg(_Expr):
    a: _Expr

    def degree_bound(self) -> int:
        return self.a.degree_bound()

    def _collect(self, out):
        self.a._collect(out)

    def eval_expr(self, asg):
        return -self.a.eval_expr(asg)

    def format_expr(self) -> str:
        return f"(-{self.a.format_expr()})"


@dataclass(frozen=True)
class Inv(_Expr):
    """Field inverse: not polynomial; degree bound follows the child (the
    framework only uses Inv in denominators that are cleared before
    constraint accumulation)."""

    a: _Expr

    def degree_bound(self) -> int:
        return self.a.degree_bound()

    def _collect(self, out):
        self.a._collect(out)

    def eval_expr(self, asg):
        return self.a.eval_expr(asg).inverse()

    def format_expr(self) -> str:
        return f"1/({self.a.format_expr()})"


class ExprVariables:
    """The free variables of an expression (expr::assignment)."""

    def __init__(self):
        self.cols: set = set()
        self.params: set = set()

    def random_assignment(self, seed: int = 0) -> "Assignment":
        import numpy as np

        rng = np.random.default_rng(seed)

        def rand_qm31():
            return QM31.from_ints([int(x) for x in
                                   rng.integers(0, P, size=4)])

        return Assignment(
            {c: rand_qm31() for c in sorted(
                self.cols, key=lambda c: (c.interaction, c.idx, c.offset))},
            {p: rand_qm31() for p in sorted(self.params)})


@dataclass
class Assignment:
    cols: Dict[ColumnExpr, QM31]
    params: Dict[str, QM31]


def _simplify(e: _Expr) -> _Expr:
    """Constant folding + algebraic identities (expr::simplify)."""
    if isinstance(e, (Col, Const, ExtConst, Param)):
        return e
    if isinstance(e, SecureCol):
        return SecureCol(tuple(_simplify(c) for c in e.coords))
    if isinstance(e, Neg):
        a = _simplify(e.a)
        if isinstance(a, Const):
            return Const(-a.value)
        if isinstance(a, ExtConst):
            return ExtConst(-a.value)
        if isinstance(a, Neg):
            return a.a
        return Neg(a)
    if isinstance(e, Inv):
        return Inv(_simplify(e.a))
    a, b = _simplify(e.a), _simplify(e.b)
    a_const = a.value if isinstance(a, (Const, ExtConst)) else None
    b_const = b.value if isinstance(b, (Const, ExtConst)) else None

    def as_qm31(v):
        return QM31.from_base(v) if isinstance(v, M31) else v

    if isinstance(e, Add):
        if a_const is not None and b_const is not None:
            return ExtConst(as_qm31(a_const) + as_qm31(b_const))
        if a_const is not None and as_qm31(a_const).is_zero():
            return b
        if b_const is not None and as_qm31(b_const).is_zero():
            return a
        return Add(a, b)
    if isinstance(e, Sub):
        if a_const is not None and b_const is not None:
            return ExtConst(as_qm31(a_const) - as_qm31(b_const))
        if b_const is not None and as_qm31(b_const).is_zero():
            return a
        if a_const is not None and as_qm31(a_const).is_zero():
            return _simplify(Neg(b))
        return Sub(a, b)
    if isinstance(e, Mul):
        if a_const is not None and b_const is not None:
            return ExtConst(as_qm31(a_const) * as_qm31(b_const))
        for c, other in ((a_const, b), (b_const, a)):
            if c is not None:
                cq = as_qm31(c)
                if cq.is_zero():
                    return ExtConst(QM31.zero())
                if cq == QM31.one():
                    return other
        return Mul(a, b)
    raise TypeError(f"unknown expr node {type(e)}")


class ExprEvaluator(_LogupEvalMixin):
    """EvalAtRow producing constraint ASTs (expr::evaluator::ExprEvaluator).

    Mask reads return Col leaves; channel randomness returns named Params;
    the logup cumsum shift is the `cumsum_shift` param (Rust
    FormalLogupAtRow)."""

    def __init__(self, log_size: int = 0):
        from .logup import LogupAtRow

        self.col_index: Dict[int, int] = {}
        self.constraints: List[_Expr] = []
        self.intermediates: List[Tuple[str, _Expr]] = []
        self.preprocessed: List = []
        self.logup = LogupAtRow(INTERACTION_TRACE_IDX, QM31.zero(), 0)
        self.logup.cumsum_shift = Param("cumsum_shift")
        self._param_count = 0

    # EvalAtRow surface -------------------------------------------------------
    def next_trace_mask(self) -> Col:
        return self.next_interaction_mask(ORIGINAL_TRACE_IDX, [0])[0]

    def next_interaction_mask(self, interaction: int,
                              offsets: Sequence[int]) -> List[Col]:
        idx = self.col_index.get(interaction, 0)
        self.col_index[interaction] = idx + 1
        return [Col(ColumnExpr(interaction, idx, off)) for off in offsets]

    def get_preprocessed_column(self, cid) -> Col:
        self.preprocessed.append(cid)
        return Col(ColumnExpr(0, len(self.preprocessed) - 1, 0))

    def add_constraint(self, constraint: _Expr) -> None:
        self.constraints.append(constraint)

    def add_intermediate(self, expr: _Expr) -> _Expr:
        name = f"intermediate{len(self.intermediates)}"
        self.intermediates.append((name, expr))
        return Param(name)

    @staticmethod
    def combine_ef(values: Sequence[_Expr]) -> SecureCol:
        return SecureCol(tuple(values))

    def secure_param(self, value: QM31) -> Param:
        name = f"secure_param{self._param_count}"
        self._param_count += 1
        return Param(name)

    @staticmethod
    def _coerce_multiplicity(m):
        v = _LogupEvalMixin._coerce_multiplicity(m)
        return ExtConst(v) if isinstance(v, QM31) else v

    def format_constraints(self) -> str:
        lines = []
        for name, expr in self.intermediates:
            lines.append(f"let {name} = {expr.simplify_and_format()};")
        for i, c in enumerate(self.constraints):
            lines.append(f"constraint {i} = {c.simplify_and_format()};")
        return "\n".join(lines)


def constraint_exprs(framework_eval) -> ExprEvaluator:
    """Run a FrameworkEval symbolically; returns the populated evaluator."""
    ev = ExprEvaluator(framework_eval.log_size())
    framework_eval.evaluate(ev)
    return ev


def check_degree_bounds(framework_eval) -> List[int]:
    """Validate max_constraint_log_degree_bound against each constraint's
    actual polynomial degree.

    Trace columns live in the circle-FFT space of size 2^L (total degree
    <= 2^(L-1)); a degree-d constraint product has degree <= d*2^(L-1) and
    its quotient by the trace vanishing polynomial (degree 2^(L-1)) has
    degree <= (d-1)*2^(L-1), which fits the FFT space of log
    L + ceil(log2(d-1)).  Hence required = L + max(1, (d-2).bit_length()):
    degree 2 and 3 constraints need L+1 (stwo's examples declare exactly
    this), degree 4..5 need L+2, etc.  Returns the per-constraint degrees;
    raises on violation."""
    ev = constraint_exprs(framework_eval)
    log_size = framework_eval.log_size()
    declared = framework_eval.max_constraint_log_degree_bound()
    degrees = [c.degree_bound() for c in ev.constraints]
    max_degree = max(degrees, default=1)
    required = log_size + max(1, max(0, max_degree - 2).bit_length())
    if declared < required:
        raise ValueError(
            f"max_constraint_log_degree_bound {declared} too small: "
            f"constraints reach degree {max_degree} over a 2^{log_size} "
            f"trace (need >= {required})")
    return degrees
