"""Symbolic constraint expressions of the PyTorch port against the JAX
package's (tolerance 0: the same strings, degrees and values).

Mirrors tests/test_symbolic.py: each case runs the JAX function and the
port's on the same inputs and compares the results -- formatted
constraints, degree bounds, random evaluations (QM31 as ints) and the
simplification rules.
"""
import pytest

from tstwo_tpu.constraint_framework import symbolic as jsym
from tstwo_tpu.constraint_framework.logup import \
    LookupElements as JaxLookupElements
from tstwo_tpu.examples.logup_lookup import LookupEval as JaxLookupEval
from tstwo_tpu.examples.wide_fibonacci import \
    WideFibonacciEval as JaxWideFibonacciEval
from tstwo_tpu.fields import M31 as JaxM31
from tstwo_tpu_torch.constraint_framework import InfoEvaluator
from tstwo_tpu_torch.constraint_framework import symbolic as sym
from tstwo_tpu_torch.constraint_framework.logup import LookupElements
from tstwo_tpu_torch.examples.logup_lookup import LookupEval
from tstwo_tpu_torch.examples.wide_fibonacci import WideFibonacciEval
from tstwo_tpu_torch.fields import M31, QM31

EVALS = {
    "wide_fib_6": (lambda: WideFibonacciEval(4, sequence_length=6),
                   lambda: JaxWideFibonacciEval(4, sequence_length=6)),
    "wide_fib_3": (lambda: WideFibonacciEval(4, sequence_length=3),
                   lambda: JaxWideFibonacciEval(4, sequence_length=3)),
    "logup_pairs": (lambda: LookupEval(4, LookupElements.dummy(1)),
                    lambda: JaxLookupEval(4, JaxLookupElements.dummy(1))),
    "logup_single": (
        lambda: LookupEval(4, LookupElements.dummy(1), pairs=False),
        lambda: JaxLookupEval(4, JaxLookupElements.dummy(1), pairs=False)),
}


def _col(module, i):
    return module.Col(module.ColumnExpr(1, i, 0))


@pytest.mark.parametrize("name", sorted(EVALS))
def test_constraints_equal_the_jax_package(name):
    ours = sym.constraint_exprs(EVALS[name][0]())
    theirs = jsym.constraint_exprs(EVALS[name][1]())
    assert ours.format_constraints() == theirs.format_constraints()
    assert len(ours.constraints) == len(theirs.constraints) > 0
    for seed, (a, b) in enumerate(zip(ours.constraints, theirs.constraints)):
        assert a.format_expr() == b.format_expr()
        assert a.degree_bound() == b.degree_bound()
        assert a.random_eval(seed).to_ints() == b.random_eval(seed).to_ints()
        asg = a.collect_variables().random_assignment(seed)
        assert a.eval_expr(asg) == a.simplify().eval_expr(asg)


@pytest.mark.parametrize("name", sorted(EVALS))
def test_structure_matches_info(name):
    fe = EVALS[name][0]()
    info = InfoEvaluator(fe.log_size())
    fe.evaluate(info)
    assert len(sym.constraint_exprs(fe).constraints) == info.n_constraints


@pytest.mark.parametrize("name", sorted(EVALS))
def test_degree_bounds_equal_the_jax_package(name):
    assert sym.check_degree_bounds(EVALS[name][0]()) == \
        jsym.check_degree_bounds(EVALS[name][1]())


def test_degree_bounds_values_and_refusal():
    assert sym.check_degree_bounds(
        WideFibonacciEval(4, sequence_length=5)) == [2, 2, 2]
    assert sym.check_degree_bounds(EVALS["logup_pairs"][0]()) == [3]
    assert sym.check_degree_bounds(EVALS["logup_single"][0]()) == [2, 2]

    class Bad(WideFibonacciEval):
        def max_constraint_log_degree_bound(self):
            return self.log_n_rows  # missing the +1

    with pytest.raises(ValueError, match="too small"):
        sym.check_degree_bounds(Bad(4, sequence_length=5))


def _exprs(m, field):
    """The same expressions built from one package's nodes."""
    x, y = _col(m, 0), _col(m, 1)
    one, zero = m.Const(field.one()), m.Const(field.zero())
    three, five = m.Const(field.from_int(3)), m.Const(field.from_int(5))
    return [(x + y) * x - 3, x * one, x * zero, x + zero, x - zero,
            m.Neg(m.Neg(x)), three * five, zero - x, -(three + x),
            (x * y).inverse() + m.Param("p"), x.square() * 7]


def test_simplify_and_eval_equal_the_jax_package():
    for seed, (a, b) in enumerate(zip(_exprs(sym, M31),
                                      _exprs(jsym, JaxM31))):
        assert a.format_expr() == b.format_expr()
        assert a.simplify_and_format() == b.simplify_and_format()
        assert a.degree_bound() == b.degree_bound()
        assert a.random_eval(seed).to_ints() == b.random_eval(seed).to_ints()


def test_simplify_rules():
    x = _col(sym, 0)
    one, zero = sym.Const(M31.one()), sym.Const(M31.zero())
    assert (x * one).simplify() == x
    assert (x * zero).simplify() == sym.ExtConst(QM31.zero())
    assert (x + zero).simplify() == x
    assert (x - zero).simplify() == x
    assert sym.Neg(sym.Neg(x)).simplify() == x
    folded = (sym.Const(M31.from_int(3)) * sym.Const(M31.from_int(5))
              ).simplify()
    assert folded == sym.ExtConst(QM31.from_u32_unchecked(15, 0, 0, 0))
    assert (zero - x).simplify() == sym.Neg(x)


def test_param_and_intermediate_equal_the_jax_package():
    texts = []
    for m in (sym, jsym):
        ev = m.ExprEvaluator()
        x = ev.next_trace_mask()
        inter = ev.add_intermediate(x * x)
        ev.add_constraint(inter + m.Param("p"))
        assert isinstance(inter, m.Param)
        texts.append(ev.format_constraints())
    assert texts[0] == texts[1]
    assert "let intermediate0" in texts[0] and "+ p)" in texts[0]
