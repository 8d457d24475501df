"""Constraint programs (constraint_framework/program.py) on the CPU.

The plain executor of ops/constraint_eval.py runs each AIR's lowered
program over random extended columns and must equal the eager
`DomainEvaluator` on the same columns, tolerance 0: wide Fibonacci (100
and 5 columns), the basic AIR at the tutorial's and a larger size, the
LogUp lookup AIR in both `pairs` modes (masks at offset -1, secure
parameters, a nonzero claimed sum), and an AIR of masks at offsets -1, 1
and 2, constants and `combine_ef` on a domain four times the trace's.  Also: hash-consing and the slot
count, the compact denominators and the row formula of offset masks (what
the kernel computes) against the tables they replace, the encoding, the
refusals, and the program cache across proofs (`constraint_programs_built`).
No JAX here: the prove tests hold the proofs to the JAX package.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from tstwo_tpu_torch import constraint_framework as cf
from tstwo_tpu_torch import tracing
from tstwo_tpu_torch.constraint_framework import (DomainEvaluator,
                                                  FrameworkEval,
                                                  _offset_perm)
from tstwo_tpu_torch.constraint_framework.logup import LookupElements
from tstwo_tpu_torch.constraint_framework.program import (
    denominator_inverses, lower)
from tstwo_tpu_torch.constraints import \
    coset_vanishing_denominator_inverses_bitrev
from tstwo_tpu_torch.examples import basic_air, logup_lookup
from tstwo_tpu_torch.examples.wide_fibonacci import (WideFibonacciEval,
                                                     prove_wide_fibonacci)
from tstwo_tpu_torch.fields import QM31
from tstwo_tpu_torch.ops import constraint_eval as ce
from tstwo_tpu_torch.ops import m31
from tstwo_tpu_torch.utils import to_torch_u32

P = (1 << 31) - 1


@pytest.fixture(autouse=True)
def _tracing_off():
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


def _qm31s(rng, k):
    return [QM31.from_ints([int(v) for v in rng.integers(0, P, 4)])
            for _ in range(k)]


def _lookup(log, pairs, rng):
    z, alpha = _qm31s(rng, 2)
    return logup_lookup.LookupEval(log, LookupElements(z, alpha, 1), pairs)


class _Mixed(FrameworkEval):
    """Masks at offsets -1, 1 and 2, base and QM31 constants, negation,
    `combine_ef` and mixed base/secure sums."""

    def evaluate(self, ev):
        a, b, c, d = ev.next_interaction_mask(1, [0, -1, 1, 2])
        e = ev.next_trace_mask()
        ev.add_constraint(a * b - c + d * e)
        ev.add_constraint((a - 5) * QM31.from_ints([1, 2, 3, 4]) + e)
        ev.add_constraint(-(c * c) + 7)
        ev.add_constraint(3 - ev.combine_ef([a, b, c, d]) * e)


def _case(name, rng):
    """(eval, trace_log, eval_log, secure params, claimed sum)."""
    if name == "mixed":
        return _Mixed(), 5, 7, [], QM31.zero()
    if name == "wide_fib100":
        return WideFibonacciEval(8, 100), 8, 9, [], QM31.zero()
    if name == "wide_fib5":
        return WideFibonacciEval(8, 5), 8, 9, [], QM31.zero()
    if name == "basic_air":
        return basic_air.TestEval(8), 8, 9, [], QM31.zero()
    if name == "tutorial":  # examples/tutorial.py step 05: the basic AIR
        return basic_air.TestEval(4), 4, 5, [], QM31.zero()
    ev = _lookup(8, name == "logup_pairs", rng)
    info = cf.InfoEvaluator(8)
    ev.evaluate(info)
    return ev, 8, 9, info.secure_params, _qm31s(rng, 1)[0]


def _columns(ev, eval_log, rng):
    """Random extended columns, [B, n] int32 an interaction, as many as
    the eval reads (None for an interaction it reads nothing of)."""
    info = cf.InfoEvaluator(0)
    ev.evaluate(info)
    n_pre = len(info.preprocessed_columns)
    counts = [n_pre] + [len(t) for t in info.mask_offsets][1:]
    return [to_torch_u32(rng.integers(0, P, (c, 1 << eval_log))
                         .astype(np.uint32), "cpu") if c else None
            for c in counts]


def _oracle(ev, stacks, trace_log, eval_log, coeffs, params, shift):
    """The eager DomainEvaluator on the same columns."""
    def u32(rows):
        return to_torch_u32(np.array(rows, np.uint32).reshape(-1, 4), "cpu")

    trace_evals = [[] if s is None else [s[i] for i in range(s.shape[0])]
                   for s in stacks]
    dom = DomainEvaluator(trace_evals, trace_log, eval_log,
                          u32([q.to_ints() for q in reversed(coeffs)]),
                          u32([shift.to_ints()])[0],
                          u32([q.to_ints() for q in params]))
    ev.evaluate(dom)
    dinv = to_torch_u32(coset_vanishing_denominator_inverses_bitrev(
        trace_log, eval_log), "cpu")
    return m31.mul(dom.row_res.arr, dinv[None, :])


def _run(program, stacks, coeffs, params, shift):
    scalars = torch.from_numpy(program.scalars(coeffs, params, shift))
    return ce.evaluate_plain(torch.from_numpy(program.code), program.n_slots,
                             stacks, scalars, program.denom_off,
                             program.trace_log, program.eval_log)


CASES = ["wide_fib100", "wide_fib5", "basic_air", "tutorial", "logup_pairs",
         "logup_single", "mixed"]


@pytest.mark.parametrize("name", CASES)
def test_plain_program_equals_domain_evaluator(name):
    rng = np.random.default_rng(CASES.index(name))
    ev, t, e, params, claimed = _case(name, rng)
    program = lower(ev, t, e)
    stacks = _columns(ev, e, rng)
    coeffs = _qm31s(rng, program.n_constraints)
    shift = claimed.mul_m31(
        cf.M31.from_int(1 << t).inverse())
    got = _run(program, stacks, coeffs, params, shift)
    want = _oracle(ev, stacks, t, e, coeffs, params, shift)
    assert got.dtype == torch.int32 and torch.equal(got, want)


def test_logup_program_reads_offset_masks_params_and_shift():
    ev, t, e, params, _ = _case("logup_pairs", np.random.default_rng(0))
    program = lower(ev, t, e)
    loads = [ce.decode_w0(int(w))[1] for w in program.code[:, 0]
             if int(w) & 0xff == ce.LOAD]
    assert -1 in loads and 0 in loads
    assert program.n_params == len(params) > 0
    words = {int(a) for w, _, a, _ in program.code.tolist()
             if w & 0xff == ce.SCALAR_S}
    assert program.shift_off in words
    assert any(program.param_off <= w < program.shift_off for w in words)


def test_wide_fibonacci_hash_conses_its_squares():
    program = lower(WideFibonacciEval(8, 100), 8, 9)
    assert program.n_constraints == program.count(ce.ACCUM_B) == 98
    # one square a column 0-98, against 196 square() calls
    assert program.count(ce.SQR_B) == 99
    assert program.count(ce.LOAD) == 100
    assert program.count(ce.ADD_B) == program.count(ce.SUB_B) == 98
    assert program.columns == [0, 100]


@pytest.mark.parametrize("columns", [10, 100, 400])
def test_slots_stay_bounded_as_columns_grow(columns):
    small = lower(WideFibonacciEval(8, 5), 8, 9).n_slots
    assert lower(WideFibonacciEval(8, columns), 8, 9).n_slots == small <= 8


class _ColumnsFirst(FrameworkEval):
    """Reads all its columns before any constraint."""

    def evaluate(self, ev):
        cols = [ev.next_trace_mask() for _ in range(64)]
        for a, b, c in zip(cols, cols[1:], cols[2:]):
            ev.add_constraint(c - (a.square() + b.square()))


def test_loads_move_to_their_first_reader():
    assert lower(_ColumnsFirst(), 8, 9).n_slots <= 8


@pytest.mark.parametrize("t,e", [(8, 9), (8, 10), (10, 11), (6, 6)])
def test_compact_denominators_equal_the_full_table(t, e):
    full = coset_vanishing_denominator_inverses_bitrev(t, e)
    compact = denominator_inverses(t, e)
    assert compact.shape == (1 << (e - t),)
    assert np.array_equal(full, compact[np.arange(1 << e) >> t])


@pytest.mark.parametrize("offset", [-1, 1, 2])
@pytest.mark.parametrize("t,e", [(5, 6), (5, 7), (6, 6)])
def test_offset_row_formula_equals_offset_perm(t, e, offset):
    rows = torch.arange(1 << e, dtype=torch.int64)
    got = ce.offset_source_rows(rows, t, e, offset)
    assert np.array_equal(got.numpy(), _offset_perm(t, e, offset))


@pytest.mark.parametrize("op,aux", [(ce.LOAD, -1), (ce.LOAD, 2),
                                    (ce.ACCUM_B, ce.FOLD),
                                    (ce.LOAD, -(1 << 23))])
def test_encoding_round_trips(op, aux):
    w0 = ce.encode_w0(op, aux)
    assert -(1 << 31) <= w0 < (1 << 31)
    assert ce.decode_w0(w0) == (op, aux)


class _CombineSecure(FrameworkEval):
    def evaluate(self, ev):
        a = ev.next_trace_mask()
        s = a * QM31.from_ints([1, 2, 3, 4])
        ev.add_constraint(ev.combine_ef([s, a, a, a]))


class _FloatConstant(FrameworkEval):
    def evaluate(self, ev):
        ev.add_constraint(ev.next_trace_mask() * 0.5)


@pytest.mark.parametrize("ev", [_CombineSecure(), _FloatConstant()])
def test_lowering_refuses_what_the_domain_evaluator_cannot_do(ev):
    with pytest.raises((ValueError, TypeError)):
        lower(ev, 4, 5)


def test_the_domain_path_refuses_a_trace_with_too_few_columns(monkeypatch):
    program = lower(WideFibonacciEval(4, 6), 4, 5)
    program.columns[1] += 1  # one column more than the trace commits
    monkeypatch.setattr(cf, "_PROGRAM_CACHE",
                        {(WideFibonacciEval, (4, 6), 4, 5): program})
    with pytest.raises(ValueError, match="columns"):
        prove_wide_fibonacci(4, 6, device="cpu")


def test_scalars_refuse_a_wrong_count():
    program = lower(WideFibonacciEval(4, 5), 4, 5)
    with pytest.raises(ValueError):
        program.scalars([QM31.one()] * 2, [], QM31.zero())


def test_a_warm_proof_builds_no_program(monkeypatch):
    monkeypatch.setattr(cf, "_PROGRAM_CACHE", {})
    tracing.enable(sync=False)
    for i in range(2):
        with tracing.request(i):
            prove_wide_fibonacci(5, 6, seed=i, device="cpu")
    counts = tracing.counts()
    assert [counts[i].get("constraint_programs_built", 0)
            for i in range(2)] == [1, 0]
    assert [counts[i]["constraints_fused"] for i in range(2)] == [4, 4]


def test_evals_without_a_key_keep_their_program_per_component(monkeypatch):
    class Unkeyed(WideFibonacciEval):
        def kernel_cache_key(self):
            return None

    monkeypatch.setattr(cf, "_PROGRAM_CACHE", {})
    alloc = cf.TraceLocationAllocator
    comp = cf.FrameworkComponent(alloc(), Unkeyed(4, 5), QM31.zero())
    first = comp.constraint_program(4, 5)
    assert comp.constraint_program(4, 5) is first
    other = cf.FrameworkComponent(alloc(), Unkeyed(4, 5), QM31.zero())
    assert other.constraint_program(4, 5) is not first
    assert cf._PROGRAM_CACHE == {}
