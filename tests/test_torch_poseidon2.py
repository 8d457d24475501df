"""The Poseidon2 AIR with LogUp (tstwo_tpu_torch/examples/poseidon2.py) on the
CPU, tolerance 0.

The port against the benchmark's plain reference
(stark_bench/reference/poseidon2.py, which imports nothing of the port):
the trace against the reference's permutation, whole proofs field by field
at 2^3-2^5 rows.  Then the AIR itself: the AssertEvaluator on an honest
trace and on one corrupted cell of a full and of a partial round, the
verifier on the proof and on a tampered sampled value, and the Poseidon2
constraint program (19,899 instructions, 107 slots: the program that did
not fit the kernel's old shared-memory layout) run by the plain executor
against the eager DomainEvaluator.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from stark_bench.compare import compare
from stark_bench.recipes.poseidon2 import proof_fields
from stark_bench.reference import poseidon2 as reference
from tstwo_tpu_torch import constraint_framework as cf
from tstwo_tpu_torch.constraint_framework.logup import LookupElements
from tstwo_tpu_torch.constraint_framework.program import lower
from tstwo_tpu_torch.constraints import \
    coset_vanishing_denominator_inverses_bitrev
from tstwo_tpu_torch.examples import poseidon2
from tstwo_tpu_torch.fields import QM31
from tstwo_tpu_torch.fri import FriConfig
from tstwo_tpu_torch.ops import constraint_eval as ce
from tstwo_tpu_torch.ops import m31
from tstwo_tpu_torch.pcs import PcsConfig
from tstwo_tpu_torch.pcs.utils import TreeVec
from tstwo_tpu_torch.pcs.verifier import VerificationError
from tstwo_tpu_torch.utils import to_torch_u32

P = (1 << 31) - 1
SEED = 2 ** 40 + 19  # a large seed, as the benchmark's are
CONFIG = {"security": {"pow_bits": 5, "log_blowup_factor": 1,
                       "n_queries": 3, "log_last_layer_degree_bound": 0},
          "merkle_channel": "blake2s"}
PCS = PcsConfig(5, FriConfig(0, 1, 3))


@pytest.fixture(scope="module")
def proofs():
    """log_n -> (proof, config, claimed sum), proved once."""
    return {log_n: poseidon2.prove_poseidon2(log_n, PCS, seed=SEED + log_n,
                                             device="cpu")
            for log_n in (3, 4, 5)}


def _qm31s(rng, k):
    return [QM31.from_ints([int(v) for v in rng.integers(0, P, 4)])
            for _ in range(k)]


@pytest.mark.parametrize("seed", [0, SEED, 2 ** 127 + 2 ** 64 + 5])
def test_trace_inputs_are_the_references_distinct_and_canonical(seed):
    got = poseidon2.trace_inputs(5, seed, "cpu")
    assert got.shape == (8, 16, 32) and got.dtype == torch.int64
    assert torch.equal(got, reference.trace_inputs(seed, 5))
    assert 0 <= int(got.min()) and int(got.max()) < P
    assert got.unique().numel() == got.numel()
    assert not torch.equal(got, poseidon2.trace_inputs(5, seed + 1, "cpu"))


def test_trace_matches_the_reference_permutation():
    log_n = 4
    got = torch.stack(poseidon2.generate_trace(log_n, SEED, "cpu"))
    want = reference.trace(torch.as_tensor(
        reference.trace_inputs(SEED, log_n)))
    assert got.shape == (1264, 1 << log_n)
    assert torch.equal(got.to(torch.int64), want)


@pytest.mark.parametrize("log_n", [3, 4, 5])
def test_proof_equals_the_reference_proof(proofs, log_n):
    proof, _, _ = proofs[log_n]
    want = reference.prove(reference.trace_inputs(SEED + log_n, log_n),
                           CONFIG, log_n, "cpu")
    got = proof_fields(proof)
    assert not any(compare(got, want).values())
    assert got == want
    # the interaction tree is sampled at two points: its last 4 columns
    assert [len(c) for c in got["sampled_values"][2]] == [1] * 28 + [2] * 4


def _interaction(log_n):
    cols = poseidon2.generate_trace(log_n, SEED, "cpu")
    rng = np.random.default_rng(1)
    elements = LookupElements(*_qm31s(rng, 2), poseidon2.N_STATE)
    inter, claimed = poseidon2.generate_interaction_trace(log_n, cols,
                                                          elements)
    return cols, [e.values for e in inter], elements, claimed


# a full-round column (instance 2, full round 1, element 3) and a
# partial-round one (instance 5, partial round 6)
@pytest.mark.parametrize("column", [2 * 158 + 16 * 2 + 3,
                                    5 * 158 + 16 * 5 + 6])
def test_assert_evaluator_passes_honest_and_fails_corrupted(column):
    log_n = 3
    cols, inter, elements, claimed = _interaction(log_n)
    ev = poseidon2.Poseidon2Eval(log_n, elements)
    cf.assert_constraints(TreeVec([[], cols, inter]), log_n, ev, claimed)
    bad = list(cols)
    bad[column] = m31.add(bad[column], torch.ones_like(bad[column]))
    with pytest.raises(AssertionError):
        cf.assert_constraints(TreeVec([[], bad, inter]), log_n, ev, claimed)


def test_verify_accepts_the_proof_and_refuses_a_tampered_value(proofs):
    proof, config, claimed = proofs[3]
    poseidon2.verify_poseidon2(proof, config, 3, claimed)
    assert not claimed.is_zero()
    sampled = proof.commitment_scheme_proof.sampled_values
    prev = sampled[2][-1][1]
    sampled[2][-1][1] = prev + QM31.one()
    try:
        with pytest.raises(VerificationError):
            poseidon2.verify_poseidon2(proof, config, 3, claimed)
    finally:
        sampled[2][-1][1] = prev


def test_program_plain_executor_equals_domain_evaluator():
    trace_log, eval_log = 3, 5
    rng = np.random.default_rng(5)
    elements = LookupElements(*_qm31s(rng, 2), poseidon2.N_STATE)
    ev = poseidon2.Poseidon2Eval(trace_log, elements)
    program = lower(ev, trace_log, eval_log)
    # the program that outgrew the kernel's shared memory: 19,899
    # instructions (318 KB of code), 1,300 loads, 107 slots
    assert (len(program.code), program.count(ce.LOAD), program.n_slots,
            program.n_constraints) == (19899, 1300, 107, 1144)
    assert program.columns == [0, 1264, 32]
    info = cf.InfoEvaluator(trace_log)
    ev.evaluate(info)
    stacks = [None] + [to_torch_u32(rng.integers(0, P, (c, 1 << eval_log))
                                    .astype(np.uint32), "cpu")
                       for c in program.columns[1:]]
    coeffs = _qm31s(rng, program.n_constraints)
    shift = _qm31s(rng, 1)[0]
    got = ce.evaluate_plain(
        torch.from_numpy(program.code), program.n_slots, stacks,
        torch.from_numpy(program.scalars(coeffs, info.secure_params, shift)),
        program.denom_off, trace_log, eval_log)

    def u32(rows):
        return to_torch_u32(np.array(rows, np.uint32).reshape(-1, 4), "cpu")

    dom = cf.DomainEvaluator(
        [[]] + [[s[i] for i in range(s.shape[0])] for s in stacks[1:]],
        trace_log, eval_log, u32([q.to_ints() for q in reversed(coeffs)]),
        u32([shift.to_ints()])[0],
        u32([q.to_ints() for q in info.secure_params]))
    ev.evaluate(dom)
    dinv = to_torch_u32(coset_vanishing_denominator_inverses_bitrev(
        trace_log, eval_log), "cpu")
    assert torch.equal(got, m31.mul(dom.row_res.arr, dinv[None, :]))


def test_load_table_lists_every_load_in_order():
    program = lower(poseidon2.Poseidon2Eval(
        3, LookupElements.dummy(poseidon2.N_STATE)), 3, 5)
    table = ce.load_table(torch.from_numpy(program.code))
    loads = [(int(w[2]), int(w[3]), ce.decode_w0(int(w[0]))[1])
             for w in program.code if int(w[0]) & 0xff == ce.LOAD]
    assert [tuple(r[:3]) for r in table.tolist()] == loads
    assert table[:, 3].eq(0).all()
    # the last secure column's 4 coordinates are read at offset -1 too
    assert sum(1 for r in loads if r[2] == -1) == 4


def test_interaction_span_and_counters():
    from tstwo_tpu_torch import tracing

    tracing.reset()
    tracing.enable(sync=False)
    try:
        with tracing.request(0):
            _interaction(3)
        counts = tracing.counts()[0]
        names = [r["name"] for r in tracing.records()]
    finally:
        tracing.disable()
        tracing.reset()
    assert names.count("interaction_trace") == 1
    assert counts["logup_columns"] == 8
    assert counts["logup_fractions"] == 16 << 3
