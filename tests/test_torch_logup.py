"""LogUp parity of the PyTorch port against the JAX package (tolerance 0).

The counterpart of each case of tests/test_logup.py, on the same inputs
in both packages: combine_cols, prefix sums and the coset and mask-offset
permutations; the Seq and IsFirst columns; assert_constraints on good and
bad traces; interaction columns and claimed sums; proof JSON at 2^8 rows
for both `pairs` modes; each package's verifier on the other's proof;
rejection of a tampered proof and of an unsound trace; and the committed
golden fixture (which the GPU smoke run compares against).

test_logup.py::test_logup_domain_kernel_shared_across_proofs has no
counterpart here: it checks JAX's jit cache of the domain kernel
(`kernel_cache_key`, `_DOMAIN_KERNEL_CACHE`); the port's cache of
constraint programs under the same key is tested in
tests/test_torch_constraint_program.py.
"""
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tstwo_tpu.channel.blake2s import Blake2sChannel as JaxChannel
from tstwo_tpu.constraint_framework import _offset_perm as jax_offset_perm
from tstwo_tpu.constraint_framework.logup import \
    LookupElements as JaxLookupElements
from tstwo_tpu.constraint_framework.preprocessed import IsFirst as JaxIsFirst
from tstwo_tpu.constraint_framework.preprocessed import Seq as JaxSeq
from tstwo_tpu.examples import logup_lookup as jax_ll
from tstwo_tpu.ops import prefix_sum as jax_prefix_sum
from tstwo_tpu.serialize import proof_from_dict as jax_from_dict
from tstwo_tpu.serialize import proof_to_dict as jax_to_dict
from tstwo_tpu_torch.channel.blake2s import Blake2sChannel
from tstwo_tpu_torch.constraint_framework import (FrameworkComponent,
                                                  TraceLocationAllocator,
                                                  _offset_perm,
                                                  assert_constraints)
from tstwo_tpu_torch.constraint_framework.logup import (LookupElements,
                                                        RelationEntry)
from tstwo_tpu_torch.constraint_framework.preprocessed import IsFirst, Seq
from tstwo_tpu_torch.examples import logup_lookup as ll
from tstwo_tpu_torch.fields import QM31
from tstwo_tpu_torch.ops import m31
from tstwo_tpu_torch.ops import prefix_sum
from tstwo_tpu_torch.pcs.utils import TreeVec
from tstwo_tpu_torch.pcs.verifier import VerificationError
from tstwo_tpu_torch.prover import ProvingError
from tstwo_tpu_torch.serialize import proof_from_dict, proof_to_dict
from tstwo_tpu_torch.utils import to_numpy_u32, to_torch_u32

P = (1 << 31) - 1
LOG = 5
LOG_PROOF = 8
FIXTURE = os.path.join(os.path.dirname(__file__), "data",
                       "torch_port_logup_log8_seed0.json")


def _json(d):
    return json.dumps(d, sort_keys=True)


def _equal(tensor, jax_arr):
    np.testing.assert_array_equal(to_numpy_u32(tensor), np.asarray(jax_arr))


@pytest.fixture(scope="module")
def proofs():
    """pairs -> (JAX proof dict, port proof dict, port config) at 2^8 rows."""
    out = {}
    for pairs in (True, False):
        jax_proof, _, _ = jax_ll.prove_logup_lookup(log_size=LOG_PROOF,
                                                    pairs=pairs)
        proof, config, claimed = ll.prove_logup_lookup(log_size=LOG_PROOF,
                                                       pairs=pairs,
                                                       device="cpu")
        assert claimed.is_zero()
        out[pairs] = (jax_to_dict(jax_proof), proof_to_dict(proof), config)
    return out


PAIRS = pytest.mark.parametrize("pairs", [True, False],
                                ids=["pairs", "single"])


# -- combine_cols, prefix sums, permutations ---------------------------------

def test_lookup_elements_combine_matches_jax_and_host():
    rel = LookupElements.draw(Blake2sChannel(), 3)
    jax_rel = JaxLookupElements.draw(JaxChannel(), 3)
    assert rel.z.to_ints() == jax_rel.z.to_ints()
    assert [p.to_ints() for p in rel.alpha_powers] == \
        [p.to_ints() for p in jax_rel.alpha_powers]
    rng = np.random.default_rng(0)
    base = [rng.integers(0, P, size=64, dtype=np.uint32) for _ in range(2)]
    secure = rng.integers(0, P, size=(4, 64), dtype=np.uint32)
    got = rel.combine_cols([to_torch_u32(base[0]), to_torch_u32(secure),
                            to_torch_u32(base[1])])
    want = jax_rel.combine_cols([jnp.asarray(base[0]), jnp.asarray(secure),
                                 jnp.asarray(base[1])])
    _equal(got, want)
    for row in (0, 17, 63):
        host = rel.combine([
            QM31.from_u32_unchecked(int(base[0][row]), 0, 0, 0),
            QM31.from_ints(secure[:, row].tolist()),
            QM31.from_u32_unchecked(int(base[1][row]), 0, 0, 0)])
        assert tuple(int(v) for v in got[:, row]) == host.to_ints()


@pytest.mark.parametrize("shape", [(1,), (7,), (3, 64), (4, 1 << 10)])
def test_prefix_sums_match_jax(shape):
    x = np.random.default_rng(len(shape)).integers(0, P, size=shape,
                                                   dtype=np.uint32)
    _equal(prefix_sum.inclusive_prefix_sum(to_torch_u32(x)),
           jax_prefix_sum.inclusive_prefix_sum(jnp.asarray(x)))
    _equal(prefix_sum.exclusive_prefix_sum(to_torch_u32(x)),
           jax_prefix_sum.exclusive_prefix_sum(jnp.asarray(x)))


def test_prefix_sum_near_p_is_exact():
    x = np.full(1 << 12, P - 1, dtype=np.uint32)
    got = to_numpy_u32(prefix_sum.inclusive_prefix_sum(to_torch_u32(x)))
    want = (np.arange(1, 1 + (1 << 12), dtype=np.uint64) * (P - 1)) % P
    np.testing.assert_array_equal(got, want.astype(np.uint32))


@pytest.mark.parametrize("log", [1, 2, 4, 8, 12])
def test_coset_order_perms_match_jax(log):
    ours = prefix_sum._coset_order_perms(log)
    theirs = jax_prefix_sum._coset_order_perms(log)
    for a, b in zip(ours, theirs):
        assert a.dtype == np.int32
        np.testing.assert_array_equal(a, np.asarray(b))
    x = np.random.default_rng(log).integers(0, P, size=(4, 1 << log),
                                            dtype=np.uint32)
    _equal(prefix_sum.inclusive_prefix_sum_bit_rev_circle(to_torch_u32(x),
                                                          log),
           jax_prefix_sum.inclusive_prefix_sum_bit_rev_circle(
               jnp.asarray(x), log))


@pytest.mark.parametrize("trace_log,eval_log", [(1, 1), (4, 4), (5, 6),
                                                (8, 9), (4, 7)])
@pytest.mark.parametrize("offset", [-2, -1, 1, 3])
def test_offset_perm_matches_jax(trace_log, eval_log, offset):
    np.testing.assert_array_equal(
        _offset_perm(trace_log, eval_log, offset),
        np.asarray(jax_offset_perm(trace_log, eval_log, offset)))


# -- preprocessed columns ----------------------------------------------------

@pytest.mark.parametrize("log", [1, 4, 6])
def test_preprocessed_columns_match_jax(log):
    assert Seq(log).id().id == JaxSeq(log).id().id == f"preprocessed_seq_{log}"
    assert IsFirst(log).id().id == JaxIsFirst(log).id().id == \
        f"preprocessed_is_first_{log}"
    for ours, theirs in [(Seq(log), JaxSeq(log)),
                         (IsFirst(log), JaxIsFirst(log))]:
        col = ours.gen_column("cpu")
        assert col.values.dtype == torch.int32
        assert col.domain.log_size() == log
        _equal(col.values, theirs.gen_column().values)
    assert list(Seq(4).gen_column("cpu").values.tolist()) == list(range(16))


# -- assert_constraints ------------------------------------------------------

def _trace_tree(log_size, pairs, mult_delta=0):
    val_col, mult_col = ll.generate_trace(log_size, device="cpu")
    if mult_delta:
        mult_col = m31.add(mult_col, mult_delta)
    rel = LookupElements.draw(Blake2sChannel(), 1)
    cols, claimed = ll.generate_interaction_trace(log_size, val_col, mult_col,
                                                  rel, pairs)
    trace_evals = TreeVec([
        [Seq(log_size).gen_column("cpu").values],
        [val_col, mult_col],
        [c.values for c in cols],
    ])
    return trace_evals, rel, claimed, cols


@pytest.mark.parametrize("pairs", [True, False])
def test_logup_constraints_vanish_on_trace(pairs):
    trace_evals, rel, claimed, _ = _trace_tree(LOG, pairs)
    assert claimed.is_zero()
    assert_constraints(trace_evals, LOG, ll.LookupEval(LOG, rel, pairs),
                       claimed)


def test_logup_constraints_fail_on_bad_multiplicities():
    trace_evals, rel, claimed, _ = _trace_tree(LOG, True, mult_delta=1)
    assert not claimed.is_zero()  # unbalanced lookup is visible in the sum
    # the honest mult column with the bad interaction trace: the cumulative
    # constraints must break
    trace_evals[1][1] = ll.generate_trace(LOG, device="cpu")[1]
    with pytest.raises(AssertionError):
        assert_constraints(trace_evals, LOG, ll.LookupEval(LOG, rel),
                           claimed)


class _Unfinalized(ll.LookupEval):
    def evaluate(self, ev):
        val = ev.next_trace_mask()
        ev.add_to_relation(
            RelationEntry(self.lookup_elements, QM31.one(), [val]))
        return ev  # never finalizes


def test_unfinalized_logup_raises():
    rel = LookupElements.dummy(1)
    with pytest.raises(ValueError, match="never finalized"):
        FrameworkComponent(TraceLocationAllocator(), _Unfinalized(LOG, rel),
                           QM31.zero())
    trace_evals, _, _, _ = _trace_tree(LOG, True)
    with pytest.raises(AssertionError, match="never finalized"):
        assert_constraints(trace_evals, LOG, _Unfinalized(LOG, rel))


def test_static_allocator_rejects_unknown_preprocessed():
    rel = LookupElements.dummy(1)
    alloc = TraceLocationAllocator.new_with_preprocessed_columns(
        [IsFirst(LOG).id()])
    with pytest.raises(ValueError, match="not declared"):
        FrameworkComponent(alloc, ll.LookupEval(LOG, rel), QM31.zero())


# -- interaction trace -------------------------------------------------------

@pytest.mark.parametrize("mult_delta", [0, 1])
@pytest.mark.parametrize("pairs", [True, False])
def test_interaction_trace_matches_jax(pairs, mult_delta):
    val_col, mult_col = ll.generate_trace(LOG, device="cpu")
    jax_val, jax_mult = jax_ll.generate_trace(LOG)
    _equal(val_col, jax_val)
    _equal(mult_col, jax_mult)
    if mult_delta:
        mult_col = m31.add(mult_col, mult_delta)
        jax_mult = jax_mult + jnp.uint32(mult_delta)
    cols, claimed = ll.generate_interaction_trace(
        LOG, val_col, mult_col, LookupElements.draw(Blake2sChannel(), 1),
        pairs)
    jax_cols, jax_claimed = jax_ll.generate_interaction_trace(
        LOG, jax_val, jax_mult, JaxLookupElements.draw(JaxChannel(), 1),
        pairs)
    assert claimed.to_ints() == jax_claimed.to_ints()
    assert claimed.is_zero() == (mult_delta == 0)
    assert len(cols) == len(jax_cols) == (4 if pairs else 8)
    for ours, theirs in zip(cols, jax_cols):
        _equal(ours.values, theirs.values)


@pytest.mark.parametrize("numerator", ["int", "m31", "qm31", "column"])
def test_trace_generator_scalar_fractions_match_jax(numerator):
    """Scalar numerators and denominators broadcast over all rows, also
    when a column's only fraction has both a scalar numerator and a scalar
    denominator."""
    from tstwo_tpu.constraint_framework.logup import \
        LogupTraceGenerator as JaxGenerator
    from tstwo_tpu.fields import M31 as JaxM31
    from tstwo_tpu.fields import QM31 as JaxQM31
    from tstwo_tpu_torch.constraint_framework.logup import LogupTraceGenerator
    from tstwo_tpu_torch.fields import M31

    col = np.random.default_rng(7).integers(1, P, size=1 << LOG,
                                            dtype=np.uint32)
    num, jax_num = {
        "int": (P + 5, P + 5),
        "m31": (M31(5), JaxM31(5)),
        "qm31": (QM31.from_u32_unchecked(1, 2, 3, 4),
                 JaxQM31.from_u32_unchecked(1, 2, 3, 4)),
        "column": (to_torch_u32(col), jnp.asarray(col)),
    }[numerator]
    den = (1, 2, 9, 8)
    gen, jax_gen = LogupTraceGenerator(LOG, "cpu"), JaxGenerator(LOG)
    for g, n, d, c in [(gen, num, QM31.from_u32_unchecked(*den),
                        to_torch_u32(col)),
                       (jax_gen, jax_num, JaxQM31.from_u32_unchecked(*den),
                        jnp.asarray(col))]:
        first = g.new_col()
        first.write_frac(n, d)
        first.finalize_col()
        second = g.new_col()
        second.write_frac(n, d)
        second.write_frac(3, c)
        second.finalize_col()
    cols, claimed = gen.finalize_last()
    jax_cols, jax_claimed = jax_gen.finalize_last()
    assert claimed.to_ints() == jax_claimed.to_ints()
    assert len(cols) == len(jax_cols) == 8
    for ours, theirs in zip(cols, jax_cols):
        _equal(ours.values, theirs.values)


# -- whole proofs ------------------------------------------------------------

@PAIRS
def test_port_proof_equals_jax_proof(proofs, pairs):
    jax_dict, port_dict, _ = proofs[pairs]
    assert _json(port_dict) == _json(jax_dict)


@PAIRS
def test_port_verifier_accepts_jax_proof(proofs, pairs):
    jax_dict, _, config = proofs[pairs]
    ll.verify_logup_lookup(proof_from_dict(jax_dict), config, LOG_PROOF,
                           QM31.zero(), pairs)


@PAIRS
def test_jax_verifier_accepts_port_proof(proofs, pairs):
    from tstwo_tpu.fields import QM31 as JaxQM31
    from tstwo_tpu.pcs import PcsConfig as JaxPcsConfig

    _, port_dict, _ = proofs[pairs]
    jax_ll.verify_logup_lookup(jax_from_dict(port_dict), JaxPcsConfig(),
                               LOG_PROOF, JaxQM31.zero(), pairs)


def test_golden_fixture_is_the_jax_proof(proofs):
    """The fixture is the pairs=True proof at 2^8 rows, seed 0."""
    jax_dict, port_dict, _ = proofs[True]
    with open(FIXTURE) as f:
        text = f.read().strip()
    assert text == _json(jax_dict) == _json(port_dict)


def test_logup_lookup_rejects_tampered_proof():
    proof, config, claimed = ll.prove_logup_lookup(log_size=LOG, device="cpu")
    tree = proof.commitment_scheme_proof.sampled_values[2]
    orig = tree[0][0]
    tree[0][0] = orig + QM31.one()
    with pytest.raises(VerificationError):
        ll.verify_logup_lookup(proof, config, LOG, claimed)
    tree[0][0] = orig
    ll.verify_logup_lookup(proof, config, LOG, claimed)  # restored: accepts


def test_logup_lookup_prove_rejects_unsound_trace():
    """Multiplicities that do not match the values: as in the JAX package,
    prove() either fails its OODS sanity check or proves the unbalanced
    lookup with a nonzero claimed sum, which the verifier refuses."""
    val_col, mult_col = ll.generate_trace(LOG, device="cpu")
    with pytest.raises((ProvingError, ValueError)):
        proof, config, claimed = ll.prove_logup_lookup(
            log_size=LOG, trace=(val_col, m31.add(mult_col, 1)),
            device="cpu")
        assert not claimed.is_zero()
        ll.verify_logup_lookup(proof, config, LOG, claimed)


def test_verify_rejects_nonzero_claimed_sum():
    proof, config, _ = ll.prove_logup_lookup(log_size=LOG, device="cpu")
    with pytest.raises(ValueError, match="must be zero"):
        ll.verify_logup_lookup(proof, config, LOG, QM31.one())
