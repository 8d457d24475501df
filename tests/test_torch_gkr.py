"""Lookups parity of the PyTorch port against the JAX package (tolerance 0):
MLEs, sum-check and GKR.

The counterparts of the cases of tests/test_gkr_suite.py and
tests/test_lookups.py at 1-6 variables, on the same numpy inputs in both
packages: eq tables, `next_layer` of each layer kind, MLE folds, sum-check
prove and verify, `prove_batch` proofs equal to JAX's as flattened QM31
ints for all four layer kinds and for a batch of mixed sizes, and each
rejection case of the batch verifier.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tstwo_tpu.channel.blake2s import Blake2sChannel as JaxChannel
from tstwo_tpu.lookups import gkr as jax_gkr
from tstwo_tpu.lookups import mle as jax_mle
from tstwo_tpu.lookups import sumcheck as jax_sumcheck
from tstwo_tpu_torch.channel.blake2s import Blake2sChannel
from tstwo_tpu_torch.fields import M31, QM31
from tstwo_tpu_torch.lookups import gkr, mle, npqm31, sumcheck
from tstwo_tpu_torch.lookups.gkr import (GATE_GRAND_PRODUCT, GATE_LOGUP,
                                         GRAND_PRODUCT, LOGUP_GENERIC,
                                         LOGUP_MULTIPLICITIES, LOGUP_SINGLES,
                                         EqEvals, GkrError, Layer)
from tstwo_tpu_torch.lookups.mle import BaseMle, Mle, SecureMle
from tstwo_tpu_torch.lookups.utils import (Fraction, Reciprocal,
                                           UnivariatePoly, eq,
                                           random_linear_combination_polys)
from tstwo_tpu_torch.utils import to_numpy_u32, to_torch_u32

P = (1 << 31) - 1
KINDS = [GRAND_PRODUCT, LOGUP_GENERIC, LOGUP_MULTIPLICITIES, LOGUP_SINGLES]
GATES = {GRAND_PRODUCT: GATE_GRAND_PRODUCT, LOGUP_GENERIC: GATE_LOGUP,
         LOGUP_MULTIPLICITIES: GATE_LOGUP, LOGUP_SINGLES: GATE_LOGUP}


# -- carrying state across the two packages ----------------------------------

def _inputs(n_vars, seed):
    """numpy (numerators [4, n], denominators [4, n] nonzero, base [n])."""
    rng = np.random.default_rng(seed)
    n = 1 << n_vars
    return (rng.integers(0, P, size=(4, n), dtype=np.uint32),
            rng.integers(1, P, size=(4, n), dtype=np.uint32),
            rng.integers(0, P, size=n, dtype=np.uint32))


def _layer(pkg, kind, arrays):
    """The same GKR input layer in the port (pkg == gkr) or JAX."""
    num, den, base = arrays
    if pkg is gkr:
        m, conv = mle, to_torch_u32
    else:
        m, conv = jax_mle, jnp.asarray
    if kind == GRAND_PRODUCT:
        return pkg.Layer(kind, data=m.Mle(conv(num)))
    if kind == LOGUP_GENERIC:
        return pkg.Layer(kind, numerators=m.Mle(conv(num)),
                         denominators=m.Mle(conv(den)))
    if kind == LOGUP_MULTIPLICITIES:
        return pkg.Layer(kind, numerators=m.BaseMle(conv(base)),
                         denominators=m.Mle(conv(den)))
    return pkg.Layer(kind, denominators=m.Mle(conv(den)))


def flat_gkr_proof(proof):
    """A GkrBatchProof of either package as a flat list of ints."""
    out = []
    for sc in proof.sumcheck_proofs:
        for rp in sc.round_polys:
            out.append(len(rp.coeffs))
            for c in rp.coeffs:
                out.extend(c.to_ints())
    for masks in proof.layer_masks_by_instance:
        out.append(len(masks))
        for mask in masks:
            for a, b in mask.columns_:
                out.extend(a.to_ints() + b.to_ints())
    for claims in proof.output_claims_by_instance:
        for c in claims:
            out.extend(c.to_ints())
    return out


def _ints(qs):
    return [q.to_ints() for q in qs]


def _rand_qm31s(n, seed):
    rng = np.random.default_rng(seed)
    return [QM31.from_ints(r.tolist())
            for r in rng.integers(0, P, size=(n, 4), dtype=np.uint32)]


def _jax_q(q):
    from tstwo_tpu.fields import QM31 as JaxQM31

    return JaxQM31.from_ints(list(q.to_ints()))


# -- eq tables and MLEs ------------------------------------------------------

@pytest.mark.parametrize("n_vars", [0, 1, 2, 3, 5, 6])
def test_eq_evals_match_jax_and_eq(n_vars):
    y = _rand_qm31s(n_vars, n_vars)
    ours = EqEvals.generate(y, device="cpu")
    theirs = jax_gkr.EqEvals.generate([_jax_q(q) for q in y])
    np.testing.assert_array_equal(to_numpy_u32(ours.evals.evals),
                                  np.asarray(theirs.evals.evals))
    assert len(ours) == (1 << (n_vars - 1) if n_vars else 1)
    for i in (0, len(ours) - 1):
        x = [QM31.zero()] + [
            QM31.one() if (i >> (n_vars - 2 - k)) & 1 else QM31.zero()
            for k in range(n_vars - 1)]
        assert ours.at(i) == (eq(x, y) if n_vars else QM31.one())


def test_gen_eq_evals_matches_scalar_eq():
    y = _rand_qm31s(3, 0)
    v = QM31.from_u32_unchecked(7, 1, 2, 3)
    table = gkr.gen_eq_evals(y, v, device="cpu")
    for i in range(8):
        x = [QM31.from_base(M31((i >> (2 - b)) & 1)) for b in range(3)]
        assert table.at(i) == eq(x, y) * v


@pytest.mark.parametrize("n_vars", [1, 2, 4, 6])
def test_mle_folds_match_jax(n_vars):
    num, _, base = _inputs(n_vars, 10 + n_vars)
    point = _rand_qm31s(n_vars, 20 + n_vars)
    ours, theirs = Mle(to_torch_u32(num)), jax_mle.Mle(jnp.asarray(num))
    fixed = ours.fix_first_variable(point[0])
    np.testing.assert_array_equal(
        to_numpy_u32(fixed.evals),
        np.asarray(theirs.fix_first_variable(_jax_q(point[0])).evals))
    assert ours.eval_at_point(point).to_ints() == \
        theirs.eval_at_point([_jax_q(q) for q in point]).to_ints()
    b_ours, b_theirs = BaseMle(to_torch_u32(base)), jax_mle.BaseMle(base)
    np.testing.assert_array_equal(
        to_numpy_u32(b_ours.fix_first_variable(point[0]).evals),
        np.asarray(b_theirs.fix_first_variable(_jax_q(point[0])).evals))
    claim = npqm31.sum_all(ours.evals)
    poly = SecureMle(ours.evals).sum_as_poly_in_first_variable(claim)
    jax_poly = jax_mle.SecureMle(theirs.evals).sum_as_poly_in_first_variable(
        _jax_q(claim))
    assert _ints(poly.coeffs) == _ints(jax_poly.coeffs)
    assert ours.into_evals() == [ours.at(i) for i in range(len(ours))]


def test_mle_rejects_bad_sizes_and_dtypes():
    with pytest.raises(ValueError):
        Mle(torch.zeros((4, 3), dtype=torch.int32))
    with pytest.raises(ValueError):
        BaseMle(np.zeros(6, dtype=np.uint32), device="cpu")
    with pytest.raises(TypeError):
        Mle(torch.zeros((4, 4), dtype=torch.int64))
    with pytest.raises(IndexError):
        Mle(torch.zeros((4, 4), dtype=torch.int32)).at(4)
    with pytest.raises(ValueError):
        Mle(torch.zeros((4, 4), dtype=torch.int32)).eval_at_point([])


# -- sum-check ---------------------------------------------------------------

@pytest.mark.parametrize("n_vars", [1, 4])
def test_sumcheck_matches_jax_and_roundtrips(n_vars):
    vals = _rand_qm31s(1 << n_vars, 30 + n_vars)
    claim = QM31.zero()
    for v in vals:
        claim = claim + v
    lam = QM31.one()
    proof, assignment, _, claims = sumcheck.prove_batch(
        [claim], [SecureMle(vals, device="cpu")], lam, Blake2sChannel())
    jax_proof, jax_assignment, _, _ = jax_sumcheck.prove_batch(
        [_jax_q(claim)], [jax_mle.SecureMle([_jax_q(v) for v in vals])],
        _jax_q(lam), JaxChannel())
    assert [_ints(p.coeffs) for p in proof.round_polys] == \
        [_ints(p.coeffs) for p in jax_proof.round_polys]
    assert _ints(assignment) == _ints(jax_assignment)
    v_assignment, eval_claim = sumcheck.partially_verify(claim, proof,
                                                        Blake2sChannel())
    assert v_assignment == assignment
    assert SecureMle(vals, device="cpu").eval_at_point(v_assignment) == \
        eval_claim


def test_sumcheck_verify_rejects_bad_claim_and_degree():
    vals = _rand_qm31s(8, 40)
    claim = QM31.zero()
    for v in vals:
        claim = claim + v
    proof, _, _, _ = sumcheck.prove_batch([claim],
                                          [SecureMle(vals, device="cpu")],
                                          QM31.one(), Blake2sChannel())
    with pytest.raises(sumcheck.SumcheckError, match="sum does not match"):
        sumcheck.partially_verify(claim + QM31.one(), proof,
                                  Blake2sChannel())
    proof.round_polys[0] = UnivariatePoly(
        proof.round_polys[0].coeffs + [QM31.zero()] * 2 + [QM31.one()])
    with pytest.raises(sumcheck.SumcheckError, match="degree"):
        sumcheck.partially_verify(claim, proof, Blake2sChannel())


def test_random_linear_combination_polys_and_fractions():
    a, b = UnivariatePoly(_rand_qm31s(3, 41)), UnivariatePoly(
        _rand_qm31s(2, 42))
    alpha, x = _rand_qm31s(2, 43)
    got = random_linear_combination_polys([a, b], alpha).eval_at_point(x)
    assert got == a.eval_at_point(x) + alpha * b.eval_at_point(x)
    f = Reciprocal(QM31.from_u32_unchecked(3, 0, 0, 0)) + Reciprocal(
        QM31.from_u32_unchecked(5, 0, 0, 0))
    assert f.numerator == QM31.from_u32_unchecked(8, 0, 0, 0)
    assert f.denominator == QM31.from_u32_unchecked(15, 0, 0, 0)
    assert (Fraction.zero() + f).numerator * f.denominator == \
        f.numerator * (Fraction.zero() + f).denominator


# -- layers ------------------------------------------------------------------

@pytest.mark.parametrize("n_vars", [1, 2, 3, 4, 5, 6])
@pytest.mark.parametrize("kind", KINDS)
def test_next_layer_matches_jax(kind, n_vars):
    arrays = _inputs(n_vars, 50 + n_vars)
    ours = _layer(gkr, kind, arrays).next_layer()
    theirs = _layer(jax_gkr, kind, arrays).next_layer()
    assert ours.kind == theirs.kind
    for a, b in [(ours.data, theirs.data), (ours.numerators,
                                            theirs.numerators),
                 (ours.denominators, theirs.denominators)]:
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(to_numpy_u32(a.evals),
                                          np.asarray(b.evals))


def test_layer_structure_all_kinds():
    arrays = _inputs(3, 60)
    for kind in KINDS:
        layer = _layer(gkr, kind, arrays)
        assert layer.n_variables() == 3 and not layer.is_output_layer()
    out = _layer(gkr, GRAND_PRODUCT, _inputs(0, 61))
    assert out.is_output_layer() and out.next_layer() is None
    assert out.fix_first_variable(QM31.one()) is out
    fixed = _layer(gkr, LOGUP_MULTIPLICITIES, arrays).fix_first_variable(
        _rand_qm31s(1, 62)[0])
    assert fixed.kind == LOGUP_GENERIC
    with pytest.raises(GkrError):
        _layer(gkr, GRAND_PRODUCT, arrays).try_into_output_layer_values()


@pytest.mark.parametrize("kind", KINDS)
def test_output_layer_values_match_jax(kind):
    arrays = _inputs(0, 63)
    assert _ints(_layer(gkr, kind, arrays).try_into_output_layer_values()) \
        == _ints(_layer(jax_gkr, kind, arrays).try_into_output_layer_values())


def test_correct_sum_as_poly():
    y = _rand_qm31s(3, 64)
    f0, f2, claim = _rand_qm31s(3, 65)
    for k in (0, 4):
        with pytest.raises(ValueError):
            gkr.correct_sum_as_poly_in_first_variable(f0, f2, claim, y, k)
    for k in (1, 3):
        r = gkr.correct_sum_as_poly_in_first_variable(f0, f2, claim, y, k)
        assert r.eval_at_point(QM31.zero()) + r.eval_at_point(QM31.one()) \
            == claim
        jr = jax_gkr.correct_sum_as_poly_in_first_variable(
            _jax_q(f0), _jax_q(f2), _jax_q(claim), [_jax_q(q) for q in y], k)
        assert _ints(r.coeffs) == _ints(jr.coeffs)


# -- prove_batch against JAX -------------------------------------------------

CASES = {f"{kind}_{n}": [(kind, n)] for kind in KINDS for n in (2, 5)}
CASES["mixed"] = [(GRAND_PRODUCT, 6), (LOGUP_GENERIC, 4),
                  (LOGUP_MULTIPLICITIES, 3), (LOGUP_SINGLES, 5)]


@pytest.fixture(scope="module")
def batches():
    """case -> (port proof, port artifact, JAX proof ints, input arrays)."""
    out = {}
    for name, spec in CASES.items():
        arrays = [_inputs(n, 70 + i) for i, (_, n) in enumerate(spec)]
        ours = [_layer(gkr, k, a) for (k, _), a in zip(spec, arrays)]
        theirs = [_layer(jax_gkr, k, a) for (k, _), a in zip(spec, arrays)]
        proof, artifact = gkr.prove_batch(Blake2sChannel(), ours)
        jax_proof, _ = jax_gkr.prove_batch(JaxChannel(), theirs)
        out[name] = (proof, artifact, flat_gkr_proof(jax_proof), arrays)
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_prove_batch_equals_jax_and_verifies(batches, name):
    proof, artifact, jax_ints, arrays = batches[name]
    assert flat_gkr_proof(proof) == jax_ints
    gates = [GATES[kind] for kind, _ in CASES[name]]
    art = gkr.partially_verify_batch(gates, proof, Blake2sChannel())
    assert art.ood_point == artifact.ood_point
    assert art.claims_to_verify_by_instance == \
        artifact.claims_to_verify_by_instance
    assert art.n_variables_by_instance == [n for _, n in CASES[name]]
    # the claims are the input MLEs at the instance's suffix of the point
    for (kind, n), (num, den, base), claims in zip(
            CASES[name], arrays, art.claims_to_verify_by_instance):
        point = art.ood_point[len(art.ood_point) - n:]
        if kind == GRAND_PRODUCT:
            want = [Mle(to_torch_u32(num)).eval_at_point(point)]
        elif kind == LOGUP_SINGLES:
            want = [QM31.one(), Mle(to_torch_u32(den)).eval_at_point(point)]
        else:
            nums = (BaseMle(to_torch_u32(base)).to_secure()
                    if kind == LOGUP_MULTIPLICITIES
                    else Mle(to_torch_u32(num)))
            want = [nums.eval_at_point(point),
                    Mle(to_torch_u32(den)).eval_at_point(point)]
        if kind == LOGUP_SINGLES:
            # the singles numerator mask is constant one
            assert claims[1] == want[1]
        else:
            assert claims == want


def test_output_claims_are_the_products_and_sums(batches):
    proof, _, _, ((num, _, _),) = batches[f"{GRAND_PRODUCT}_5"]
    product = QM31.one()
    for i in range(num.shape[1]):
        product = product * QM31.from_ints(num[:, i].tolist())
    assert proof.output_claims_by_instance[0] == [product]
    proof, _, _, ((num, den, _),) = batches[f"{LOGUP_GENERIC}_5"]
    total = Fraction.zero()
    for i in range(num.shape[1]):
        total = total + Fraction(QM31.from_ints(num[:, i].tolist()),
                                 QM31.from_ints(den[:, i].tolist()))
    out_n, out_d = proof.output_claims_by_instance[0]
    assert out_n * total.denominator == out_d * total.numerator


def test_multiplicities_with_one_variable_raise_like_jax():
    arrays = _inputs(1, 80)
    with pytest.raises(GkrError, match="never reach try_into_mask"):
        gkr.prove_batch(Blake2sChannel(),
                        [_layer(gkr, LOGUP_MULTIPLICITIES, arrays)])
    with pytest.raises(jax_gkr.GkrError):
        jax_gkr.prove_batch(JaxChannel(),
                            [_layer(jax_gkr, LOGUP_MULTIPLICITIES, arrays)])


@pytest.mark.parametrize("kind", [GRAND_PRODUCT, LOGUP_GENERIC,
                                  LOGUP_SINGLES])
def test_minimal_layer_one_variable(kind):
    arrays = _inputs(1, 81)
    proof, _ = gkr.prove_batch(Blake2sChannel(), [_layer(gkr, kind, arrays)])
    jax_proof, _ = jax_gkr.prove_batch(JaxChannel(),
                                       [_layer(jax_gkr, kind, arrays)])
    assert flat_gkr_proof(proof) == flat_gkr_proof(jax_proof)
    art = gkr.partially_verify_batch([GATES[kind]], proof, Blake2sChannel())
    assert art.n_variables_by_instance == [1]


# -- rejections --------------------------------------------------------------

def _tamper_output_claim(proof):
    claims = proof.output_claims_by_instance[0]
    claims[0] = claims[0] + QM31.one()
    return [GATE_GRAND_PRODUCT]


def _tamper_mask(proof):
    mask = proof.layer_masks_by_instance[0][1]
    a, b = mask.columns_[0]
    mask.columns_[0] = (a + QM31.one(), b)
    return [GATE_GRAND_PRODUCT]


def _truncate_sumchecks(proof):
    proof.sumcheck_proofs = proof.sumcheck_proofs[:-1]
    return [GATE_GRAND_PRODUCT]


REJECTIONS = {
    "tampered_output_claim": _tamper_output_claim,
    "tampered_mask": _tamper_mask,
    "truncated_sumcheck_proofs": _truncate_sumchecks,
    "wrong_gate": lambda proof: [GATE_LOGUP],
    "wrong_instance_count": lambda proof: [GATE_GRAND_PRODUCT] * 2,
    "unknown_gate": lambda proof: ["NoSuchGate"],
}


@pytest.mark.parametrize("name", sorted(REJECTIONS))
def test_verify_rejects(name):
    layer = _layer(gkr, GRAND_PRODUCT, _inputs(4, 90))
    proof, _ = gkr.prove_batch(Blake2sChannel(), [layer])
    gates = REJECTIONS[name](proof)
    with pytest.raises(GkrError):
        gkr.partially_verify_batch(gates, proof, Blake2sChannel())
