"""The port's GKR batch prover (tstwo_tpu_torch/lookups/gkr.py) against the
benchmark's plain reference (stark_bench/reference/gkr_lookups.py, which
imports nothing of the port) on the CPU, tolerance 0.

Whole batch proofs field by field, through the recipe's `proof_fields` and
the harness's comparison over the configuration's parts: GrandProduct
alone, LogUpGeneric alone and both at 2^1, 2^4 and 2^8 points, and batches
of mixed sizes, which prove the smaller instance from a later layer with
its claim doubled for each unused variable.  Then the reference on its own
terms: its claims to verify are the inputs' MLEs at its point, and the
port's batch verifier takes its proof and refuses it with one mask value
changed.  The cell's inputs, and the spans and counters of the prove.
"""
from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch

from stark_bench.compare import compare, parts_of
from stark_bench.recipes import gkr_lookups as recipe
from stark_bench.reference import gkr_lookups as reference
from stark_bench.reference.hashes import Blake2sChannel as PlainChannel
from tstwo_tpu_torch import tracing
from tstwo_tpu_torch.channel.blake2s import Blake2sChannel
from tstwo_tpu_torch.fields import QM31
from tstwo_tpu_torch.lookups.gkr import (GATE_GRAND_PRODUCT, GATE_LOGUP,
                                         GRAND_PRODUCT, LOGUP_GENERIC,
                                         GkrBatchProof, GkrError, GkrMask,
                                         Layer, partially_verify_batch,
                                         prove_batch)
from tstwo_tpu_torch.lookups.mle import Mle
from tstwo_tpu_torch.lookups.sumcheck import SumcheckProof
from tstwo_tpu_torch.lookups.utils import UnivariatePoly

P = (1 << 31) - 1
SEED = 2 ** 40 + 23  # a large seed, as the benchmark's are
CONFIG = json.loads((Path(__file__).resolve().parents[1] / "stark_bench" /
                     "configs" / "gkr_gp_logup_blake2s.json").read_text())
PARTS = parts_of(CONFIG)
GATES = {GRAND_PRODUCT: GATE_GRAND_PRODUCT, LOGUP_GENERIC: GATE_LOGUP}


def _columns(kind, log_n, seed):
    """The cell's input columns of `kind` over 2^log_n points, int32."""
    values, numerators, denominators = recipe.inputs(log_n, seed, "cpu")
    return (values,) if kind == GRAND_PRODUCT else (numerators, denominators)


def _port_layer(kind, cols):
    if kind == GRAND_PRODUCT:
        return Layer(kind, data=Mle(cols[0]))
    return Layer(kind, numerators=Mle(cols[0]), denominators=Mle(cols[1]))


def _both(batch):
    """The port's proof fields and the reference's (proof, point, claims)
    of a batch [(kind, log_n), ...]."""
    cols = [_columns(kind, log_n, SEED + 7 * i)
            for i, (kind, log_n) in enumerate(batch)]
    kinds = [kind for kind, _ in batch]
    proof, artifact = prove_batch(
        Blake2sChannel(), [_port_layer(k, c) for k, c in zip(kinds, cols)])
    plain = reference.batch_proof(
        PlainChannel(), [(k, tuple(c.to(torch.int64) for c in cs))
                         for k, cs in zip(kinds, cols)], "cpu")
    return proof, artifact, cols, plain


def _from_fields(fields) -> GkrBatchProof:
    def q(v):
        return QM31.from_ints(v)

    return GkrBatchProof(
        [SumcheckProof([UnivariatePoly([q(c) for c in poly])
                        for poly in rounds])
         for rounds in fields["sumcheck_proofs"]],
        [[GkrMask([(q(a), q(b)) for a, b in mask]) for mask in masks]
         for masks in fields["layer_masks_by_instance"]],
        [[q(v) for v in claims]
         for claims in fields["output_claims_by_instance"]])


BATCHES = [[(GRAND_PRODUCT, n)] for n in (1, 4, 8)] + \
    [[(LOGUP_GENERIC, n)] for n in (1, 4, 8)] + \
    [[(GRAND_PRODUCT, n), (LOGUP_GENERIC, n)] for n in (1, 4, 8)]
MIXED = [[(GRAND_PRODUCT, 3), (LOGUP_GENERIC, 6)],
         [(LOGUP_GENERIC, 3), (GRAND_PRODUCT, 6)],
         [(GRAND_PRODUCT, 1), (LOGUP_GENERIC, 5), (GRAND_PRODUCT, 5)]]


def _name(batch):
    return "+".join(f"{kind}{log_n}" for kind, log_n in batch)


@pytest.mark.parametrize("batch", BATCHES + MIXED, ids=_name)
def test_proof_equals_the_reference_proof(batch):
    proof, _, _, (want, _, _) = _both(batch)
    got = recipe.proof_fields(proof)
    assert compare(got, want, PARTS) == dict.fromkeys(PARTS, 0)
    assert got == want
    depth = max(n for _, n in batch)
    assert len(got["sumcheck_proofs"]) == depth
    # layer L is a sum-check of L rounds
    assert [len(r) for r in got["sumcheck_proofs"]] == list(range(depth))
    assert [len(m) for m in got["layer_masks_by_instance"]] == \
        [n for _, n in batch]


@pytest.mark.parametrize("batch", [BATCHES[-2]] + MIXED[:2], ids=_name)
def test_reference_claims_are_the_input_mles_at_its_point(batch):
    _, artifact, cols, (_, point, claims) = _both(batch)
    depth = len(point)
    for (kind, log_n), cs, got in zip(batch, cols, claims):
        at = point[depth - log_n:]
        want = [Mle(c).eval_at_point([QM31.from_ints(v) for v in at])
                for c in cs]
        assert [QM31.from_ints(v) for v in got] == want
    assert [QM31.from_ints(v) for v in point] == artifact.ood_point


@pytest.mark.parametrize("batch", [BATCHES[-1], MIXED[0]], ids=_name)
def test_port_verifier_takes_the_reference_proof_and_refuses_a_changed_mask(
        batch):
    _, _, _, (fields, point, claims) = _both(batch)
    gates = [GATES[kind] for kind, _ in batch]
    artifact = partially_verify_batch(gates, _from_fields(fields),
                                      Blake2sChannel())
    assert artifact.ood_point == [QM31.from_ints(v) for v in point]
    assert artifact.claims_to_verify_by_instance == [
        [QM31.from_ints(v) for v in c] for c in claims]
    masks = fields["layer_masks_by_instance"]
    masks[-1][-1][0][1][2] = (masks[-1][-1][0][1][2] + 1) % P
    with pytest.raises(GkrError):
        partially_verify_batch(gates, _from_fields(fields), Blake2sChannel())


@pytest.mark.parametrize("seed", [0, SEED, 2 ** 127 + 2 ** 64 + 5])
def test_trace_inputs_are_the_recipes_canonical_and_nonzero(seed):
    got = recipe.inputs(6, seed, "cpu")
    assert got.shape == (3, 4, 64) and got.dtype == torch.int32
    want = reference.trace_inputs(seed, 6)
    assert want.dtype == torch.int64 and torch.equal(got.to(torch.int64),
                                                     want)
    assert 1 <= int(got.min()) and int(got.max()) < P
    assert got.to(torch.int64).unique().numel() > 64 * 12 - 4
    assert not torch.equal(got, recipe.inputs(6, seed + 1, "cpu"))


def test_cell_interface_proves_what_the_reference_proves():
    log_n = 5
    got = recipe.proof_fields(recipe.prove(CONFIG, log_n, SEED, "cpu"))
    want = reference.prove(reference.trace_inputs(SEED, log_n), CONFIG,
                           log_n, "cpu")
    assert compare(got, want, PARTS) == dict.fromkeys(PARTS, 0)
    label, control = reference.control(reference.trace_inputs(SEED, log_n),
                                       CONFIG, log_n, "cpu")
    assert label == "one GrandProduct value changed"
    assert all(n > 0 for n in compare(control, want, PARTS).values())


@pytest.mark.parametrize("log_n", [1, 5])
def test_spans_and_counters_of_the_prove(log_n):
    tracing.reset()
    tracing.enable(sync=False)
    try:
        with tracing.request(0):
            recipe.prove(CONFIG, log_n, SEED, "cpu")
        counts = tracing.counts()[0]
        names = [r["name"] for r in tracing.records()]
    finally:
        tracing.disable()
        tracing.reset()
    assert counts.get("sumcheck_rounds", 0) == sum(range(log_n))
    assert counts["gkr_instances"] == 2
    assert counts["gkr_layer_points"] == 2 * ((1 << log_n) - 1)
    assert names.count("gkr_layers") == 1
    assert names.count("gkr_eq_evals") == log_n
    assert names.count("gkr_sumcheck") == log_n


def test_counters_are_silent_without_the_span_tree():
    tracing.reset()
    recipe.prove(CONFIG, 3, SEED, "cpu")
    assert tracing.counts() == {}
