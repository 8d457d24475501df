"""Top-level prove() / verify() orchestration.

Flow (embedded Rust spec via reference prover/index.ts:582-769 and
rust-examples/05_proving_an_air.rs:52-133):
  draw alpha -> composition poly -> commit -> OODS point -> mask points
  -> prove_values (OODS evals, quotients, FRI, PoW, decommit) -> sanity check.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

from .air import PREPROCESSED_TRACE_IDX
from .air.components import ComponentProvers, Components
from .circle import CirclePoint
from .fields import QM31, SECURE_EXTENSION_DEGREE
from .pcs.prover import CommitmentSchemeProof, CommitmentSchemeProver
from .pcs.utils import TreeVec
from .pcs.verifier import CommitmentSchemeVerifier, VerificationError


class ProvingError(Exception):
    CONSTRAINTS_NOT_SATISFIED = "Constraints not satisfied."


class InvalidOodsSampleStructure(Exception):
    pass


@dataclass
class StarkProof:
    """reference prover/index.ts:393-468."""

    commitment_scheme_proof: CommitmentSchemeProof

    @property
    def commitments(self) -> TreeVec:
        return self.commitment_scheme_proof.commitments

    @property
    def sampled_values(self) -> TreeVec:
        return self.commitment_scheme_proof.sampled_values

    def extract_composition_oods_eval(self) -> QM31:
        """Last tree = composition mask: 4 coordinate columns x 1 eval."""
        if not self.sampled_values:
            raise InvalidOodsSampleStructure("no sampled values")
        composition_mask = self.sampled_values[-1]
        if len(composition_mask) != SECURE_EXTENSION_DEGREE:
            raise InvalidOodsSampleStructure(
                f"expected {SECURE_EXTENSION_DEGREE} composition columns")
        evals = []
        for col in composition_mask:
            if len(col) != 1:
                raise InvalidOodsSampleStructure(
                    "expected exactly one eval per composition column")
            evals.append(col[0])
        return QM31.from_partial_evals(evals)

    def size_estimate(self) -> int:
        return self.commitment_scheme_proof.size_estimate()

    def size_breakdown_estimate(self) -> dict:
        p = self.commitment_scheme_proof
        inner_samples = sum(16 * len(l.fri_witness)
                            for l in p.fri_proof.inner_layers)
        inner_hashes = sum(l.decommitment.size_estimate() + 32
                           for l in p.fri_proof.inner_layers)
        return {
            "oods_samples": 16 * len(p.sampled_values.flatten_cols()),
            "queries_values": 4 * sum(len(v) for v in p.queried_values),
            "fri_samples": (16 * len(p.fri_proof.last_layer_poly)
                            + inner_samples
                            + 16 * len(p.fri_proof.first_layer.fri_witness)),
            "fri_decommitments": (
                inner_hashes
                + p.fri_proof.first_layer.decommitment.size_estimate() + 32),
            "trace_decommitments": (
                32 * len(p.commitments)
                + sum(d.size_estimate() for d in p.decommitments)),
        }


def prove(components: List, channel,
          commitment_scheme: CommitmentSchemeProver) -> StarkProof:
    n_preprocessed_columns = len(
        commitment_scheme.trees[PREPROCESSED_TRACE_IDX].polynomials)
    component_provers = ComponentProvers(components, n_preprocessed_columns)
    trace = commitment_scheme.trace()

    # Evaluate and commit the composition polynomial.
    from .tracing import span

    with span("channel_sync"):
        # the draw forces the lazy device digest (and with it the queued
        # commit-phase device work) to settle -- wall time here is the
        # commit pipeline draining, not host hashing
        random_coeff = channel.draw_felt()
    with span("composition"):
        composition_poly = component_provers.compute_composition_polynomial(
            random_coeff, trace, commitment_scheme.twiddles)
    tree_builder = commitment_scheme.tree_builder()
    tree_builder.extend_polys(composition_poly.coordinate_polys())
    tree_builder.commit(channel)

    # OODS point and mask sample points.
    with span("channel_sync"):
        oods_point = CirclePoint.get_random_point(channel)
    sample_points = component_provers.mask_points(oods_point)
    sample_points.append([[oods_point]] * SECURE_EXTENSION_DEGREE)

    proof = StarkProof(commitment_scheme.prove_values(sample_points, channel))

    # Sanity: composition OODS eval must match the mask-derived value.
    with span("oods_sanity_check"):
        extracted = proof.extract_composition_oods_eval()
        expected = component_provers.eval_composition_polynomial_at_point(
            oods_point, proof.sampled_values, random_coeff)
    if extracted != expected:
        raise ProvingError(ProvingError.CONSTRAINTS_NOT_SATISFIED)
    return proof


def verify(components: List, channel,
           commitment_scheme: CommitmentSchemeVerifier,
           proof: StarkProof) -> None:
    n_preprocessed_columns = len(
        commitment_scheme.trees[PREPROCESSED_TRACE_IDX].column_log_sizes)
    components_obj = Components(components, n_preprocessed_columns)
    random_coeff = channel.draw_felt()

    # Read the composition commitment.
    composition_bound = components_obj.composition_log_degree_bound()
    commitment_scheme.commit(
        proof.commitments[-1],
        [composition_bound] * SECURE_EXTENSION_DEGREE, channel)

    # OODS point and mask points.
    oods_point = CirclePoint.get_random_point(channel)
    sample_points = components_obj.mask_points(oods_point)
    sample_points.append([[oods_point]] * SECURE_EXTENSION_DEGREE)

    try:
        composition_oods_eval = proof.extract_composition_oods_eval()
    except InvalidOodsSampleStructure as e:
        raise VerificationError(
            f"{VerificationError.INVALID_STRUCTURE}: "
            "Unexpected sampled_values structure") from e
    expected = components_obj.eval_composition_polynomial_at_point(
        oods_point, proof.sampled_values, random_coeff)
    if composition_oods_eval != expected:
        raise VerificationError(VerificationError.OODS_NOT_MATCHING)

    commitment_scheme.verify_values(sample_points,
                                    proof.commitment_scheme_proof, channel)
