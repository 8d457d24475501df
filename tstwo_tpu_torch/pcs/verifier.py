"""CommitmentSchemeVerifier (embedded Rust spec, reference pcs/verifier.ts)."""
from __future__ import annotations

from collections import Counter
from typing import Dict, List

from ..fields import QM31
from ..fri import CirclePolyDegreeBound, FriVerificationError, FriVerifier
from ..vcs import MerkleVerificationError, MerkleVerifier
from . import PcsConfig
from .quotients import PointSample, fri_answers
from .utils import TreeVec


class VerificationError(Exception):
    INVALID_STRUCTURE = "Proof has invalid structure"
    OODS_NOT_MATCHING = ("The composition polynomial OODS value does not match "
                         "the trace OODS values (DEEP-ALI failure).")
    PROOF_OF_WORK = "Proof of work verification failed."


class CommitmentSchemeVerifier:
    def __init__(self, config: PcsConfig):
        self.config = config
        self.trees: TreeVec = TreeVec()

    def column_log_sizes(self) -> TreeVec:
        return TreeVec(list(t.column_log_sizes) for t in self.trees)

    def commit(self, commitment: bytes, log_sizes: List[int], channel) -> None:
        """Read a commitment root from the prover
        (reference pcs/verifier.ts:43-56)."""
        channel.mix_root(commitment)
        extended = [ls + self.config.fri_config.log_blowup_factor
                    for ls in log_sizes]
        self.trees.append(MerkleVerifier(commitment, extended))

    def verify_values(self, sampled_points: TreeVec, proof, channel) -> None:
        """reference pcs/verifier.ts:58-127 (embedded Rust verify_values)."""
        channel.mix_felts(
            [v for tree in proof.sampled_values for col in tree for v in col])
        random_coeff = channel.draw_felt()

        flat_sizes = sorted(set(self.column_log_sizes().flatten()), reverse=True)
        bounds = [
            CirclePolyDegreeBound(ls - self.config.fri_config.log_blowup_factor)
            for ls in flat_sizes
        ]

        # FRI commitment phase.
        fri_verifier = FriVerifier.commit(
            channel, self.config.fri_config, proof.fri_proof, bounds)

        # Proof of work.
        channel.mix_u64(proof.proof_of_work)
        if channel.trailing_zeros() < self.config.pow_bits:
            raise VerificationError(VerificationError.PROOF_OF_WORK)

        # Query positions.
        query_positions_per_log_size = fri_verifier.sample_query_positions(channel)

        # Merkle decommitment verification per tree.
        for tree, dec, queried in zip(self.trees, proof.decommitments,
                                      proof.queried_values):
            try:
                tree.verify(query_positions_per_log_size, queried, dec)
            except MerkleVerificationError as e:
                raise VerificationError(
                    f"{VerificationError.INVALID_STRUCTURE}: {e}") from e

        # Recompute FRI answers at the queried points.
        samples = TreeVec()
        for tree_points, tree_values in zip(sampled_points,
                                            proof.sampled_values):
            samples.append([
                [PointSample(p, v) for p, v in zip(points, values)]
                for points, values in zip(tree_points, tree_values)
            ])
        n_columns_per_log_size = TreeVec(
            Counter(t.column_log_sizes) for t in self.trees)
        answers = fri_answers(
            self.column_log_sizes(), samples, random_coeff,
            query_positions_per_log_size, proof.queried_values,
            n_columns_per_log_size)

        fri_verifier.decommit(answers)
