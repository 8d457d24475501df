"""CommitmentSchemeProver: commit trees of circle polys, then open at
sampled points via DEEP quotients + FRI + PoW + Merkle decommitments
(reference pcs/prover.ts:28-252, embedded Rust spec).

Columns stay on their device; the transcript is the host channel, which
absorbs each tree's root as soon as the tree is committed.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import torch

from ..circle import CanonicCoset
from ..fri import FriProof, FriProver
from ..poly.circle_poly import (CircleEvaluation, CirclePoly,
                                eval_columns_at_point, evaluate_values,
                                interpolate_values)
from ..poly.twiddles import TwiddleTree
from ..proof_of_work import grind_host
from ..tracing import span
from ..vcs import MerkleProver
from . import PcsConfig, TreeSubspan
from .quotients import PointSample, compute_fri_quotients
from .utils import TreeVec


@dataclass
class CommitmentSchemeProof:
    """reference pcs/prover.ts:159-168 (embedded Rust struct)."""

    config: PcsConfig
    commitments: TreeVec  # of bytes
    sampled_values: TreeVec  # per tree: per column: List[QM31]
    decommitments: TreeVec  # of MerkleDecommitment
    queried_values: TreeVec  # per tree: List[M31]
    proof_of_work: int
    fri_proof: FriProof

    def size_estimate(self) -> int:
        size = 0
        size += 32 * len(self.commitments)
        size += 16 * len(self.sampled_values.flatten_cols())
        size += sum(d.size_estimate() for d in self.decommitments)
        size += 4 * sum(len(v) for v in self.queried_values)
        size += 8
        size += 16 * len(self.fri_proof.first_layer.fri_witness)
        size += self.fri_proof.first_layer.decommitment.size_estimate() + 32
        for layer in self.fri_proof.inner_layers:
            size += 16 * len(layer.fri_witness)
            size += layer.decommitment.size_estimate() + 32
        size += 16 * len(self.fri_proof.last_layer_poly)
        return size


class CommitmentTreeProver:
    """One committed set of polynomials (reference pcs/prover.ts:209-252)."""

    def __init__(self, polynomials: List[CirclePoly], log_blowup_factor: int,
                 channel, twiddles: TwiddleTree, device):
        self.polynomials = polynomials
        self.evaluations: List[CircleEvaluation] = [None] * len(polynomials)
        with span("extension"):
            # all same-size polynomials extend in one batched CFFT
            groups: Dict[int, List[int]] = {}
            for i, poly in enumerate(polynomials):
                groups.setdefault(poly.log_size(), []).append(i)
            for log_size, idxs in groups.items():
                domain = CanonicCoset.new(
                    log_size + log_blowup_factor).circle_domain()
                stacked = torch.stack([polynomials[i].coeffs for i in idxs])
                ext = evaluate_values(stacked, domain, twiddles)
                for k, i in enumerate(idxs):
                    self.evaluations[i] = CircleEvaluation(domain, ext[k])
        with span("merkle"):
            if self.evaluations:
                self.commitment = MerkleProver.commit(
                    [ev.values for ev in self.evaluations])
            else:
                self.commitment = MerkleProver.commit([], device)
        channel.mix_root(self.commitment.root())

    def decommit(self, queries: Dict[int, List[int]]):
        return self.commitment.decommit(
            queries, [ev.values for ev in self.evaluations])


class TreeBuilder:
    def __init__(self, scheme: "CommitmentSchemeProver", tree_index: int):
        self._scheme = scheme
        self.tree_index = tree_index
        self.polys: List[CirclePoly] = []

    def extend_polys(self, columns: Sequence[CirclePoly]) -> TreeSubspan:
        start = len(self.polys)
        self.polys.extend(columns)
        return TreeSubspan(self.tree_index, start, len(self.polys))

    def extend_evals(self, columns: Sequence[CircleEvaluation]) -> TreeSubspan:
        columns = list(columns)
        polys: List[Optional[CirclePoly]] = [None] * len(columns)
        with span("interpolation"):
            groups: Dict[int, List[int]] = {}
            for i, col in enumerate(columns):
                groups.setdefault(col.domain.log_size(), []).append(i)
            for log_size, idxs in groups.items():
                domain = columns[idxs[0]].domain
                stacked = torch.stack([columns[i].values for i in idxs])
                coeffs = interpolate_values(stacked, domain,
                                            self._scheme.twiddles)
                for k, i in enumerate(idxs):
                    polys[i] = CirclePoly(coeffs[k])
        return self.extend_polys(polys)

    def commit(self, channel) -> None:
        self._scheme._commit(self.polys, channel)


class CommitmentSchemeProver:
    """Commits trees and opens them (single device: `device` holds every
    column the scheme commits)."""

    def __init__(self, config: PcsConfig, twiddles: TwiddleTree,
                 device="cpu"):
        self.config = config
        self.twiddles = twiddles
        self.device = torch.device(device)
        self.trees: TreeVec = TreeVec()

    def _commit(self, polynomials: List[CirclePoly], channel) -> None:
        self.trees.append(CommitmentTreeProver(
            polynomials, self.config.fri_config.log_blowup_factor, channel,
            self.twiddles, self.device))

    def tree_builder(self) -> TreeBuilder:
        return TreeBuilder(self, len(self.trees))

    def roots(self) -> TreeVec:
        return TreeVec(t.commitment.root() for t in self.trees)

    def polynomials(self) -> TreeVec:
        return TreeVec(list(t.polynomials) for t in self.trees)

    def evaluations(self) -> TreeVec:
        return TreeVec(list(t.evaluations) for t in self.trees)

    def trace(self):
        from ..air import Trace

        return Trace(self.polynomials(), self.evaluations())

    def prove_values(self, sampled_points: TreeVec, channel
                     ) -> CommitmentSchemeProof:
        """reference pcs/prover.ts:86-156 (embedded Rust prove_values)."""
        # 1. Evaluate polynomials at the open points: all columns of one
        # size sampled at one point fold together on the device.
        with span("evaluate_columns_out_of_domain"):
            samples = TreeVec()
            for tree, tree_points in zip(self.trees, sampled_points):
                tree_samples = [[None] * len(points) for points in tree_points]
                groups = {}  # (log_size, point) -> (point, [(col, point_idx)])
                for ci, (poly, points) in enumerate(zip(tree.polynomials,
                                                        tree_points)):
                    for pi, p in enumerate(points):
                        key = (poly.log_size(), p.x.to_ints(), p.y.to_ints())
                        groups.setdefault(key, (p, []))[1].append((ci, pi))
                for (log_size, _, _), (point, members) in groups.items():
                    stack = torch.stack(
                        [tree.polynomials[ci].coeffs for ci, _ in members])
                    values = eval_columns_at_point(stack, point, log_size)
                    for (ci, pi), v in zip(members, values):
                        tree_samples[ci][pi] = PointSample(point, v)
                samples.append(tree_samples)
            sampled_values = TreeVec(
                [[s.value for s in col] for col in tree] for tree in samples)
            channel.mix_felts(
                [v for tree in sampled_values for col in tree for v in col])

        # 2. DEEP quotients.
        columns = self.evaluations().flatten()
        flat_samples = samples.flatten()
        random_coeff = channel.draw_felt()
        with span("fri_quotients"):
            quotients = compute_fri_quotients(
                columns, flat_samples, random_coeff,
                self.config.fri_config.log_blowup_factor)

        # 3. FRI commitment phase.
        with span("fri_commit"):
            fri_prover = FriProver.commit_host(
                channel, self.config.fri_config, quotients, self.twiddles)

        # 4. Proof of work.
        with span("grind"):
            proof_of_work = grind_host(channel, self.config.pow_bits)
        channel.mix_u64(proof_of_work)

        # 5. FRI decommitment + Merkle decommitments.
        with span("decommitment"):
            fri_proof, query_positions_per_log_size = fri_prover.decommit(
                channel)
            queried_values = TreeVec()
            decommitments = TreeVec()
            for tree in self.trees:
                values, dec = tree.decommit(query_positions_per_log_size)
                queried_values.append(values)
                decommitments.append(dec)

        return CommitmentSchemeProof(
            config=self.config,
            commitments=self.roots(),
            sampled_values=sampled_values,
            decommitments=decommitments,
            queried_values=queried_values,
            proof_of_work=proof_of_work,
            fri_proof=fri_proof,
        )
