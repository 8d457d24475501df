"""FRI low-degree test: prover and verifier.

Folding math runs on the columns' device (ops/fri_ops); Merkle commitments
per layer use the batched hash of the Merkle flavour (`merkle_ops`, see
vcs/ops.py; Blake2s unless given).  `FriProver.commit` keeps the Blake2s
transcript on the device (channel/device.py: one transcript launch a
layer, one fetch at the end); `commit_host` keeps it on the host channel
(the oracle, and the path of Poseidon252).  The query-dependent
decommitment logic is host side.  Structure follows Rust stwo fri.rs (the
reference TS fri.ts:485-979 stubs the commitment side with mocks and
alpha=1 placeholders -- those are deliberately NOT reproduced;
channel-drawn alphas and real Merkle roots are used throughout).

With a mesh (parallel/), a layer whose log size `Mesh.shards` splits is
folded and committed on each rank's slice (parallel/ops.py,
parallel/merkle.py); the first layer under the threshold is gathered and
the rest, down to the replicated last-layer polynomial, runs replicated.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .channel import device as device_channel
from .circle import CanonicCoset, CircleDomain, Coset
from .fields import M31, QM31, SECURE_EXTENSION_DEGREE
from .ops import fri_ops
from .ops import qm31 as qm31_ops
from .poly.line import LineDomain, LineEvaluation, LinePoly
from .poly.circle_poly import SecureEvaluation
from .poly.twiddles import TwiddleTree
from .queries import Queries, get_query_positions_by_log_size
from .tracing import span
from .utils import bit_reverse_index, to_numpy_u32, upload
from .vcs import MerkleProver, MerkleVerificationError, MerkleVerifier
from .vcs.prover import _to_host
from .vcs.ops import Blake2sMerkleOps

FOLD_STEP = 1
CIRCLE_TO_LINE_FOLD_STEP = 1


class FriVerificationError(Exception):
    INVALID_NUM_FRI_LAYERS = "proof contains an invalid number of FRI layers"
    FIRST_LAYER_EVALUATIONS_INVALID = "evaluations are invalid in the first layer"
    FIRST_LAYER_COMMITMENT_INVALID = (
        "queries do not resolve to their commitment in the first layer")
    INNER_LAYER_COMMITMENT_INVALID = (
        "queries do not resolve to their commitment in inner layer")
    INNER_LAYER_EVALUATIONS_INVALID = "evaluations are invalid in inner layer"
    LAST_LAYER_DEGREE_INVALID = "degree of last layer is invalid"
    LAST_LAYER_EVALUATIONS_INVALID = "evaluations in the last layer are invalid"


@dataclass(frozen=True)
class FriConfig:
    """reference fri.ts:28-88."""

    log_last_layer_degree_bound: int
    log_blowup_factor: int
    n_queries: int

    def __post_init__(self):
        if not (0 <= self.log_last_layer_degree_bound <= 10):
            raise ValueError("log_last_layer_degree_bound out of range [0,10]")
        if not (1 <= self.log_blowup_factor <= 16):
            raise ValueError("log_blowup_factor out of range [1,16]")

    def last_layer_domain_size(self) -> int:
        return 1 << (self.log_last_layer_degree_bound + self.log_blowup_factor)

    def security_bits(self) -> int:
        return self.log_blowup_factor * self.n_queries

    def mix_into(self, channel) -> None:
        channel.mix_u64(self.log_blowup_factor)
        channel.mix_u64(self.n_queries)
        channel.mix_u64(self.log_last_layer_degree_bound)


@dataclass(frozen=True)
class CirclePolyDegreeBound:
    log_degree_bound: int

    def fold_to_line(self) -> "LinePolyDegreeBound":
        return LinePolyDegreeBound(self.log_degree_bound - CIRCLE_TO_LINE_FOLD_STEP)


@dataclass(frozen=True)
class LinePolyDegreeBound:
    log_degree_bound: int

    def fold(self, n_folds: int) -> Optional["LinePolyDegreeBound"]:
        if self.log_degree_bound < n_folds:
            return None
        return LinePolyDegreeBound(self.log_degree_bound - n_folds)


@dataclass
class FriLayerProof:
    """reference fri.ts:262-269."""

    fri_witness: List[QM31]
    decommitment: object  # MerkleDecommitment
    commitment: object  # bytes (Blake2s) or FieldElement252


@dataclass
class FriProof:
    first_layer: FriLayerProof
    inner_layers: List[FriLayerProof]
    last_layer_poly: LinePoly


# ---------------------------------------------------------------------------
# Scalar fold helpers (verifier side; reference fri.ts:120-192 semantics)
# ---------------------------------------------------------------------------

def fold_line_pair(e0: QM31, e1: QM31, x: M31, alpha: QM31) -> QM31:
    f0 = e0 + e1
    f1 = (e0 - e1).mul_m31(x.inverse())
    return f0 + alpha * f1


def fold_circle_pair(e0: QM31, e1: QM31, y: M31, alpha: QM31) -> QM31:
    f0 = e0 + e1
    f1 = (e0 - e1).mul_m31(y.inverse())
    return alpha * f1 + f0


def accumulate_line(layer_query_evals: List[QM31],
                    column_query_evals: List[QM31], alpha: QM31) -> None:
    """evals <- evals * alpha^2 + column (reference fri.ts:453-462)."""
    a2 = alpha * alpha
    for i in range(len(layer_query_evals)):
        layer_query_evals[i] = layer_query_evals[i] * a2 + column_query_evals[i]


@dataclass
class SparseEvaluation:
    """Folding-coset subsets of evaluations (reference fri.ts:283-332)."""

    subset_evals: List[List[QM31]]
    subset_domain_initial_indexes: List[int]

    def __post_init__(self):
        if any(len(e) != (1 << FOLD_STEP) for e in self.subset_evals):
            raise ValueError("subset evals must have length 2^FOLD_STEP")
        if len(self.subset_evals) != len(self.subset_domain_initial_indexes):
            raise ValueError("length mismatch")

    def fold_line(self, alpha: QM31, source_domain: LineDomain) -> List[QM31]:
        out = []
        for evals, idx in zip(self.subset_evals,
                              self.subset_domain_initial_indexes):
            x = source_domain.coset.index_at(idx).to_point().x
            out.append(fold_line_pair(evals[0], evals[1], x, alpha))
        return out

    def fold_circle(self, alpha: QM31, source_domain: CircleDomain) -> List[QM31]:
        out = []
        for evals, idx in zip(self.subset_evals,
                              self.subset_domain_initial_indexes):
            p = source_domain.index_at(idx).to_point()
            out.append(fold_circle_pair(evals[0], evals[1], p.y, alpha))
        return out


class InsufficientWitnessError(Exception):
    pass


def compute_decommitment_positions_and_witness_evals(
    values: torch.Tensor, query_positions: Sequence[int], fold_step: int,
    mesh=None,
) -> Tuple[List[int], List[QM31]]:
    """reference fri.ts:346-384.  values: int32 [4, n] on any device, or
    with `mesh` this rank's [4, n / D] slice; only the query-adjacent
    witness positions are gathered (from the ranks that hold them) and
    copied to the host, never the whole column."""
    queries = np.asarray(query_positions, dtype=np.int64)
    # every position of each queried coset, in order; those not queried
    # are the witness
    positions = ((np.unique(queries >> fold_step) << fold_step)[:, None]
                 + np.arange(1 << fold_step)).ravel()
    witness_positions = positions[~np.isin(positions, queries)]
    decommitment_positions = positions.tolist()
    if not len(witness_positions):
        return decommitment_positions, []
    if mesh is not None:
        from .parallel.ops import gather_at

        log = (int(values.shape[-1]) * mesh.size).bit_length() - 1
        vals = to_numpy_u32(gather_at(
            mesh, [([values], witness_positions, log, True)])[0])
    else:
        idx = upload(torch.from_numpy(witness_positions), values.device)
        vals = to_numpy_u32(values.index_select(-1, idx))
    return decommitment_positions, [QM31.from_ints(v)
                                    for v in vals.T.tolist()]


def compute_decommitment_positions_and_rebuild_evals(
    queries: Queries, query_evals: Sequence[QM31],
    witness_evals: Iterator[QM31], fold_step: int
) -> Tuple[List[int], SparseEvaluation]:
    """reference fri.ts:389-448."""
    decommitment_positions: List[int] = []
    subset_evals: List[List[QM31]] = []
    subset_initials: List[int] = []
    qe = 0
    i = 0
    qp = list(queries.positions)
    while i < len(qp):
        coset = qp[i] >> fold_step
        start = coset << fold_step
        end = start + (1 << fold_step)
        decommitment_positions.extend(range(start, end))
        subset_queries = []
        while i < len(qp) and (qp[i] >> fold_step) == coset:
            subset_queries.append(qp[i])
            i += 1
        evals: List[QM31] = []
        sq = 0
        for pos in range(start, end):
            if sq < len(subset_queries) and subset_queries[sq] == pos:
                evals.append(query_evals[qe])
                qe += 1
                sq += 1
            else:
                try:
                    evals.append(next(witness_evals))
                except StopIteration:
                    raise InsufficientWitnessError()
        subset_evals.append(evals)
        subset_initials.append(bit_reverse_index(start, queries.log_domain_size))
    return decommitment_positions, SparseEvaluation(subset_evals, subset_initials)


# ---------------------------------------------------------------------------
# Prover
# ---------------------------------------------------------------------------

def _commit_layer(values: Sequence[torch.Tensor], logs: Sequence[int],
                  merkle_ops, mesh):
    """One FRI layer's tree: each [4, n] coordinate stack is one 2-D
    entry; with a mesh, the sharded tree of parallel/merkle.py, of the
    same flavour."""
    if mesh is not None:
        from .parallel.merkle import ShardedMerkleProver

        return ShardedMerkleProver.commit(mesh, list(values), list(logs),
                                          merkle_ops)
    return merkle_ops.commit(list(values))


class FriFirstLayerProver:
    """Commits the raw quotient columns (all coordinate columns in one tree)."""

    def __init__(self, columns: List[SecureEvaluation],
                 merkle_tree: Optional[MerkleProver] = None,
                 merkle_ops=Blake2sMerkleOps, mesh=None):
        self.columns = columns
        if merkle_tree is None:
            merkle_tree = _commit_layer(
                [se.values for se in columns], self.column_log_sizes(),
                merkle_ops, mesh)
        self.merkle_tree = merkle_tree

    def column_log_sizes(self) -> List[int]:
        return [se.domain.log_size() for se in self.columns]

    def max_column_log_size(self) -> int:
        return max(self.column_log_sizes())

    def decommit(self, queries: Queries) -> FriLayerProof:
        fri_witness: List[QM31] = []
        positions_by_log: Dict[int, List[int]] = {}
        for se in self.columns:
            log = se.domain.log_size()
            column_queries = queries.fold(queries.log_domain_size - log)
            positions, witness = compute_decommitment_positions_and_witness_evals(
                se.values, column_queries.positions, CIRCLE_TO_LINE_FOLD_STEP,
                se.mesh)
            positions_by_log[log] = positions
            fri_witness.extend(witness)
        _, decommitment = self.merkle_tree.decommit(
            positions_by_log, [se.values for se in self.columns],
            self.column_log_sizes())
        return FriLayerProof(fri_witness, decommitment,
                             self.merkle_tree.root())


class FriInnerLayerProver:
    """One committed line-evaluation layer."""

    def __init__(self, evaluation: LineEvaluation,
                 merkle_tree: Optional[MerkleProver] = None,
                 merkle_ops=Blake2sMerkleOps, mesh=None):
        self.evaluation = evaluation
        if merkle_tree is None:
            merkle_tree = _commit_layer(
                [evaluation.values], [evaluation.domain.log_size()],
                merkle_ops, mesh)
        self.merkle_tree = merkle_tree

    def decommit(self, queries: Queries) -> FriLayerProof:
        positions, fri_witness = compute_decommitment_positions_and_witness_evals(
            self.evaluation.values, list(queries.positions), FOLD_STEP,
            self.evaluation.mesh)
        log = self.evaluation.domain.log_size()
        _, decommitment = self.merkle_tree.decommit(
            {log: positions}, [self.evaluation.values], [log])
        return FriLayerProof(fri_witness, decommitment,
                             self.merkle_tree.root())


def _zero_layer(domain: LineDomain, device, mesh) -> LineEvaluation:
    """The zero evaluation the first circle column folds into: this rank's
    slice where the mesh shards the layer."""
    if mesh is not None and mesh.shards(domain.log_size()):
        return LineEvaluation(
            domain, torch.zeros((4, domain.size() // mesh.size),
                                dtype=torch.int32, device=device), mesh)
    return LineEvaluation.new_zero(domain, device)


def _fold_circle_into(layer: LineEvaluation, column: SecureEvaluation,
                      alpha: torch.Tensor, mesh) -> LineEvaluation:
    """layer * alpha^2 + the circle-to-line fold of `column`.  A sharded
    layer folds the slice of a column sharded with it; a replicated layer
    gathers a sharded column first (the layer at the threshold)."""
    itw = fri_ops.domain_y_itwiddles(column.domain, layer.values.device)
    if layer.mesh is not None:
        from .parallel.ops import sharded_fold_circle_into_line

        return LineEvaluation(layer.domain, sharded_fold_circle_into_line(
            mesh, layer.values, column.values, itw, alpha), mesh)
    src = column.values
    if column.mesh is not None:
        from .parallel.ops import gather_points

        src = gather_points(mesh, src)
    return LineEvaluation(layer.domain, fri_ops.fold_circle_into_line(
        layer.values, src, itw, alpha))


def _fold_line(layer: LineEvaluation, twiddles: TwiddleTree,
               alpha: torch.Tensor, mesh) -> LineEvaluation:
    """The next FRI layer: a sharded layer folds its slice, and the fold
    is gathered once it falls under the mesh's sharding threshold."""
    domain = layer.domain.double()
    itw = twiddles.layer_of_size(len(layer) // 2, inverse=True,
                                 device=layer.values.device)
    if layer.mesh is None:
        return LineEvaluation(domain,
                              fri_ops.fold_line(layer.values, itw, alpha))
    from .parallel.ops import gather_points, sharded_fold_line

    folded = sharded_fold_line(mesh, layer.values, itw, alpha)
    if mesh.shards(domain.log_size()):
        return LineEvaluation(domain, folded, mesh)
    return LineEvaluation(domain, gather_points(mesh, folded))


class FriProver:
    def __init__(self, config, first_layer, inner_layers, last_layer_poly):
        self.config = config
        self.first_layer = first_layer
        self.inner_layers = inner_layers
        self.last_layer_poly = last_layer_poly

    @staticmethod
    def _validate_columns(columns: List[SecureEvaluation]) -> None:
        if not columns:
            raise ValueError("no columns")
        if not all(se.domain.is_canonic() for se in columns):
            raise ValueError("not canonic")
        sizes = [se.domain.size() for se in columns]
        if any(sizes[i] <= sizes[i + 1] for i in range(len(sizes) - 1)):
            raise ValueError("column sizes not decreasing")

    @staticmethod
    def commit(channel, config: FriConfig, columns: List[SecureEvaluation],
               twiddles: TwiddleTree, merkle_ops=Blake2sMerkleOps,
               mesh=None) -> "FriProver":
        """FRI commitment with the transcript on the device.

        Every layer's Merkle root is mixed and its alpha drawn by one
        launch of the transcript kernel (channel/device.py), and each fold
        reads alpha where it lies: the commit is a sequence of launches
        with no host read in it (`commit_dispatch`), then one fetch that
        brings the transcript state, the last layer and every root to the
        host (`finish`).  Bit-exact with `commit_host`.  A flavour whose
        `fused_fri_transcript` is False (Poseidon252) takes `commit_host`.
        Under a mesh every rank runs the same transcript on its replicated
        roots."""
        if not merkle_ops.fused_fri_transcript:
            return FriProver.commit_host(channel, config, columns, twiddles,
                                         merkle_ops, mesh)
        return FriProver.commit_dispatch(channel, config, columns, twiddles,
                                         merkle_ops, mesh)()

    @staticmethod
    def commit_dispatch(channel, config: FriConfig,
                        columns: List[SecureEvaluation],
                        twiddles: TwiddleTree, merkle_ops=Blake2sMerkleOps,
                        mesh=None):
        """The part of `commit` before its fetch: an asynchronous upload of
        the channel state, then launches only (the folds' twiddles are
        cached per device: a warm commit uploads none).  Returns
        `finish()`, which makes the one fetch, syncs the host channel and
        commits the last layer, returning the FriProver."""
        FriProver._validate_columns(columns)
        device = columns[0].values.device
        with span("fri_fused_dispatch"):
            state = list(device_channel.state_from_channel(channel, device))
            trees = []

            def step(tree):
                state[0], state[1], alpha = \
                    device_channel.mix_root_and_draw_felt(
                        state[0], merkle_ops.device_root_words(tree))
                trees.append(tree)
                return alpha

            first_layer = FriFirstLayerProver(columns, merkle_ops=merkle_ops,
                                              mesh=mesh)
            inner_layers, last_eval = FriProver._commit_inner_layers(
                config, columns, twiddles, first_layer.merkle_tree, step,
                merkle_ops, mesh)

        def finish() -> "FriProver":
            # one transfer: the transcript state, the last layer's values
            # and every root (which decommit reads)
            with span("fri_state_fetch"):
                host = _to_host([*state, last_eval.values]
                                + [merkle_ops.device_root_words(t)
                                   for t in trees])
            digest, n_sent, last_vals = host[:3]
            for tree, words in zip(trees, host[3:]):
                tree.cache_root(words)
            device_channel.sync_host_channel(
                channel, digest, int(n_sent[0]) | int(n_sent[1]) << 32,
                n_mixes=len(trees))
            with span("fri_last_layer"):
                last_layer_poly = FriProver._commit_last_layer(
                    channel, config, LineEvaluation(
                        last_eval.domain, torch.from_numpy(
                            last_vals.view(np.int32))))
            return FriProver(config, first_layer, inner_layers,
                             last_layer_poly)

        return finish

    @staticmethod
    def commit_host(channel, config: FriConfig,
                    columns: List[SecureEvaluation],
                    twiddles: TwiddleTree,
                    merkle_ops=Blake2sMerkleOps, mesh=None) -> "FriProver":
        """FRI commitment with the transcript on the host: each layer's
        root is fetched and mixed before the next alpha is drawn and
        uploaded (the oracle of `commit`, and the production path of
        Poseidon252).  With `mesh`, the columns whose `mesh` is set are this
        rank's slices, and the layers they fold into stay sharded while
        `mesh.shards` splits them."""
        FriProver._validate_columns(columns)
        device = columns[0].values.device

        def step(tree):
            channel.mix_root(tree.root())
            return qm31_ops.scalar(channel.draw_felt(), device=device)

        first_layer = FriFirstLayerProver(columns, merkle_ops=merkle_ops,
                                          mesh=mesh)
        inner_layers, last_eval = FriProver._commit_inner_layers(
            config, columns, twiddles, first_layer.merkle_tree, step,
            merkle_ops, mesh)
        last_layer_poly = FriProver._commit_last_layer(channel, config, last_eval)
        return FriProver(config, first_layer, inner_layers, last_layer_poly)

    @staticmethod
    def _commit_inner_layers(config, columns, twiddles, first_tree, step,
                             merkle_ops=Blake2sMerkleOps, mesh=None):
        """The fold chain.  `step(tree)` is the transcript's move at each
        committed tree (the first layer's, then each inner layer's): mix
        its root, draw the next alpha, and return alpha as an int32 [4]
        tensor on the columns' device."""
        def folded_size(se):
            return se.domain.size() >> CIRCLE_TO_LINE_FOLD_STEP

        device = columns[0].values.device
        first_log = folded_size(columns[0]).bit_length() - 1
        domain = LineDomain.new(Coset.half_odds(first_log))
        layer_eval = _zero_layer(domain, device, mesh)
        col_iter = iter(columns)
        layers: List[FriInnerLayerProver] = []
        alpha = step(first_tree)
        layer_eval = _fold_circle_into(layer_eval, next(col_iter), alpha,
                                       mesh)
        pending = next(col_iter, None)
        while len(layer_eval) > config.last_layer_domain_size():
            layer = FriInnerLayerProver(layer_eval, merkle_ops=merkle_ops,
                                        mesh=layer_eval.mesh)
            alpha = step(layer.merkle_tree)
            layer_eval = _fold_line(layer_eval, twiddles, alpha, mesh)
            if pending is not None and folded_size(pending) == len(layer_eval):
                layer_eval = _fold_circle_into(layer_eval, pending, alpha,
                                               mesh)
                pending = next(col_iter, None)
            layers.append(layer)
        return layers, layer_eval

    @staticmethod
    def _commit_last_layer(channel, config, evaluation: LineEvaluation) -> LinePoly:
        """reference fri.ts:718-754."""
        if len(evaluation) != config.last_layer_domain_size():
            raise ValueError("last layer domain size mismatch")
        coeffs = evaluation.interpolate().into_ordered_coefficients()
        bound = 1 << config.log_last_layer_degree_bound
        zeros = coeffs[bound:]
        if any(not z.is_zero() for z in zeros):
            raise ValueError("invalid degree")
        poly = LinePoly.from_ordered_coefficients(coeffs[:bound])
        channel.mix_felts(list(poly.coeffs))
        return poly

    def decommit(self, channel) -> Tuple[FriProof, Dict[int, List[int]]]:
        """Draw the queries and open every layer at them; also returns the
        query positions per column log size for the trace trees."""
        max_log = self.first_layer.max_column_log_size()
        with span("queries"):
            queries = Queries.generate(channel, max_log,
                                       self.config.n_queries)
            positions = get_query_positions_by_log_size(
                queries, set(self.first_layer.column_log_sizes()))
        return self.decommit_on_queries(queries), positions

    def decommit_on_queries(self, queries: Queries) -> FriProof:
        with span("first_layer"):
            first = self.first_layer.decommit(queries)
        inner = []
        with span("inner_layers"):
            layer_queries = queries.fold(CIRCLE_TO_LINE_FOLD_STEP)
            for layer in self.inner_layers:
                inner.append(layer.decommit(layer_queries))
                layer_queries = layer_queries.fold(FOLD_STEP)
        return FriProof(first, inner, self.last_layer_poly)


# ---------------------------------------------------------------------------
# Verifier
# ---------------------------------------------------------------------------

class FriFirstLayerVerifier:
    def __init__(self, column_bounds, column_commitment_domains, folding_alpha,
                 proof: FriLayerProof, merkle_ops=Blake2sMerkleOps):
        self.merkle_ops = merkle_ops
        self.column_bounds = column_bounds
        self.column_commitment_domains = column_commitment_domains
        self.folding_alpha = folding_alpha
        self.proof = proof

    def verify(self, queries: Queries,
               query_evals_by_column: List[List[QM31]]) -> List[SparseEvaluation]:
        witness = iter(self.proof.fri_witness)
        positions_by_log: Dict[int, List[int]] = {}
        sparse_evals: List[SparseEvaluation] = []
        decommitted: List[M31] = []
        for domain, evals in zip(self.column_commitment_domains,
                                 query_evals_by_column):
            column_queries = queries.fold(
                queries.log_domain_size - domain.log_size())
            try:
                positions, sparse = compute_decommitment_positions_and_rebuild_evals(
                    column_queries, evals, witness, CIRCLE_TO_LINE_FOLD_STEP)
            except InsufficientWitnessError:
                raise FriVerificationError(
                    FriVerificationError.FIRST_LAYER_EVALUATIONS_INVALID)
            positions_by_log[domain.log_size()] = positions
            for subset in sparse.subset_evals:
                for v in subset:
                    decommitted.extend(v.to_m31_array())
            sparse_evals.append(sparse)
        if next(witness, None) is not None:
            raise FriVerificationError(
                FriVerificationError.FIRST_LAYER_EVALUATIONS_INVALID)
        column_log_sizes = []
        for domain in self.column_commitment_domains:
            column_log_sizes.extend([domain.log_size()] * SECURE_EXTENSION_DEGREE)
        verifier = MerkleVerifier(
            self.proof.commitment, column_log_sizes,
            hasher=self.merkle_ops.hash_node)
        try:
            verifier.verify(positions_by_log, decommitted, self.proof.decommitment)
        except MerkleVerificationError:
            raise FriVerificationError(
                FriVerificationError.FIRST_LAYER_COMMITMENT_INVALID)
        return sparse_evals


class FriInnerLayerVerifier:
    def __init__(self, degree_bound, domain: LineDomain, folding_alpha,
                 layer_index, proof: FriLayerProof,
                 merkle_ops=Blake2sMerkleOps):
        self.merkle_ops = merkle_ops
        self.degree_bound = degree_bound
        self.domain = domain
        self.folding_alpha = folding_alpha
        self.layer_index = layer_index
        self.proof = proof

    def verify_and_fold(self, queries: Queries, evals_at_queries: List[QM31]
                        ) -> Tuple[Queries, List[QM31]]:
        witness = iter(self.proof.fri_witness)
        try:
            positions, sparse = compute_decommitment_positions_and_rebuild_evals(
                queries, evals_at_queries, witness, FOLD_STEP)
        except InsufficientWitnessError:
            raise FriVerificationError(
                FriVerificationError.INNER_LAYER_EVALUATIONS_INVALID)
        if next(witness, None) is not None:
            raise FriVerificationError(
                FriVerificationError.INNER_LAYER_EVALUATIONS_INVALID)
        decommitted: List[M31] = []
        for subset in sparse.subset_evals:
            for v in subset:
                decommitted.extend(v.to_m31_array())
        verifier = MerkleVerifier(
            self.proof.commitment,
            [self.domain.log_size()] * SECURE_EXTENSION_DEGREE,
            hasher=self.merkle_ops.hash_node)
        try:
            verifier.verify({self.domain.log_size(): positions}, decommitted,
                            self.proof.decommitment)
        except MerkleVerificationError:
            raise FriVerificationError(
                FriVerificationError.INNER_LAYER_COMMITMENT_INVALID)
        folded_queries = queries.fold(FOLD_STEP)
        folded_evals = sparse.fold_line(self.folding_alpha, self.domain)
        return folded_queries, folded_evals


class FriVerifier:
    def __init__(self, config, first_layer, inner_layers, last_layer_domain,
                 last_layer_poly):
        self.config = config
        self.first_layer = first_layer
        self.inner_layers = inner_layers
        self.last_layer_domain = last_layer_domain
        self.last_layer_poly = last_layer_poly
        self.queries: Optional[Queries] = None

    @staticmethod
    def commit(channel, config: FriConfig, proof: FriProof,
               column_bounds: List[CirclePolyDegreeBound],
               merkle_ops=Blake2sMerkleOps) -> "FriVerifier":
        for i in range(len(column_bounds) - 1):
            if (column_bounds[i].log_degree_bound
                    < column_bounds[i + 1].log_degree_bound):
                raise ValueError("column bounds not sorted descending")
        channel.mix_root(proof.first_layer.commitment)
        max_bound = column_bounds[0]
        column_commitment_domains = [
            CanonicCoset.new(b.log_degree_bound
                             + config.log_blowup_factor).circle_domain()
            for b in column_bounds
        ]
        first_layer = FriFirstLayerVerifier(
            column_bounds, column_commitment_domains, channel.draw_felt(),
            proof.first_layer, merkle_ops=merkle_ops)
        inner_layers = []
        layer_bound = max_bound.fold_to_line()
        layer_domain = LineDomain.new(
            Coset.half_odds(layer_bound.log_degree_bound
                            + config.log_blowup_factor))
        for i, layer_proof in enumerate(proof.inner_layers):
            channel.mix_root(layer_proof.commitment)
            inner_layers.append(FriInnerLayerVerifier(
                layer_bound, layer_domain, channel.draw_felt(), i, layer_proof,
                merkle_ops=merkle_ops))
            folded = layer_bound.fold(FOLD_STEP)
            if folded is None:
                raise FriVerificationError(
                    FriVerificationError.INVALID_NUM_FRI_LAYERS)
            layer_bound = folded
            layer_domain = layer_domain.double()
        if layer_bound.log_degree_bound != config.log_last_layer_degree_bound:
            raise FriVerificationError(
                FriVerificationError.INVALID_NUM_FRI_LAYERS)
        last_layer_domain = layer_domain
        last_layer_poly = proof.last_layer_poly
        if len(last_layer_poly) > (1 << config.log_last_layer_degree_bound):
            raise FriVerificationError(
                FriVerificationError.LAST_LAYER_DEGREE_INVALID)
        channel.mix_felts(list(last_layer_poly.coeffs))
        return FriVerifier(config, first_layer, inner_layers, last_layer_domain,
                           last_layer_poly)

    def sample_query_positions(self, channel) -> Dict[int, List[int]]:
        column_log_sizes = {d.log_size()
                            for d in self.first_layer.column_commitment_domains}
        max_log = max(column_log_sizes)
        queries = Queries.generate(channel, max_log, self.config.n_queries)
        self.queries = queries
        return get_query_positions_by_log_size(queries, column_log_sizes)

    def decommit(self, first_layer_query_evals: List[List[QM31]]) -> None:
        if self.queries is None:
            raise RuntimeError("queries not sampled")
        return self.decommit_on_queries(self.queries, first_layer_query_evals)

    def decommit_on_queries(self, queries: Queries,
                            first_layer_query_evals: List[List[QM31]]) -> None:
        expected_log = self.first_layer.column_commitment_domains[0].log_size()
        if queries.log_domain_size != expected_log:
            raise ValueError("queries log domain size mismatch")
        sparse_evals = self.first_layer.verify(queries, first_layer_query_evals)
        inner_queries = queries.fold(CIRCLE_TO_LINE_FOLD_STEP)
        last_queries, last_evals = self._decommit_inner_layers(
            inner_queries, sparse_evals)
        self._decommit_last_layer(last_queries, last_evals)

    def _decommit_inner_layers(self, queries: Queries,
                               first_layer_sparse_evals: List[SparseEvaluation]
                               ) -> Tuple[Queries, List[QM31]]:
        layer_queries = queries
        layer_query_evals = [QM31.zero()] * len(layer_queries)
        sparse_iter = iter(first_layer_sparse_evals)
        bounds = list(self.first_layer.column_bounds)
        domains = list(self.first_layer.column_commitment_domains)
        bi = 0
        previous_folding_alpha = self.first_layer.folding_alpha
        for layer in self.inner_layers:
            while (bi < len(bounds)
                   and bounds[bi].fold_to_line().log_degree_bound
                   == layer.degree_bound.log_degree_bound):
                domain = domains[bi]
                sparse = next(sparse_iter)
                folded = sparse.fold_circle(previous_folding_alpha, domain)
                accumulate_line(layer_query_evals, folded, previous_folding_alpha)
                bi += 1
            layer_queries, layer_query_evals = layer.verify_and_fold(
                layer_queries, layer_query_evals)
            previous_folding_alpha = layer.folding_alpha
        if bi != len(bounds) or next(sparse_iter, None) is not None:
            raise FriVerificationError(
                FriVerificationError.INVALID_NUM_FRI_LAYERS)
        return layer_queries, layer_query_evals

    def _decommit_last_layer(self, queries: Queries,
                             query_evals: List[QM31]) -> None:
        for query, eval_ in zip(queries.positions, query_evals):
            x = self.last_layer_domain.at(
                bit_reverse_index(query, self.last_layer_domain.log_size()))
            if self.last_layer_poly.eval_at_point(QM31.from_base(x)) != eval_:
                raise FriVerificationError(
                    FriVerificationError.LAST_LAYER_EVALUATIONS_INVALID)
