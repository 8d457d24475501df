"""Merkle decommitment verifier (host side).

reference vcs/verifier.ts:15-155, mirroring Rust stwo vcs/verifier.rs.
"""
from __future__ import annotations

from collections import Counter
from dataclasses import dataclass
from typing import List, Mapping, Optional, Sequence, Tuple

from ..fields import M31
from .blake2s_merkle import hash_node
from .prover import MerkleDecommitment
from .utils import Peekable, next_decommitment_node


class MerkleVerificationError(Exception):
    WITNESS_TOO_SHORT = "Witness is too short"
    WITNESS_TOO_LONG = "Witness is too long."
    TOO_MANY_QUERIED = "too many Queried values"
    TOO_FEW_QUERIED = "too few queried values"
    ROOT_MISMATCH = "Root mismatch."


@dataclass
class MerkleVerifier:
    root: bytes
    column_log_sizes: List[int]

    def __post_init__(self):
        self.n_columns_per_log_size = Counter(self.column_log_sizes)

    def verify(
        self,
        queries_per_log_size: Mapping[int, Sequence[int]],
        queried_values: Sequence[M31],
        decommitment: MerkleDecommitment,
    ) -> None:
        if not self.column_log_sizes:
            return
        max_log = max(self.column_log_sizes)
        qi = 0  # queried values cursor
        hi = 0  # hash witness cursor
        ci = 0  # column witness cursor
        last_layer: Optional[List[Tuple[int, bytes]]] = None
        for layer_log in range(max_log, -1, -1):
            n_cols = self.n_columns_per_log_size.get(layer_log, 0)
            layer_total: List[Tuple[int, bytes]] = []
            prev_queries = Peekable([q for q, _ in (last_layer or [])])
            prev_hashes = Peekable(last_layer or [])
            direct_q = Peekable(list(queries_per_log_size.get(layer_log, [])))
            while True:
                node = next_decommitment_node(prev_queries, direct_q)
                if node is None:
                    break
                while (prev_queries.peek() is not None
                       and prev_queries.peek() // 2 == node):
                    prev_queries.next()
                node_hashes = None
                if last_layer is not None:
                    def take(idx):
                        pk = prev_hashes.peek()
                        if pk is not None and pk[0] == idx:
                            return prev_hashes.next()[1]
                        return None
                    left = take(2 * node)
                    if left is None:
                        if hi >= len(decommitment.hash_witness):
                            raise MerkleVerificationError(
                                MerkleVerificationError.WITNESS_TOO_SHORT)
                        left = decommitment.hash_witness[hi]
                        hi += 1
                    right = take(2 * node + 1)
                    if right is None:
                        if hi >= len(decommitment.hash_witness):
                            raise MerkleVerificationError(
                                MerkleVerificationError.WITNESS_TOO_SHORT)
                        right = decommitment.hash_witness[hi]
                        hi += 1
                    node_hashes = (left, right)
                read_queried = direct_q.peek() == node
                if read_queried:
                    direct_q.next()
                node_values: List[M31] = []
                for _ in range(n_cols):
                    if read_queried:
                        if qi >= len(queried_values):
                            raise MerkleVerificationError(
                                MerkleVerificationError.TOO_FEW_QUERIED)
                        node_values.append(queried_values[qi])
                        qi += 1
                    else:
                        if ci >= len(decommitment.column_witness):
                            raise MerkleVerificationError(
                                MerkleVerificationError.WITNESS_TOO_SHORT)
                        node_values.append(decommitment.column_witness[ci])
                        ci += 1
                layer_total.append((node, hash_node(node_hashes, node_values)))
            last_layer = layer_total
        if hi != len(decommitment.hash_witness):
            raise MerkleVerificationError(MerkleVerificationError.WITNESS_TOO_LONG)
        if qi != len(queried_values):
            raise MerkleVerificationError(MerkleVerificationError.TOO_MANY_QUERIED)
        if ci != len(decommitment.column_witness):
            raise MerkleVerificationError(MerkleVerificationError.WITNESS_TOO_LONG)
        assert last_layer is not None
        if last_layer[0][1] != self.root:
            raise MerkleVerificationError(MerkleVerificationError.ROOT_MISMATCH)
