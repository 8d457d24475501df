"""Poseidon252 Merkle hashing: host node hash + device-batched prover;
packs 8 M31 per felt252 (reference vcs/poseidon252_merkle.ts).

The prover is the Blake2s one (vcs/prover.py) with another layer hash and
another digest type: a layer is felts [8, 2^log] (ops/poseidon252.py), the
shape of a Blake2s layer, so the index plan, the gathers and the
one-transfer decommit are shared.  Every layer of a tree on a CUDA device
is one launch of csrc/poseidon252.cu's layer kernel; every layer of a CPU
tree goes through its plain version.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..channel.poseidon import (P252, FieldElement252, Poseidon252Channel,
                                poseidon_hash_many)
from ..fields import M31
from ..ops import poseidon252 as pos
from .prover import MerkleProver, empty_tree_device

ELEMENTS_IN_BLOCK = pos.ELEMENTS_IN_BLOCK


def construct_felt252_from_m31s(word: Sequence[M31]) -> int:
    """Pack 8 M31 limbs into one felt252 (31 bits each, first limb highest)."""
    if len(word) != 8:
        raise ValueError("expected exactly 8 M31 elements")
    acc = 0
    for limb in word:
        acc = (acc << 31) | limb.value
    return acc % P252


def hash_node(children: Optional[Tuple[FieldElement252, FieldElement252]],
              column_values: Sequence[M31]) -> FieldElement252:
    n_blocks = -(-len(column_values) // ELEMENTS_IN_BLOCK) if column_values else 0
    values = []
    if children is not None:
        values.append(children[0].value)
        values.append(children[1].value)
    padded = list(column_values) + [M31.zero()] * (
        ELEMENTS_IN_BLOCK * n_blocks - len(column_values))
    for i in range(0, len(padded), ELEMENTS_IN_BLOCK):
        values.append(construct_felt252_from_m31s(padded[i: i + 8]))
    return FieldElement252(poseidon_hash_many(values))


class Poseidon252MerkleChannel:
    @staticmethod
    def mix_root(channel: Poseidon252Channel, root: FieldElement252) -> None:
        channel.mix_root(root)


class Poseidon252MerkleProver(MerkleProver):
    """Mixed-size-column Merkle tree over felt252 nodes (reference
    vcs/poseidon252_merkle.ts:19-56 + vcs/prover.ts:13-109).  layers[log]
    is the felt batch int32 [8, 2^log]; roots and hash witnesses are
    FieldElement252."""

    @staticmethod
    def commit(columns: Sequence[torch.Tensor], device=None
               ) -> "Poseidon252MerkleProver":
        """Entries of `columns` are single columns [n] or stacks [C, n];
        the tree hashes them in the given order within each size, largest
        size first.  Without columns the tree is the one node that hashes
        no value, on `device`, which must then be given."""
        cols = sorted(columns, key=lambda c: -c.shape[-1])
        if not cols:
            return Poseidon252MerkleProver(
                [pos.merkle_layer(None, [], 1, empty_tree_device(device))])
        max_log = int(cols[0].shape[-1]).bit_length() - 1
        layers: List[Optional[torch.Tensor]] = [None] * (max_log + 1)
        prev = None
        for log in range(max_log, -1, -1):
            prev = pos.merkle_layer(
                prev, [c for c in cols if c.shape[-1] == 1 << log])
            layers[log] = prev
        return Poseidon252MerkleProver(layers)

    @staticmethod
    def _hash_layer(log: int, prev: Optional[torch.Tensor],
                    columns: Sequence[torch.Tensor], device) -> torch.Tensor:
        return pos.merkle_layer(prev, columns, 1 << log, device)

    @staticmethod
    def digests(words) -> List[FieldElement252]:
        """Felts [8, k] (word i of a felt weighs 2^(32 i)) as the proof's
        FieldElement252s: each felt's 32 little-endian bytes read as one
        integer."""
        flat = np.ascontiguousarray(np.asarray(words).T, dtype="<u4").tobytes()
        return [FieldElement252(int.from_bytes(flat[i:i + 32], "little"))
                for i in range(0, len(flat), 32)]
