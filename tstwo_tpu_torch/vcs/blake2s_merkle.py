"""Blake2s Merkle hashing: host node hash + device layer hash.

node = blake2s(left || right || LE32(column values))
(reference vcs/blake2_merkle.ts:8-25).
"""
from __future__ import annotations

import hashlib
from typing import Optional, Sequence, Tuple

import torch

from ..fields import M31
from ..ops import blake2s as b2


def hash_node(children: Optional[Tuple[bytes, bytes]],
              column_values: Sequence[M31]) -> bytes:
    h = hashlib.blake2s(digest_size=32)
    if children is not None:
        h.update(children[0])
        h.update(children[1])
    for v in column_values:
        h.update(int(v.value).to_bytes(4, "little"))
    return h.digest()


def commit_on_layer(log_size: int, prev_layer: Optional[torch.Tensor],
                    columns: Sequence[torch.Tensor],
                    device=None) -> torch.Tensor:
    """Hash one Merkle layer on the columns' device.

    prev_layer: int32 [8, 2^(log+1)] digest words (word-major) of the child
    layer, or None at the leaf layer.  columns: entries of length 2^log,
    each a single column [n] or a stack [C, n] of C columns, hashed in
    order.  Returns int32 [8, 2^log].  On a CUDA device this is one launch
    (ops/blake2s.merkle_layer): the kernel reads the child pairs and the
    column rows where they lie.
    """
    return b2.merkle_layer(prev_layer, columns, 1 << log_size, device)


class Blake2sMerkleChannel:
    """MerkleChannel for Blake2s (reference vcs/blake2_merkle.ts:28-32)."""

    @staticmethod
    def mix_root(channel, root: bytes) -> None:
        channel.mix_root(root)
