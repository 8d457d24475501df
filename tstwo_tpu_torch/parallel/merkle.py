"""Sharded Merkle commitment and decommitment, of either flavour.

Rank r of D = 2^k holds the slice [r*n/D, (r+1)*n/D) of every sharded
column; for bit-reversed evaluations that is the leaf range of one whole
subtree, whose root is node r of layer k.  So each rank commits its
slices down to its subroot with the flavour's own tree (`merkle_ops.commit`:
the hand `blake2s`, `merkle_layer` and `merkle_tail` kernels on a CUDA
rank for Blake2s, `poseidon_merkle_layer` for Poseidon252), one
all_gather brings the D subroots to every rank, and every rank hashes the
top k layers itself with the flavour's layer hash.  Both flavours' layers
are int32 [8, 2^log], so the gather, the index plan and the witness
gathers are shared; roots and hash witnesses are the flavour's digest
(bytes or FieldElement252).  A replicated column (under the sharding
threshold, `Mesh.shards`) enters where its layer lies: sliced into the
subtrees at log k or more, whole into the top below that.

`decommit` runs the single-device traversal on indices, answers each
needed hash or value from the rank that holds it (`parallel.ops.gather_at`,
one all_gather), so that every rank builds the same MerkleDecommitment.

The JAX package needs no such file: there GSPMD partitions the flavour's
Merkle prover over sharded inputs.
"""
from __future__ import annotations

from typing import List, Mapping, Optional, Sequence

import torch

from ..vcs.ops import Blake2sMerkleOps
from ..vcs.prover import MerkleProver, _to_host, plan_decommitment
from .mesh import Mesh
from .ops import gather_at, shard_points


def _commit_top(merkle_ops, subroots: torch.Tensor,
                columns: Sequence[torch.Tensor], log_sizes: Sequence[int],
                device) -> List[torch.Tensor]:
    """Layers k - 1 down to 0 of the tree, from the D subroots [8, D] (a
    view of any strides) and the whole columns of those sizes, each one
    launch of the flavour's layer kernel on a CUDA rank."""
    hash_layer = merkle_ops.prover_cls()._hash_layer
    prev = subroots.contiguous()  # the Blake2s layer kernel needs it
    k = int(subroots.shape[1]).bit_length() - 1
    layers = []
    for log in range(k - 1, -1, -1):
        prev = hash_layer(log, prev, [c for c, l in zip(columns, log_sizes)
                                      if l == log], device)
        layers.append(prev)
    return layers[::-1]


class ShardedMerkleProver(MerkleProver):
    """A Merkle tree over the columns of a mesh, of the flavour
    `merkle_ops` (vcs/ops.py).  Where `sharded`, layers of log k =
    mesh.log_size or more are this rank's slices ([8, 2^(log - k)]) and
    the layers above them whole; otherwise every layer is whole (no
    column reached the sharding threshold)."""

    def __init__(self, mesh: Mesh, layers: List[torch.Tensor],
                 sharded: bool, merkle_ops=Blake2sMerkleOps):
        super().__init__(layers)
        self.mesh = mesh
        self.sharded = sharded
        self.merkle_ops = merkle_ops

    def digests(self, words):
        return self.merkle_ops.prover_cls().digests(words)

    @staticmethod
    def commit(mesh: Mesh, columns: Sequence[torch.Tensor],
               log_sizes: Sequence[int], merkle_ops=Blake2sMerkleOps
               ) -> "ShardedMerkleProver":
        """Entries of `columns` are [n] or [C, n]: this rank's slices of
        the columns `mesh.shards` splits, the whole columns otherwise;
        `log_sizes` their log sizes."""
        k = mesh.log_size
        if not any(mesh.shards(log) for log in log_sizes):
            tree = merkle_ops.commit(list(columns), mesh.device)
            return ShardedMerkleProver(mesh, tree.layers, False, merkle_ops)
        local = []
        for col, log in zip(columns, log_sizes):
            if log < k:
                continue
            part = col if mesh.shards(log) else shard_points(mesh, col)
            local.append(part)
            mesh.leaf_rows.append((log, part.shape[0] if part.ndim == 2
                                   else 1, int(part.shape[-1])))
        subtree = merkle_ops.commit(local)
        layers: List[Optional[torch.Tensor]] = [None] * (max(log_sizes) + 1)
        layers[k:] = subtree.layers
        if k:
            # node r of layer k is rank r's subroot
            roots = mesh.all_gather(subtree.layers[0])  # [D, 8, 1]
            layers[:k] = _commit_top(merkle_ops, roots[:, :, 0].t(), columns,
                                     log_sizes, mesh.device)
        return ShardedMerkleProver(mesh, layers, True, merkle_ops)

    def decommit(self, queries_per_log_size: Mapping[int, Sequence[int]],
                 columns: Sequence[torch.Tensor],
                 log_sizes: Optional[Sequence[int]] = None):
        """The witness of the whole tree, the same on every rank; the
        columns as they were committed, with their log sizes."""
        if log_sizes is None:
            raise ValueError("a sharded tree needs its columns' log sizes")
        plans = plan_decommitment(queries_per_log_size, len(self.layers),
                                  columns, log_sizes)
        return self._assemble(plans, self._witness_parts(plans))

    def _witness_parts(self, plans):
        k = self.mesh.log_size
        requests, slots = [], []
        for plan in plans:
            log = plan["log"]
            slot = {}
            if len(plan["hash_idxs"]):
                slot["hashes"] = len(requests)
                requests.append(([self.layers[log + 1]], plan["hash_idxs"],
                                 log + 1, self.sharded and log + 1 >= k))
            if len(plan["node_idxs"]) and plan["cols"]:
                slot["values"] = len(requests)
                requests.append((plan["cols"], plan["node_idxs"], log,
                                 self.mesh.shards(log)))
            slots.append(slot)
        host = _to_host(gather_at(self.mesh, requests))
        return [(host[slot["hashes"]] if "hashes" in slot else None,
                 host[slot["values"]] if "values" in slot else None)
                for slot in slots]
