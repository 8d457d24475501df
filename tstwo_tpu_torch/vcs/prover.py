"""Merkle commitment prover over mixed-size base-field columns.

Layer hashing runs batched on the columns' device (ops/blake2s) and every
layer stays there; the query-dependent decommitment logic is host-side
but touches only the queried indices: the peekable merge is computed on
indices alone, then the few needed hashes and column values are gathered
on the device and copied to the host in one transfer per tree.
(reference vcs/prover.ts:13-109, mirroring Rust stwo vcs/prover.rs.)
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Mapping, Optional, Sequence, Tuple

import torch

from ..fields import M31
from ..ops.blake2s import digest_words_to_bytes
from ..utils import to_numpy_u32
from .blake2s_merkle import commit_on_layer
from .utils import Peekable, next_decommitment_node


@dataclass
class MerkleDecommitment:
    """Hash + column witness (reference vcs/verifier.ts:5-8)."""

    hash_witness: List[bytes] = field(default_factory=list)
    column_witness: List[M31] = field(default_factory=list)

    def size_estimate(self) -> int:
        return 32 * len(self.hash_witness) + 4 * len(self.column_witness)


def plan_decommitment(queries_per_log_size: Mapping[int, Sequence[int]],
                      n_layers: int, columns: Sequence[torch.Tensor]):
    """Index-only traversal: per layer (big->small) the visited nodes,
    which child hashes enter the witness, and which nodes carry queried
    values (reference vcs/prover.ts:32-109)."""
    cols_sorted = sorted(columns, key=lambda c: -c.shape[-1])
    col_idx = 0
    layer_plans = []
    last_layer_queries: List[int] = []
    for layer_log in range(n_layers - 1, -1, -1):
        layer_cols: List[torch.Tensor] = []
        while (col_idx < len(cols_sorted)
               and cols_sorted[col_idx].shape[-1] == (1 << layer_log)):
            layer_cols.append(cols_sorted[col_idx])
            col_idx += 1
        has_children = layer_log + 1 < n_layers
        plan = {
            "log": layer_log,
            "cols": layer_cols,
            "steps": [],  # (node, [child hash idxs], queried: bool)
            "hash_idxs": [],
            "node_idxs": [],
        }
        prev_q = Peekable(last_layer_queries)
        direct_q = Peekable(list(queries_per_log_size.get(layer_log, [])))
        layer_total: List[int] = []
        while True:
            node = next_decommitment_node(prev_q, direct_q)
            if node is None:
                break
            witness_children = []
            if has_children:
                if not prev_q.next_if_eq(2 * node):
                    witness_children.append(2 * node)
                if not prev_q.next_if_eq(2 * node + 1):
                    witness_children.append(2 * node + 1)
            queried = direct_q.next_if_eq(node)
            plan["steps"].append((node, witness_children, queried))
            plan["hash_idxs"].extend(witness_children)
            plan["node_idxs"].append(node)
            layer_total.append(node)
        last_layer_queries = layer_total
        layer_plans.append(plan)
    return layer_plans


def _gather(cols: Sequence[torch.Tensor], idxs: Sequence[int]):
    """Rows of every column entry at `idxs`, as one device tensor
    [n_columns, len(idxs)]."""
    idx = torch.tensor(idxs, dtype=torch.int64, device=cols[0].device)
    return torch.cat([(c if c.ndim == 2 else c[None, :]).index_select(-1, idx)
                      for c in cols], dim=0)


def _to_host(parts: Sequence[torch.Tensor]):
    """Copy device tensors to the host in one transfer; numpy uint32 arrays
    of the same shapes."""
    if not parts:
        return []
    flat = to_numpy_u32(torch.cat([p.reshape(-1) for p in parts]))
    out, at = [], 0
    for p in parts:
        out.append(flat[at:at + p.numel()].reshape(tuple(p.shape)))
        at += p.numel()
    return out


class MerkleProver:
    """Multi-column Merkle tree (one commit_on_layer per log size,
    leaves->root).  layers[log] is the word-major int32 [8, 2^log] layer."""

    def __init__(self, layers: List[torch.Tensor]):
        self.layers = layers
        self._root: Optional[bytes] = None

    @staticmethod
    def commit(columns: Sequence[torch.Tensor], device=None) -> "MerkleProver":
        """Entries of `columns` are single columns [n] or stacks [C, n] of
        C same-size columns; the tree hashes them in the given order within
        each size, largest size first."""
        cols = sorted(columns, key=lambda c: -c.shape[-1])
        if not cols:
            return MerkleProver([commit_on_layer(0, None, [],
                                                 device or "cpu")])
        max_log = int(cols[0].shape[-1]).bit_length() - 1
        layers: List[Optional[torch.Tensor]] = [None] * (max_log + 1)
        prev = None
        for log in range(max_log, -1, -1):
            layer_cols = [c for c in cols if c.shape[-1] == 1 << log]
            prev = commit_on_layer(log, prev, layer_cols)
            layers[log] = prev
        return MerkleProver(layers)

    def root(self) -> bytes:
        if self._root is None:
            self._root = digest_words_to_bytes(
                to_numpy_u32(self.layers[0][:, 0]))
        return self._root

    def decommit(
        self,
        queries_per_log_size: Mapping[int, Sequence[int]],
        columns: Sequence[torch.Tensor],
    ) -> Tuple[List[M31], MerkleDecommitment]:
        """Witness assembly (reference vcs/prover.ts:32-109).  Entries of
        `columns` may be single columns or [C, n] stacks."""
        plans = plan_decommitment(queries_per_log_size, len(self.layers),
                                  columns)
        # every hash and value the witness needs, gathered on the device and
        # copied to the host in one transfer
        parts, slots = [], []
        for plan in plans:
            log = plan["log"]
            slot = {}
            if plan["hash_idxs"]:
                slot["hashes"] = len(parts)
                parts.append(_gather([self.layers[log + 1]], plan["hash_idxs"]))
            if plan["node_idxs"] and plan["cols"]:
                slot["values"] = len(parts)
                parts.append(_gather(plan["cols"], plan["node_idxs"]))
            slots.append(slot)
        host = _to_host(parts)

        queried: List[M31] = []
        dec = MerkleDecommitment()
        for plan, slot in zip(plans, slots):
            hashes = host[slot["hashes"]] if "hashes" in slot else None
            values = host[slot["values"]] if "values" in slot else None
            hi = 0
            for si, (node, witness_children, was_queried) in enumerate(
                    plan["steps"]):
                for _ in witness_children:
                    dec.hash_witness.append(
                        digest_words_to_bytes(hashes[:, hi]))
                    hi += 1
                node_values = ([M31(int(v)) for v in values[:, si]]
                               if values is not None else [])
                if was_queried:
                    queried.extend(node_values)
                else:
                    dec.column_witness.extend(node_values)
        return queried, dec
