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
from ..tracing import span
from ..ops.blake2s import TAIL_LOG, digest_words_to_bytes, merkle_tail
from ..utils import to_numpy_u32, upload
from .blake2s_merkle import commit_on_layer
from .utils import Peekable, next_decommitment_node


@dataclass
class MerkleDecommitment:
    """Hash + column witness (reference vcs/verifier.ts:5-8)."""

    hash_witness: list = field(default_factory=list)  # bytes or FieldElement252
    column_witness: List[M31] = field(default_factory=list)

    def size_estimate(self) -> int:
        return 32 * len(self.hash_witness) + 4 * len(self.column_witness)


def stack_column_groups(cols: Sequence[torch.Tensor]) -> torch.Tensor:
    """A layer's column entries (1-D columns and/or 2-D [C, n] stacks) as
    one 2-D [total_cols, n] tensor, in order."""
    if len(cols) == 1:
        c = cols[0]
        return c if c.ndim == 2 else c[None, :]
    if all(c.ndim == 1 for c in cols):
        return torch.stack(list(cols))
    return torch.cat([c if c.ndim == 2 else c[None, :] for c in cols], dim=0)


def column_count(cols: Sequence[torch.Tensor]) -> int:
    """Number of logical columns across 1-D / 2-D [C, n] entries."""
    return sum(int(c.shape[0]) if c.ndim == 2 else 1 for c in cols)


def plan_decommitment(queries_per_log_size: Mapping[int, Sequence[int]],
                      n_layers: int, columns: Sequence[torch.Tensor],
                      log_sizes: Optional[Sequence[int]] = None):
    """Index-only traversal: per layer (big->small) the visited nodes,
    which child hashes enter the witness, and which nodes carry queried
    values (reference vcs/prover.ts:32-109).  `log_sizes` are the
    columns' log sizes where their lengths do not say it (the rank's slice
    of a sharded column)."""
    if log_sizes is None:
        log_sizes = [int(c.shape[-1]).bit_length() - 1 for c in columns]
    order = sorted(range(len(columns)), key=lambda i: -log_sizes[i])
    col_idx = 0
    layer_plans = []
    last_layer_queries: List[int] = []
    for layer_log in range(n_layers - 1, -1, -1):
        layer_cols: List[torch.Tensor] = []
        while (col_idx < len(order)
               and log_sizes[order[col_idx]] == layer_log):
            layer_cols.append(columns[order[col_idx]])
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
    idx = upload(torch.tensor(idxs, dtype=torch.int64), cols[0].device)
    return torch.cat([(c if c.ndim == 2 else c[None, :]).index_select(-1, idx)
                      for c in cols], dim=0)


def empty_tree_device(device) -> torch.device:
    """The device of a tree without columns: the caller's, never a guess."""
    if device is None:
        raise ValueError("a tree without columns needs its device")
    return torch.device(device)


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
    leaves->root, then one merkle_tail for the layers of at most
    2^TAIL_LOG nodes once no column remains to join).  layers[log] is the
    word-major int32 [8, 2^log] layer."""

    def __init__(self, layers: List[torch.Tensor]):
        self.layers = layers
        self._root = None

    @staticmethod
    def digest(words) -> bytes:
        """A node of a layer (its 8 words on the host) as the proof holds
        it; the Poseidon252 prover overrides this."""
        return digest_words_to_bytes(words)

    @staticmethod
    def _hash_layer(log: int, prev: Optional[torch.Tensor],
                    columns: Sequence[torch.Tensor], device) -> torch.Tensor:
        """One layer [8, 2^log] of this flavour from its child layer and
        columns: the top of a sharded tree (parallel/merkle.py)."""
        return commit_on_layer(log, prev, columns, device)

    @staticmethod
    def commit(columns: Sequence[torch.Tensor], device=None) -> "MerkleProver":
        """Entries of `columns` are single columns [n] or stacks [C, n] of
        C same-size columns; the tree hashes them in the given order within
        each size, largest size first.  A tree lives where its columns do;
        without columns it is the one node that hashes no value, on
        `device`, which must then be given."""
        cols = sorted(columns, key=lambda c: -c.shape[-1])
        if not cols:
            return MerkleProver([commit_on_layer(
                0, None, [], empty_tree_device(device))])
        max_log = int(cols[0].shape[-1]).bit_length() - 1
        min_log = int(cols[-1].shape[-1]).bit_length() - 1
        layers: List[Optional[torch.Tensor]] = [None] * (max_log + 1)
        prev = None
        for log in range(max_log, -1, -1):
            layer_cols = [c for c in cols if c.shape[-1] == 1 << log]
            prev = commit_on_layer(log, prev, layer_cols)
            layers[log] = prev
            if 1 <= log <= min(min_log, TAIL_LOG + 1):
                # every layer above is small and takes in no column: one
                # call hashes them all, down to the root
                layers[:log] = reversed(merkle_tail(prev))
                break
        return MerkleProver(layers)

    def root(self):
        if self._root is None:
            self.cache_root(to_numpy_u32(self.layers[0][:, 0]))
        return self._root

    def cache_root(self, words) -> None:
        """Keep the root from its 8 words, fetched by the caller with other
        data in one transfer: `root()` then reads nothing."""
        self._root = self.digest(words)

    def decommit(
        self,
        queries_per_log_size: Mapping[int, Sequence[int]],
        columns: Sequence[torch.Tensor],
        log_sizes: Optional[Sequence[int]] = None,
    ) -> Tuple[List[M31], MerkleDecommitment]:
        """Witness assembly (reference vcs/prover.ts:32-109).  Entries of
        `columns` may be single columns or [C, n] stacks; `log_sizes`, if
        given, are their log sizes (the sharded tree needs them)."""
        with span("plan"):
            plans = plan_decommitment(queries_per_log_size,
                                      len(self.layers), columns, log_sizes)
        parts = self._witness_parts(plans)
        with span("assemble"):
            return self._assemble(plans, parts)

    def _witness_parts(self, plans):
        """Every hash and value the witness needs, gathered on the device
        and copied to the host in one transfer: per plan, the numpy
        [8, hashes] and [columns, nodes] arrays (or None)."""
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
        return [(host[slot["hashes"]] if "hashes" in slot else None,
                 host[slot["values"]] if "values" in slot else None)
                for slot in slots]

    def _assemble(self, plans, witness_parts
                  ) -> Tuple[List[M31], MerkleDecommitment]:
        """The queried values and the decommitment, in the traversal's
        order, from the host arrays of `_witness_parts`."""
        queried: List[M31] = []
        dec = MerkleDecommitment()
        for plan, (hashes, values) in zip(plans, witness_parts):
            hi = 0
            for si, (node, witness_children, was_queried) in enumerate(
                    plan["steps"]):
                for _ in witness_children:
                    dec.hash_witness.append(self.digest(hashes[:, hi]))
                    hi += 1
                node_values = ([M31(int(v)) for v in values[:, si]]
                               if values is not None else [])
                if was_queried:
                    queried.extend(node_values)
                else:
                    dec.column_witness.extend(node_values)
        return queried, dec
