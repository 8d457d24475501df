"""Merkle commitment prover over mixed-size base-field columns.

Layer hashing runs batched on the columns' device (ops/blake2s) and every
layer stays there; the query-dependent decommitment logic is host-side
but touches only the queried indices: the traversal is planned on indices
alone, in numpy arrays for the whole tree, then the few needed hashes and
column values are gathered on the device, copied to the host in one
transfer per tree and turned into the proof's digests and M31s in bulk.
(reference vcs/prover.ts:13-109, mirroring Rust stwo vcs/prover.rs.)
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..fields import M31
from ..tracing import count, span
from ..ops.blake2s import TAIL_LOG, merkle_tail
from ..utils import to_numpy_u32, upload
from .blake2s_merkle import commit_on_layer


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


# a node of the traversal as one int64 key: its depth below the leaves
# (the layer of log n_layers - 1 - depth) above _NODE_BITS, its index below,
# so that sorting keys orders the traversal (layers big->small, nodes up)
_NODE_BITS = 40
_NODE_MASK = (1 << _NODE_BITS) - 1


def plan_decommitment(queries_per_log_size: Mapping[int, Sequence[int]],
                      n_layers: int, columns: Sequence[torch.Tensor],
                      log_sizes: Optional[Sequence[int]] = None):
    """Index-only traversal, per layer (big->small): the visited nodes
    `node_idxs`, the children whose hashes enter the witness `hash_idxs`,
    and `queried`, which of the nodes carry queried values (reference
    vcs/prover.ts:32-109).  Queries are sorted and distinct.  A layer visits
    its own queries and the parents of the layer below's nodes, so the
    visited nodes of a tree are every query's ancestors: one array for the
    whole tree, split by layer.  `log_sizes` are the columns' log sizes
    where their lengths do not say it (the rank's slice of a sharded
    column)."""
    if log_sizes is None:
        log_sizes = [int(c.shape[-1]).bit_length() - 1 for c in columns]
    order = sorted(range(len(columns)), key=lambda i: -log_sizes[i])
    top = n_layers - 1
    visits, direct = [np.zeros(0, np.int64)], [np.zeros(0, np.int64)]
    for log, positions in queries_per_log_size.items():
        if not 0 <= log <= top or not len(positions):
            continue
        q = np.asarray(positions, dtype=np.int64)
        up = np.arange(log + 1, dtype=np.int64)[:, None]
        direct.append(((top - log) << _NODE_BITS) | q)
        visits.append(((top - log + up) << _NODE_BITS) | (q >> up))
    keys = np.unique(np.concatenate(visits, axis=None))
    depth, nodes = keys >> _NODE_BITS, keys & _NODE_MASK
    queried = np.isin(keys, np.concatenate(direct), assume_unique=True)
    # the two children of every node above the leaves; those the layer
    # below does not visit are the hash witness
    inner = depth > 0
    children = ((((depth[inner] - 1) << _NODE_BITS) | (nodes[inner] << 1)
                 )[:, None] + np.arange(2)).ravel()
    at = np.minimum(np.searchsorted(keys, children), len(keys) - 1)
    witness = children[keys[at] != children]
    bounds = np.arange(n_layers + 1, dtype=np.int64) << _NODE_BITS
    layer_at = np.searchsorted(keys, bounds)
    # a child at depth d is the witness of its parent's layer, depth d + 1
    witness_at = np.searchsorted(witness, bounds - (1 << _NODE_BITS))
    witness = witness & _NODE_MASK
    layer_plans = []
    col_idx = 0
    for d in range(n_layers):
        layer_log = top - d
        layer_cols: List[torch.Tensor] = []
        while (col_idx < len(order)
               and log_sizes[order[col_idx]] == layer_log):
            layer_cols.append(columns[order[col_idx]])
            col_idx += 1
        a, b = layer_at[d], layer_at[d + 1]
        layer_plans.append({
            "log": layer_log,
            "cols": layer_cols,
            "node_idxs": nodes[a:b],
            "hash_idxs": witness[witness_at[d]:witness_at[d + 1]],
            "queried": queried[a:b],
        })
    return layer_plans


def _gather(requests: Sequence[Tuple[Sequence[torch.Tensor], Sequence[int]]],
            device) -> List[torch.Tensor]:
    """For each request (column entries, idxs), the rows of every entry at
    idxs, as one device tensor [n_columns, len(idxs)].  Every request's
    indices go to the device in one upload: a copy from pageable host
    memory synchronises the stream, so an upload per request would wait
    for the gathers queued before it."""
    if not requests:
        return []
    flat = upload(torch.from_numpy(np.concatenate(
        [np.asarray(idxs, dtype=np.int64) for _, idxs in requests])), device)
    out, at = [], 0
    for cols, idxs in requests:
        idx = flat[at:at + len(idxs)]
        at += len(idxs)
        rows = [(c if c.ndim == 2 else c[None, :]).index_select(-1, idx)
                for c in cols]
        out.append(rows[0] if len(rows) == 1 else torch.cat(rows, dim=0))
    return out


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
    def digests(words) -> List[bytes]:
        """The nodes of a layer, their words [8, k] on the host, as the
        proof holds them: one little-endian byte string cut every 32 bytes.
        Each flavour gives its own."""
        flat = np.ascontiguousarray(np.asarray(words).T, dtype="<u4").tobytes()
        return [flat[i:i + 32] for i in range(0, len(flat), 32)]

    def digest(self, words):
        """One node, its 8 words on the host, as the proof holds it."""
        return self.digests(np.asarray(words).reshape(8, 1))[0]

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
        requests, slots = [], []
        for plan in plans:
            log = plan["log"]
            slot = {}
            if len(plan["hash_idxs"]):
                slot["hashes"] = len(requests)
                requests.append(([self.layers[log + 1]], plan["hash_idxs"]))
            if len(plan["node_idxs"]) and plan["cols"]:
                slot["values"] = len(requests)
                requests.append((plan["cols"], plan["node_idxs"]))
            slots.append(slot)
        host = _to_host(_gather(requests, self.layers[0].device))
        return [(host[slot["hashes"]] if "hashes" in slot else None,
                 host[slot["values"]] if "values" in slot else None)
                for slot in slots]

    def _assemble(self, plans, witness_parts
                  ) -> Tuple[List[M31], MerkleDecommitment]:
        """The queried values and the decommitment, in the traversal's
        order, from the host arrays of `_witness_parts`: the hash witness
        is every layer's hashes in turn, and a layer's values, node by
        node, go to the queried values or the column witness."""
        hashes = [np.zeros((8, 0), np.uint32)]
        queried, witness = [np.zeros(0, np.uint32)], [np.zeros(0, np.uint32)]
        for plan, (layer_hashes, values) in zip(plans, witness_parts):
            if layer_hashes is not None:
                hashes.append(layer_hashes)
            if values is not None:
                rows = values.T
                queried.append(rows[plan["queried"]].ravel())
                witness.append(rows[~plan["queried"]].ravel())
        hashes = np.concatenate(hashes, axis=1)
        queried, witness = np.concatenate(queried), np.concatenate(witness)
        count("decommit_hashes", hashes.shape[1])
        count("decommit_values", len(queried) + len(witness))
        return M31.many(queried.tolist()), MerkleDecommitment(
            self.digests(hashes), M31.many(witness.tolist()))
