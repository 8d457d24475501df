"""Merkle trees over columns of mixed sizes, and their decommitment.

Layer `log` has 2^log nodes.  The columns of 2^log values join the tree at
layer `log`: node i hashes (left child, right child, when the layer has
children) then the columns' values at row i, in column order, largest
columns first.  A tree with no column is one node that hashes nothing.
"""
from __future__ import annotations

import hashlib
from typing import Dict, List, Sequence

import torch

from .hashes import (P252, blake2s_words, bytes_to_words,
                     poseidon_hash_many, words_to_bytes)

# Layers of at most this many nodes hash one node at a time with hashlib on
# the host: a vectorised compression is ~1000 tensor operations whatever
# the layer's size, and most of a tree's layers are small.
HOST_LAYER_NODES = 256


class Blake2sTree:
    """Digests as int64 [8, nodes] LE words; a root is its hex."""

    @staticmethod
    def hash_layer(prev, columns: List[torch.Tensor], n: int, device):
        words = []
        if prev is not None:
            words += [prev[k, 0::2] for k in range(8)]
            words += [prev[k, 1::2] for k in range(8)]
        words += list(columns)
        if n > HOST_LAYER_NODES:
            return blake2s_words(words, n, device)
        rows = (torch.stack(words).t().tolist() if words
                else [[] for _ in range(n)])
        digests = [bytes_to_words(hashlib.blake2s(
            words_to_bytes(r), digest_size=32).digest()) for r in rows]
        return torch.tensor(digests, dtype=torch.int64,
                            device=device).t().contiguous()

    @staticmethod
    def digests(layer, idxs: Sequence[int]) -> List[str]:
        if not idxs:
            return []
        idx = torch.tensor(list(idxs), dtype=torch.int64, device=layer.device)
        cols = layer.index_select(1, idx).t().tolist()
        return [b"".join(int(w).to_bytes(4, "little") for w in c).hex()
                for c in cols]


class Poseidon252Tree:
    """Digests as lists of felt252 ints; eight M31 values pack into one
    felt, first value highest, the last felt padded with zeros."""

    @staticmethod
    def hash_layer(prev, columns: List[torch.Tensor], n: int, device):
        rows = (torch.stack(list(columns)).t().tolist() if columns
                else [[] for _ in range(n)])
        out = []
        for i in range(n):
            vals = [] if prev is None else [prev[2 * i], prev[2 * i + 1]]
            row = rows[i] + [0] * (-len(rows[i]) % 8)
            for j in range(0, len(row), 8):
                acc = 0
                for v in row[j: j + 8]:
                    acc = (acc << 31) | v
                vals.append(acc % P252)
            out.append(poseidon_hash_many(vals))
        return out

    @staticmethod
    def digests(layer, idxs: Sequence[int]) -> List[int]:
        return [layer[i] for i in idxs]


TREES = {"blake2s": Blake2sTree, "poseidon252": Poseidon252Tree}


class MerkleTree:
    def __init__(self, hasher, columns: Sequence[torch.Tensor], device):
        """columns: int64 [n] tensors of M31 values; stable order within a
        size."""
        self.hasher = hasher
        order = sorted(range(len(columns)),
                       key=lambda i: -int(columns[i].shape[-1]))
        self.by_log: Dict[int, List[torch.Tensor]] = {}
        for i in order:
            log = int(columns[i].shape[-1]).bit_length() - 1
            self.by_log.setdefault(log, []).append(columns[i])
        max_log = max(self.by_log, default=0)
        self.layers = [None] * (max_log + 1)
        prev = None
        for log in range(max_log, -1, -1):
            prev = hasher.hash_layer(prev, self.by_log.get(log, []),
                                     1 << log, device)
            self.layers[log] = prev

    def root(self):
        return self.hasher.digests(self.layers[0], [0])[0]

    def decommit(self, queries_per_log: Dict[int, Sequence[int]]):
        """(queried values, hash witness, column witness).  Walk the layers
        from the leaves up; at each node that a query or a child of the
        layer below reaches, the children not reached go to the hash
        witness, and the node's column values go to the queried values when
        the node is queried at this layer, else to the column witness."""
        n_layers = len(self.layers)
        queried, hash_witness, column_witness = [], [], []
        below: List[int] = []
        for log in range(n_layers - 1, -1, -1):
            direct = sorted(set(queries_per_log.get(log, [])))
            reached = sorted({c // 2 for c in below} | set(direct))
            below_set = set(below)
            direct_set = set(direct)
            witness_idx, value_rows = [], []
            for node in reached:
                if log + 1 < n_layers:
                    for child in (2 * node, 2 * node + 1):
                        if child not in below_set:
                            witness_idx.append(child)
                value_rows.append(node)
            hash_witness += (self.hasher.digests(self.layers[log + 1],
                                                 witness_idx)
                             if witness_idx else [])
            cols = self.by_log.get(log, [])
            if cols and value_rows:
                idx = torch.tensor(value_rows, dtype=torch.int64,
                                   device=cols[0].device)
                vals = torch.stack([c.index_select(0, idx) for c in cols]
                                   ).t().tolist()
                for node, row in zip(value_rows, vals):
                    (queried if node in direct_set else column_witness
                     ).extend(int(v) for v in row)
            below = reached
        return queried, hash_witness, column_witness
