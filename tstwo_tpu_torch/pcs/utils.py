"""TreeVec: per-commitment-tree container (reference pcs/utils.ts:14)."""
from __future__ import annotations

from typing import Callable, Iterable, List, TypeVar

T = TypeVar("T")


class TreeVec(list):
    """A list indexed by commitment-tree, with column-wise helpers."""

    def map(self, fn: Callable) -> "TreeVec":
        return TreeVec(fn(x) for x in self)

    def map_cols(self, fn: Callable) -> "TreeVec":
        return TreeVec([fn(col) for col in tree] for tree in self)

    def zip(self, other: "TreeVec") -> "TreeVec":
        if len(self) != len(other):
            raise ValueError("TreeVec.zip length mismatch")
        return TreeVec(zip(self, other))

    def zip_cols(self, other: "TreeVec") -> "TreeVec":
        if len(self) != len(other):
            raise ValueError("TreeVec.zip_cols length mismatch")
        return TreeVec(
            [list(pair) for pair in zip(a, b)] for a, b in zip(self, other))

    def flatten(self) -> list:
        return [col for tree in self for col in tree]

    def flatten_cols(self) -> list:
        return [v for tree in self for col in tree for v in col]


def concat_cols(trees: Iterable[TreeVec]) -> TreeVec:
    """Concatenate column lists tree-index-wise (air/components use)."""
    out = TreeVec()
    for tv in trees:
        while len(out) < len(tv):
            out.append([])
        for i, cols in enumerate(tv):
            out[i] = out[i] + list(cols)
    return out
