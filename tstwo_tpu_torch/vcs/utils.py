"""Peekable-merge helpers for Merkle decommitment traversal.

reference vcs/utils.ts:39-64.
"""
from __future__ import annotations

from typing import Iterable, List, Optional, Sequence


class Peekable:
    def __init__(self, items: Sequence):
        self._items = list(items)
        self._i = 0

    def peek(self):
        return self._items[self._i] if self._i < len(self._items) else None

    def next(self):
        v = self.peek()
        self._i += 1
        return v

    def next_if_eq(self, value) -> bool:
        if self.peek() == value:
            self._i += 1
            return True
        return False

    def __bool__(self):
        return self._i < len(self._items)


def next_decommitment_node(prev_queries: Peekable,
                           layer_queries: Peekable) -> Optional[int]:
    """min(parent of next child query, next direct query)
    (reference vcs/utils.ts:39-64)."""
    candidates = []
    if prev_queries.peek() is not None:
        candidates.append(prev_queries.peek() // 2)
    if layer_queries.peek() is not None:
        candidates.append(layer_queries.peek())
    return min(candidates) if candidates else None
