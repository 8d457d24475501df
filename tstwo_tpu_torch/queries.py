"""FRI query positions (host side).

reference queries.ts:21-191, mirroring Rust stwo queries.rs.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List, Sequence, Set

UPPER_BOUND_QUERY_BYTES = 4


@dataclass(frozen=True)
class Queries:
    positions: tuple  # sorted, deduped ints
    log_domain_size: int

    @staticmethod
    def generate(channel, log_domain_size: int, n_queries: int) -> "Queries":
        """Draw positions 4 bytes at a time until n distinct
        (reference queries.ts:52-86)."""
        seen: Set[int] = set()
        max_query = (1 << log_domain_size) - 1
        while len(seen) < n_queries:
            data = channel.draw_random_bytes()
            for i in range(0, len(data) - UPPER_BOUND_QUERY_BYTES + 1,
                           UPPER_BOUND_QUERY_BYTES):
                bits = int.from_bytes(data[i: i + 4], "little")
                seen.add(bits & max_query)
                if len(seen) == n_queries:
                    break
        return Queries(tuple(sorted(seen)), log_domain_size)

    @staticmethod
    def from_positions(positions: Sequence[int], log_domain_size: int) -> "Queries":
        pos = list(positions)
        if pos != sorted(pos):
            raise ValueError("positions must be sorted")
        if pos and pos[-1] >= (1 << log_domain_size):
            raise ValueError("position out of domain")
        return Queries(tuple(pos), log_domain_size)

    def fold(self, n_folds: int) -> "Queries":
        if n_folds > self.log_domain_size:
            raise ValueError("n_folds too large")
        folded = sorted({p >> n_folds for p in self.positions})
        return Queries(tuple(folded), self.log_domain_size - n_folds)

    def __len__(self) -> int:
        return len(self.positions)

    def __iter__(self):
        return iter(self.positions)


def get_query_positions_by_log_size(
    queries: Queries, column_log_sizes: Iterable[int]
) -> Dict[int, List[int]]:
    """reference fri.ts:470-482."""
    return {
        ls: list(queries.fold(queries.log_domain_size - ls).positions)
        for ls in column_log_sizes
    }
