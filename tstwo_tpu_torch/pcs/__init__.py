"""Polynomial commitment scheme (FRI-based) for circle polynomials."""
from __future__ import annotations

from dataclasses import dataclass, field

from ..fri import FriConfig
from .utils import TreeVec  # noqa: F401


@dataclass(frozen=True)
class TreeSubspan:
    """Location of a column range inside a commitment tree."""

    tree_index: int
    col_start: int
    col_end: int


@dataclass(frozen=True)
class PcsConfig:
    """pow_bits + FriConfig; Rust default (5, FriConfig(0, 1, 3))
    (reference pcs/index.ts:55-62 embedded Rust)."""

    pow_bits: int = 5
    fri_config: FriConfig = field(
        default_factory=lambda: FriConfig(0, 1, 3))

    def security_bits(self) -> int:
        return self.pow_bits + self.fri_config.security_bits()

    def mix_into(self, channel) -> None:
        channel.mix_u64(self.pow_bits)
        self.fri_config.mix_into(channel)


from .prover import (CommitmentSchemeProof, CommitmentSchemeProver,  # noqa: E402,F401
                     CommitmentTreeProver, TreeBuilder)
from .verifier import CommitmentSchemeVerifier  # noqa: E402,F401
