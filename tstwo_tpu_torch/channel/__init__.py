"""Fiat-Shamir channels (host-side, bit-exact with Rust stwo).

The transcript is a tiny sequential hash chain; it stays on host while bulk
column work runs on device.  All hosts in a multi-host run compute identical
transcripts deterministically, so channel state never needs communication
(reference channel/index.ts:119-137).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Protocol, Sequence

from ..fields import M31, QM31


@dataclass
class ChannelTime:
    """(n_challenges, n_sent) counters (reference channel/index.ts:20-109)."""

    n_challenges: int = 0
    n_sent: int = 0

    def inc_sent(self) -> None:
        self.n_sent += 1

    def inc_challenges(self) -> None:
        self.n_challenges += 1
        self.n_sent = 0


class Channel(Protocol):
    BYTES_PER_HASH: int

    def trailing_zeros(self) -> int: ...

    def mix_u32s(self, data: Sequence[int]) -> None: ...

    def mix_u64(self, value: int) -> None: ...

    def mix_felts(self, felts: Sequence[QM31]) -> None: ...

    def draw_felt(self) -> QM31: ...

    def draw_felts(self, n: int) -> List[QM31]: ...

    def draw_random_bytes(self) -> bytes: ...


from .blake2s import Blake2sChannel  # noqa: E402,F401
