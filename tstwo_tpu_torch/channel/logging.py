"""Transcript-tracing channel wrapper (reference channel/logging_channel.ts:47).

Records every mix/draw interaction -- the framework's Fiat-Shamir trace hook.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List, Sequence


@dataclass
class LoggingChannel:
    inner: Any
    log: List[dict] = field(default_factory=list)

    @property
    def BYTES_PER_HASH(self) -> int:
        return self.inner.BYTES_PER_HASH

    @property
    def digest(self):
        return self.inner.digest

    def _rec(self, op: str, **kw) -> None:
        self.log.append({"op": op, **kw})

    def mix_root(self, root) -> None:
        self._rec("mix_root", root=root.hex() if isinstance(root, bytes) else root)
        self.inner.mix_root(root)

    def mix_u32s(self, data: Sequence[int]) -> None:
        self._rec("mix_u32s", data=list(data))
        self.inner.mix_u32s(data)

    def mix_u64(self, value: int) -> None:
        self._rec("mix_u64", value=int(value))
        self.inner.mix_u64(value)

    def mix_felts(self, felts) -> None:
        self._rec("mix_felts", felts=[f.to_ints() for f in felts])
        self.inner.mix_felts(felts)

    def draw_felt(self):
        out = self.inner.draw_felt()
        self._rec("draw_felt", out=out.to_ints())
        return out

    def draw_felts(self, n: int):
        out = self.inner.draw_felts(n)
        self._rec("draw_felts", n=n, out=[f.to_ints() for f in out])
        return out

    def draw_random_bytes(self) -> bytes:
        out = self.inner.draw_random_bytes()
        self._rec("draw_random_bytes", out=out.hex())
        return out

    def trailing_zeros(self) -> int:
        return self.inner.trailing_zeros()

    def clone(self):
        return LoggingChannel(self.inner.clone(), list(self.log))


@dataclass
class LoggingMerkleChannel:
    """MerkleChannel wrapper that logs root-mixing operations
    (reference channel/logging_channel.ts:162).  Wraps any MerkleChannel
    flavor (Blake2sMerkleChannel / Poseidon252MerkleChannel); mix_root
    events land in the shared `log` list alongside LoggingChannel's."""

    inner: Any
    log: List[dict] = field(default_factory=list)

    def mix_root(self, channel, root) -> None:
        self.log.append({"op": "merkle_mix_root",
                         "root": root.hex() if isinstance(root, bytes)
                         else str(root)})
        self.inner.mix_root(channel, root)
