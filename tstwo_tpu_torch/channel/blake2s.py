"""Blake2s-digest Fiat-Shamir channel.

Bit-exact with Rust stwo's Blake2sChannel (the reference TS port at
channel/blake2.ts:25-224 deviates from Rust by queueing leftover base felts
across draw_felt calls; Rust discards them, and Rust is ground truth here).
"""
from __future__ import annotations

import hashlib
from typing import List, Sequence

import numpy as np

from ..fields import M31, P, QM31, SECURE_EXTENSION_DEGREE
from . import ChannelTime

BLAKE_BYTES_PER_HASH = 32
FELTS_PER_HASH = 8
_2P = 2 * P


def _blake2s(data: bytes) -> bytes:
    return hashlib.blake2s(data, digest_size=32).digest()


class Blake2sChannel:
    """Digest-chained channel; draw = blake2s(digest || pad32(LE(n_sent)))
    (reference channel/blake2.ts:211-224).

    The digest may live on the device for a while (`mix_root_device`): a
    Merkle root there is mixed by the transcript kernel with no host round
    trip, and the host bytes are fetched at the next host-side read of
    `digest` (a mix, a draw, a clone).  Bit-exact either way."""

    BYTES_PER_HASH = BLAKE_BYTES_PER_HASH

    def __init__(self, digest: bytes = b"\x00" * 32,
                 channel_time: ChannelTime = None):
        self._digest = digest
        self._device_digest = None  # pending int32 [8] device words, or None
        self.channel_time = channel_time or ChannelTime()

    @property
    def digest(self) -> bytes:
        if self._device_digest is not None:
            from ..ops.blake2s import digest_words_to_bytes
            from ..utils import to_numpy_u32

            self._digest = digest_words_to_bytes(
                to_numpy_u32(self._device_digest))
            self._device_digest = None
        return self._digest

    @digest.setter
    def digest(self, value: bytes) -> None:
        self._digest = value
        self._device_digest = None

    def digest_words_device(self, device=None):
        """The digest as int32 [8] LE words on `device`: no fetch if it is
        already on the device, else one asynchronous upload.  Without
        `device`, the device digest where it lies (the same tensor), or,
        when there is none, an upload to CUDA device 0
        (`utils.entry_device`)."""
        if self._device_digest is not None:
            if device is None:
                return self._device_digest
            return self._device_digest.to(device)
        from .device import upload_words

        return upload_words(np.frombuffer(self._digest, dtype="<u4"), device)

    def clone(self) -> "Blake2sChannel":
        return Blake2sChannel(
            self.digest,
            ChannelTime(self.channel_time.n_challenges, self.channel_time.n_sent),
        )

    def __eq__(self, other):
        return (isinstance(other, Blake2sChannel)
                and self.digest == other.digest
                and self.channel_time == other.channel_time)

    def __repr__(self):
        return (f"Blake2sChannel(digest={self.digest!r}, "
                f"channel_time={self.channel_time!r})")

    def _update_digest(self, new_digest: bytes) -> None:
        self.digest = new_digest
        self.channel_time.inc_challenges()

    # -- mixing -------------------------------------------------------------
    def mix_root(self, root: bytes) -> None:
        """MerkleChannel::mix_root (reference vcs/blake2_merkle.ts:28-32)."""
        self._update_digest(_blake2s(self.digest + root))

    def mix_root_device(self, root_words) -> None:
        """Mix a device-resident Merkle root (int32 [8] LE words) with no
        host round trip: digest' = blake2s(digest || root) is one launch of
        the transcript kernel on the root's device (the plain version on
        the CPU); the host bytes are fetched at the next read."""
        from . import device as dev

        self._device_digest, _ = dev.mix_root(
            self.digest_words_device(root_words.device), root_words)
        self.channel_time.inc_challenges()

    def mix_u32s(self, data: Sequence[int]) -> None:
        payload = b"".join((x & 0xFFFFFFFF).to_bytes(4, "little") for x in data)
        self._update_digest(_blake2s(self.digest + payload))

    def mix_u64(self, value: int) -> None:
        self.mix_u32s([value & 0xFFFFFFFF, (value >> 32) & 0xFFFFFFFF])

    def mix_felts(self, felts: Sequence[QM31]) -> None:
        self._update_digest(_blake2s(self.digest + QM31.into_slice(felts)))

    # -- drawing ------------------------------------------------------------
    def draw_random_bytes(self) -> bytes:
        counter = self.channel_time.n_sent.to_bytes(8, "little") + b"\x00" * 24
        self.channel_time.inc_sent()
        return _blake2s(self.digest + counter)

    def _draw_base_felts(self) -> List[M31]:
        """8 uniform M31 per hash, rejection-sampled at < 2P
        (reference channel/blake2.ts:159-175)."""
        while True:
            data = self.draw_random_bytes()
            u32s = [int.from_bytes(data[4 * i: 4 * i + 4], "little")
                    for i in range(FELTS_PER_HASH)]
            if all(x < _2P for x in u32s):
                return [M31.reduce(x) for x in u32s]

    def draw_felt(self) -> QM31:
        felts = self._draw_base_felts()
        return QM31.from_m31_array(felts[:SECURE_EXTENSION_DEGREE])

    def draw_felts(self, n_felts: int) -> List[QM31]:
        out: List[QM31] = []
        queue: List[M31] = []
        while len(out) < n_felts:
            if len(queue) < SECURE_EXTENSION_DEGREE:
                queue.extend(self._draw_base_felts())
            out.append(QM31.from_m31_array(queue[:4]))
            queue = queue[4:]
        return out

    def trailing_zeros(self) -> int:
        """Trailing zeros of the first 16 digest bytes as a LE u128
        (reference channel/blake2.ts:95-113)."""
        val = int.from_bytes(self.digest[:16], "little")
        if val == 0:
            return 128
        return (val & -val).bit_length() - 1
