"""Poseidon252 channel over the Starknet prime field (host side).

Implements the Starknet Poseidon (Hades) permutation from the public
parameter generation procedure (round constants = sha256("Hades{i}") mod p,
MDS [[3,1,1],[1,-1,1],[1,1,-2]], m=3, 8 full + 83 partial rounds, x^3
S-box), plus poseidon_hash / poseidon_hash_many sponge and the Fiat-Shamir
channel semantics of Rust stwo's Poseidon252Channel (embedded in reference
channel/poseidon.ts:376-500).  Validated against hash values from stwo's
test suite (see tests/test_poseidon.py).  Each host permutation adds 1 to
the span tree's counter `host_hades`.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import List, Sequence

from ..fields import M31, QM31, SECURE_EXTENSION_DEGREE
from ..tracing import count
from . import ChannelTime

P252 = (1 << 251) + 17 * (1 << 192) + 1
BYTES_PER_FELT252 = 31
FELTS_PER_HASH = 8
_SHIFT_31 = 1 << 31
_SHIFT_32 = 1 << 32

_M = 3
_R_F = 8
_R_P = 83
_N_ROUNDS = _R_F + _R_P

# MDS matrix [[3,1,1],[1,-1,1],[1,1,-2]] (cairo-lang poseidon small_params)
_MDS = ((3, 1, 1), (1, P252 - 1, 1), (1, 1, P252 - 2))


def _generate_round_constants() -> List[List[int]]:
    ark = []
    for i in range(_N_ROUNDS):
        row = []
        for j in range(_M):
            val = int(hashlib.sha256(
                f"Hades{3 * i + j}".encode("utf8")).hexdigest(), 16)
            row.append(val % P252)
        ark.append(row)
    return ark


_ARK = _generate_round_constants()


def hades_permutation(state: Sequence[int]) -> List[int]:
    count("host_hades", 1)
    s = list(state)
    round_idx = 0
    for _ in range(_R_F // 2):
        s = _round(s, True, round_idx)
        round_idx += 1
    for _ in range(_R_P):
        s = _round(s, False, round_idx)
        round_idx += 1
    for _ in range(_R_F // 2):
        s = _round(s, True, round_idx)
        round_idx += 1
    return s


def _round(s: List[int], full: bool, round_idx: int) -> List[int]:
    s = [(v + a) % P252 for v, a in zip(s, _ARK[round_idx])]
    if full:
        s = [pow(v, 3, P252) for v in s]
    else:
        s[-1] = pow(s[-1], 3, P252)
    return [sum(m * v for m, v in zip(row, s)) % P252 for row in _MDS]


def poseidon_hash(x: int, y: int) -> int:
    """2-to-1 hash: hades([x, y, 2])[0] (starknet-crypto poseidon_hash)."""
    return hades_permutation([x, y, 2])[0]


def poseidon_hash_many(values: Sequence[int]) -> int:
    """Sponge with rate 2, padding [1, 0...] (starknet-crypto
    poseidon_hash_many)."""
    vals = list(values) + [1]
    if len(vals) % 2:
        vals.append(0)
    state = [0, 0, 0]
    for i in range(0, len(vals), 2):
        state = hades_permutation(
            [(state[0] + vals[i]) % P252, (state[1] + vals[i + 1]) % P252,
             state[2]])
    return state[0]


@dataclass(frozen=True)
class FieldElement252:
    """Element of the 252-bit Starknet field (reference channel/poseidon.ts:28)."""

    value: int

    @staticmethod
    def from_int(v: int) -> "FieldElement252":
        return FieldElement252(v % P252)

    @staticmethod
    def zero() -> "FieldElement252":
        return FieldElement252(0)

    def __add__(self, o):
        return FieldElement252((self.value + o.value) % P252)

    def __sub__(self, o):
        return FieldElement252((self.value - o.value) % P252)

    def __mul__(self, o):
        return FieldElement252((self.value * o.value) % P252)

    def floor_div(self, o):
        return FieldElement252(self.value // o.value)

    def to_bytes_be(self) -> bytes:
        return self.value.to_bytes(32, "big")

    def try_into_u32(self):
        return self.value if self.value < (1 << 32) else None


@dataclass
class Poseidon252Channel:
    """Felt252-digest channel (Rust stwo poseidon252.rs semantics)."""

    digest: FieldElement252 = field(default_factory=FieldElement252.zero)
    channel_time: ChannelTime = field(default_factory=ChannelTime)

    BYTES_PER_HASH = BYTES_PER_FELT252

    def clone(self) -> "Poseidon252Channel":
        return Poseidon252Channel(
            self.digest,
            ChannelTime(self.channel_time.n_challenges, self.channel_time.n_sent))

    def _update_digest(self, new_digest: FieldElement252) -> None:
        self.digest = new_digest
        self.channel_time.inc_challenges()

    def mix_root(self, root: FieldElement252) -> None:
        self._update_digest(FieldElement252(
            poseidon_hash_many([self.digest.value, root.value])))

    def _draw_felt252(self) -> int:
        res = poseidon_hash(self.digest.value, self.channel_time.n_sent)
        self.channel_time.inc_sent()
        return res

    def _draw_base_felts(self) -> List[M31]:
        cur = self._draw_felt252()
        out = []
        for _ in range(8):
            cur, res = divmod(cur, _SHIFT_31)
            out.append(M31.reduce(res))
        return out

    def trailing_zeros(self) -> int:
        data = self.digest.to_bytes_be()[:16]
        val = int.from_bytes(data, "little")
        if val == 0:
            return 128
        return (val & -val).bit_length() - 1

    def mix_felts(self, felts: Sequence[QM31]) -> None:
        res = [self.digest.value]
        for i in range(0, len(felts), 2):
            chunk = felts[i: i + 2]
            acc = 0
            for f in chunk:
                for m in f.to_m31_array():
                    acc = (acc * _SHIFT_31 + m.value) % P252
            res.append(acc)
        self._update_digest(FieldElement252(poseidon_hash_many(res)))

    def mix_u32s(self, data: Sequence[int]) -> None:
        padding_len = 6 - ((len(data) + 6) % 7)
        padded = list(data) + [0] * padding_len
        felts = []
        for i in range(0, len(padded), 7):
            acc = 0
            for v in padded[i: i + 7]:
                acc = (acc * _SHIFT_32 + (v & 0xFFFFFFFF)) % P252
            felts.append(acc)
        self._update_digest(FieldElement252(
            poseidon_hash_many([self.digest.value] + felts)))

    def mix_u64(self, value: int) -> None:
        self.mix_u32s([0, 0, 0, 0, 0,
                       (value >> 32) & 0xFFFFFFFF, value & 0xFFFFFFFF])

    def draw_felt(self) -> QM31:
        felts = self._draw_base_felts()
        return QM31.from_m31_array(felts[:SECURE_EXTENSION_DEGREE])

    def draw_felts(self, n_felts: int) -> List[QM31]:
        out: List[QM31] = []
        buf: List[M31] = []
        while len(out) < n_felts:
            if len(buf) < SECURE_EXTENSION_DEGREE:
                buf.extend(self._draw_base_felts())
            out.append(QM31.from_m31_array(buf[:4]))
            buf = buf[4:]
        return out

    def draw_random_bytes(self) -> bytes:
        cur = self._draw_felt252()
        out = bytearray(31)
        for i in range(31):
            cur, res = divmod(cur, 256)
            out[i] = res
        return bytes(out)
