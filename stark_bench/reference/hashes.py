"""Blake2s (vectorised over many messages), Poseidon252, and the two
Fiat-Shamir channels.

Blake2s is RFC 7693 with a 32-byte digest and no key; the vectorised form
hashes N messages of one length at once, as int64 tensors of 32-bit words,
and is held against `hashlib.blake2s` by the tests.  Poseidon252 is the
Starknet Hades permutation (round constants sha256("Hades<i>") mod p, MDS
[[3,1,1],[1,-1,1],[1,1,-2]], 8 full and 83 partial rounds, x^3) over
Python ints.  The channels follow stwo's Blake2sChannel and
Poseidon252Channel.
"""
from __future__ import annotations

import hashlib
from typing import List, Sequence

import torch

from .algebra import P, QM31

MASK = 0xFFFFFFFF
IV = (0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
      0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19)
SIGMA = (
    (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15),
    (14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3),
    (11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4),
    (7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8),
    (9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13),
    (2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9),
    (12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11),
    (13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10),
    (6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5),
    (10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0),
)


def _rotr(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x >> r) | (x << (32 - r))) & MASK


def compress(h: List[torch.Tensor], m: List[torch.Tensor], t: int,
             last: bool) -> List[torch.Tensor]:
    """One Blake2s compression of N states (8 word tensors) with N blocks
    (16 word tensors); t is the byte count so far, last marks the final
    block."""
    v = list(h) + [torch.full_like(h[0], w) for w in IV]
    v[12] = v[12] ^ (t & MASK)
    v[13] = v[13] ^ (t >> 32)
    if last:
        v[14] = v[14] ^ MASK

    def g(a, b, c, d, x, y):
        v[a] = (v[a] + v[b] + x) & MASK
        v[d] = _rotr(v[d] ^ v[a], 16)
        v[c] = (v[c] + v[d]) & MASK
        v[b] = _rotr(v[b] ^ v[c], 12)
        v[a] = (v[a] + v[b] + y) & MASK
        v[d] = _rotr(v[d] ^ v[a], 8)
        v[c] = (v[c] + v[d]) & MASK
        v[b] = _rotr(v[b] ^ v[c], 7)

    for s in SIGMA:
        g(0, 4, 8, 12, m[s[0]], m[s[1]])
        g(1, 5, 9, 13, m[s[2]], m[s[3]])
        g(2, 6, 10, 14, m[s[4]], m[s[5]])
        g(3, 7, 11, 15, m[s[6]], m[s[7]])
        g(0, 5, 10, 15, m[s[8]], m[s[9]])
        g(1, 6, 11, 12, m[s[10]], m[s[11]])
        g(2, 7, 8, 13, m[s[12]], m[s[13]])
        g(3, 4, 9, 14, m[s[14]], m[s[15]])
    return [h[i] ^ v[i] ^ v[i + 8] for i in range(8)]


def n_blocks(n_bytes: int) -> int:
    return max(1, -(-n_bytes // 64))


def blake2s_words(words: Sequence[torch.Tensor], n: int,
                  device) -> torch.Tensor:
    """Blake2s of N messages of 4 * len(words) bytes each, word i of every
    message in words[i] (an int64 tensor [N] of LE 32-bit words, or an
    int).  Returns the digests as int64 [8, N] LE words."""
    n_bytes = 4 * len(words)
    blocks = n_blocks(n_bytes)
    zero = torch.zeros(n, dtype=torch.int64, device=device)
    padded = [w if torch.is_tensor(w) else torch.full_like(zero, w)
              for w in words] + [zero] * (16 * blocks - len(words))
    h = [torch.full_like(zero, w) for w in IV]
    h[0] = h[0] ^ 0x01010020  # digest length 32, no key, fanout and depth 1
    for b in range(blocks):
        last = b == blocks - 1
        t = n_bytes if last else 64 * (b + 1)
        h = compress(h, padded[16 * b: 16 * b + 16], t, last)
    return torch.stack(h)


def words_to_bytes(words: Sequence[int]) -> bytes:
    return b"".join(int(w).to_bytes(4, "little") for w in words)


def bytes_to_words(data: bytes) -> List[int]:
    return [int.from_bytes(data[i: i + 4], "little")
            for i in range(0, len(data), 4)]


def _blake2s(data: bytes) -> bytes:
    return hashlib.blake2s(data, digest_size=32).digest()


def trailing_zeros_u128(data16: bytes) -> int:
    val = int.from_bytes(data16, "little")
    if val == 0:
        return 128
    return (val & -val).bit_length() - 1


class Blake2sChannel:
    """digest' = blake2s(digest || message) on a mix; a draw hashes
    digest || LE64(n_sent) || 24 zero bytes."""

    BYTES_PER_HASH = 32

    def __init__(self):
        self.digest = bytes(32)
        self.n_sent = 0

    def _mix(self, data: bytes) -> None:
        self.digest = _blake2s(self.digest + data)
        self.n_sent = 0

    def mix_root(self, root_hex: str) -> None:
        self._mix(bytes.fromhex(root_hex))

    def mix_u64(self, value: int) -> None:
        self._mix(words_to_bytes([value & MASK, (value >> 32) & MASK]))

    def mix_felts(self, felts: Sequence[QM31]) -> None:
        self._mix(b"".join(words_to_bytes(f) for f in felts))

    def draw_random_bytes(self) -> bytes:
        counter = self.n_sent.to_bytes(8, "little") + bytes(24)
        self.n_sent += 1
        return _blake2s(self.digest + counter)

    def draw_felt(self) -> QM31:
        """Eight words a hash, the whole hash drawn again while any word is
        2P or more; the first four words reduced mod P."""
        while True:
            words = bytes_to_words(self.draw_random_bytes())
            if all(w < 2 * P for w in words):
                return tuple(w % P for w in words[:4])

    def trailing_zeros(self) -> int:
        return trailing_zeros_u128(self.digest[:16])


def blake2s_grind(channel: Blake2sChannel, pow_bits: int, device,
                  batch: int) -> int:
    """The least nonce whose mix_u64 digest has pow_bits trailing zeros."""
    prefix = bytes_to_words(channel.digest)
    start = 0
    while True:
        nonces = torch.arange(start, start + batch, dtype=torch.int64,
                              device=device)
        h = blake2s_words(prefix + [nonces & MASK, nonces >> 32], batch,
                          device)
        ok = torch.ones(batch, dtype=torch.bool, device=device)
        for k in range(4):  # the low pow_bits bits of the first 16 bytes
            bits = min(32, max(0, pow_bits - 32 * k))
            if bits:
                ok &= (h[k] & ((1 << bits) - 1)) == 0
        hits = torch.nonzero(ok)
        if hits.numel():
            return start + int(hits[0, 0])
        start += batch


# -- Poseidon252 -------------------------------------------------------------

P252 = (1 << 251) + 17 * (1 << 192) + 1
_FULL_ROUNDS, _PARTIAL_ROUNDS = 8, 83
_ROUND_CONSTANTS = [
    [int(hashlib.sha256(f"Hades{3 * i + j}".encode()).hexdigest(), 16) % P252
     for j in range(3)]
    for i in range(_FULL_ROUNDS + _PARTIAL_ROUNDS)]


def hades(state: Sequence[int]) -> List[int]:
    s = list(state)
    half = _FULL_ROUNDS // 2
    for r, consts in enumerate(_ROUND_CONSTANTS):
        s = [(v + c) % P252 for v, c in zip(s, consts)]
        if r < half or r >= half + _PARTIAL_ROUNDS:
            s = [pow(v, 3, P252) for v in s]
        else:
            s[2] = pow(s[2], 3, P252)
        total = s[0] + s[1] + s[2]
        s = [(total + 2 * s[0]) % P252, (total - 2 * s[1]) % P252,
             (total - 3 * s[2]) % P252]
    return s


def poseidon_hash(x: int, y: int) -> int:
    return hades([x, y, 2])[0]


def poseidon_hash_many(values: Sequence[int]) -> int:
    """Sponge of rate 2 padded with 1 then 0 to even length."""
    vals = list(values) + [1]
    if len(vals) % 2:
        vals.append(0)
    s = [0, 0, 0]
    for i in range(0, len(vals), 2):
        s = hades([(s[0] + vals[i]) % P252, (s[1] + vals[i + 1]) % P252, s[2]])
    return s[0]


class Poseidon252Channel:
    BYTES_PER_HASH = 31

    def __init__(self):
        self.digest = 0
        self.n_sent = 0

    def _set(self, digest: int) -> None:
        self.digest = digest
        self.n_sent = 0

    def mix_root(self, root: int) -> None:
        self._set(poseidon_hash_many([self.digest, root]))

    def mix_u64(self, value: int) -> None:
        # as mix of the u32s [0, 0, 0, 0, 0, hi, lo]: one felt of 7 words
        acc = 0
        for w in (0, 0, 0, 0, 0, (value >> 32) & MASK, value & MASK):
            acc = (acc << 32) + w
        self._set(poseidon_hash_many([self.digest, acc % P252]))

    def mix_felts(self, felts: Sequence[QM31]) -> None:
        packed = [self.digest]
        for i in range(0, len(felts), 2):
            acc = 0
            for f in felts[i: i + 2]:
                for limb in f:
                    acc = (acc * (1 << 31) + limb) % P252
            packed.append(acc)
        self._set(poseidon_hash_many(packed))

    def _draw_felt252(self) -> int:
        out = poseidon_hash(self.digest, self.n_sent)
        self.n_sent += 1
        return out

    def draw_felt(self) -> QM31:
        cur = self._draw_felt252()
        limbs = []
        for _ in range(4):
            cur, low = divmod(cur, 1 << 31)
            limbs.append(low % P)
        return tuple(limbs)

    def draw_random_bytes(self) -> bytes:
        return self._draw_felt252().to_bytes(32, "little")[:31]

    def trailing_zeros(self) -> int:
        return trailing_zeros_u128(self.digest.to_bytes(32, "big")[:16])


def poseidon_grind(channel: Poseidon252Channel, pow_bits: int) -> int:
    nonce = 0
    while True:
        probe = Poseidon252Channel()
        probe.digest = channel.digest
        probe.mix_u64(nonce)
        if probe.trailing_zeros() >= pow_bits:
            return nonce
        nonce += 1
