"""BLAKE3-256 (pure Python host implementation).

Alternative Merkle hasher in the reference inventory (vcs/blake3_hash.ts,
via @noble/hashes).  Full chunk/parent tree; validated against the exact
digests in the reference test suite.
"""
from __future__ import annotations

from typing import List

IV = [0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
      0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19]

_MSG_PERM = [2, 6, 3, 10, 7, 0, 4, 13, 1, 11, 12, 5, 9, 14, 15, 8]

CHUNK_START = 1
CHUNK_END = 2
PARENT = 4
ROOT = 8

_M32 = 0xFFFFFFFF


def _rotr(x, r):
    return ((x >> r) | (x << (32 - r))) & _M32


def _g(v, a, b, c, d, x, y):
    v[a] = (v[a] + v[b] + x) & _M32
    v[d] = _rotr(v[d] ^ v[a], 16)
    v[c] = (v[c] + v[d]) & _M32
    v[b] = _rotr(v[b] ^ v[c], 12)
    v[a] = (v[a] + v[b] + y) & _M32
    v[d] = _rotr(v[d] ^ v[a], 8)
    v[c] = (v[c] + v[d]) & _M32
    v[b] = _rotr(v[b] ^ v[c], 7)


def _compress(cv: List[int], block: List[int], counter: int, block_len: int,
              flags: int) -> List[int]:
    v = list(cv) + list(IV[:4]) + [
        counter & _M32, (counter >> 32) & _M32, block_len, flags]
    m = list(block)
    for r in range(7):
        _g(v, 0, 4, 8, 12, m[0], m[1])
        _g(v, 1, 5, 9, 13, m[2], m[3])
        _g(v, 2, 6, 10, 14, m[4], m[5])
        _g(v, 3, 7, 11, 15, m[6], m[7])
        _g(v, 0, 5, 10, 15, m[8], m[9])
        _g(v, 1, 6, 11, 12, m[10], m[11])
        _g(v, 2, 7, 8, 13, m[12], m[13])
        _g(v, 3, 4, 9, 14, m[14], m[15])
        if r < 6:
            m = [m[p] for p in _MSG_PERM]
    return [(v[i] ^ v[i + 8]) & _M32 for i in range(8)] + \
        [(v[i + 8] ^ cv[i]) & _M32 for i in range(8)]


def _words(data: bytes) -> List[int]:
    padded = data + b"\x00" * (64 - len(data))
    return [int.from_bytes(padded[4 * i: 4 * i + 4], "little")
            for i in range(16)]


def _chunk_output(chunk: bytes, counter: int):
    """Returns (cv, last_block_words, last_block_len, flags_for_last)."""
    cv = list(IV)
    blocks = [chunk[i: i + 64] for i in range(0, max(len(chunk), 1), 64)]
    for i, blk in enumerate(blocks[:-1]):
        flags = CHUNK_START if i == 0 else 0
        cv = _compress(cv, _words(blk), counter, 64, flags)[:8]
    last = blocks[-1]
    flags = CHUNK_END | (CHUNK_START if len(blocks) == 1 else 0)
    return cv, _words(last), len(last), flags, counter


def blake3(data: bytes) -> bytes:
    """BLAKE3-256 hash."""
    chunks = [data[i: i + 1024] for i in range(0, max(len(data), 1), 1024)]
    if len(chunks) == 1:
        cv, block, block_len, flags, counter = _chunk_output(chunks[0], 0)
        out = _compress(cv, block, counter, block_len, flags | ROOT)
        return b"".join(w.to_bytes(4, "little") for w in out[:8])
    # build chunk chaining values
    cvs = []
    for i, c in enumerate(chunks):
        cv, block, block_len, flags, counter = _chunk_output(c, i)
        cvs.append(_compress(cv, block, counter, block_len, flags)[:8])

    # BLAKE3 tree rule: the left subtree holds the largest power-of-two
    # number of chunks strictly less than the total.
    def subtree(cvs_slice):
        if len(cvs_slice) == 1:
            return cvs_slice[0]
        split = 1 << (len(cvs_slice) - 1).bit_length() - 1
        left = subtree(cvs_slice[:split])
        right = subtree(cvs_slice[split:])
        return _compress(list(IV), left + right, 0, 64, PARENT)[:8]

    split = 1 << (len(cvs) - 1).bit_length() - 1
    left = subtree(cvs[:split])
    right = subtree(cvs[split:])
    out = _compress(list(IV), left + right, 0, 64, PARENT | ROOT)
    return b"".join(w.to_bytes(4, "little") for w in out[:8])


def concat_and_hash(a: bytes, b: bytes) -> bytes:
    return blake3(a + b)
