"""Batched Blake2s-256 of N equal-length messages, word-major.

Messages are given as u32 words with the batch on the minor axis:
words[w, i] is word w of message i (int32 bit-views of u32 values), and
digests come back the same way as [8, N].  A CUDA tensor goes through the
hand-written kernel csrc/blake2s.cu; a CPU tensor through
`hash_words_major_plain`, which computes in int64 and masks to 32 bits
after every add and shift (torch's >> on a negative int32 is arithmetic).

Semantics: standard unkeyed blake2s-256, bit-exact with hashlib.blake2s.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .. import kernels

IV = np.array([
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
], dtype=np.uint32)

SIGMA = [
    [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15],
    [14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3],
    [11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4],
    [7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8],
    [9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13],
    [2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9],
    [12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11],
    [13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10],
    [6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5],
    [10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0],
]

# h0 ^= param block (digest_length=32, fanout=1, depth=1)
H0 = IV.copy()
H0[0] ^= 0x01010020

_MASK = 0xFFFFFFFF


def _rotr(x, r):
    return ((x >> r) | (x << (32 - r))) & _MASK


def _g(v, a, b, c, d, x, y):
    v[a] = (v[a] + v[b] + x) & _MASK
    v[d] = _rotr(v[d] ^ v[a], 16)
    v[c] = (v[c] + v[d]) & _MASK
    v[b] = _rotr(v[b] ^ v[c], 12)
    v[a] = (v[a] + v[b] + y) & _MASK
    v[d] = _rotr(v[d] ^ v[a], 8)
    v[c] = (v[c] + v[d]) & _MASK
    v[b] = _rotr(v[b] ^ v[c], 7)


def _compress_rows(h, m, t: int, is_final: bool):
    """One block compress on word-major int64 state in [0, 2^32): h is 8
    row tensors, m 16; returns the 8 output rows."""
    v = list(h) + [torch.full_like(h[0], int(w)) for w in IV]
    v[12] = v[12] ^ (t & _MASK)
    v[13] = v[13] ^ ((t >> 32) & _MASK)
    if is_final:
        v[14] = v[14] ^ _MASK
    for s in SIGMA:
        _g(v, 0, 4, 8, 12, m[s[0]], m[s[1]])
        _g(v, 1, 5, 9, 13, m[s[2]], m[s[3]])
        _g(v, 2, 6, 10, 14, m[s[4]], m[s[5]])
        _g(v, 3, 7, 11, 15, m[s[6]], m[s[7]])
        _g(v, 0, 5, 10, 15, m[s[8]], m[s[9]])
        _g(v, 1, 6, 11, 12, m[s[10]], m[s[11]])
        _g(v, 2, 7, 8, 13, m[s[12]], m[s[13]])
        _g(v, 3, 4, 9, 14, m[s[14]], m[s[15]])
    return [h[i] ^ v[i] ^ v[i + 8] for i in range(8)]


def _as_int32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 with the same low 32 bits."""
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def hash_words_major_plain(words: torch.Tensor, byte_len: int) -> torch.Tensor:
    """Plain PyTorch version on any device; words is [16 * n_blocks, N]."""
    total, n = words.shape
    n_blocks = total // 16
    wd = words.to(torch.int64) & _MASK
    h = [torch.full((n,), int(w), dtype=torch.int64, device=words.device)
         for w in H0]
    for b in range(n_blocks):
        final = b == n_blocks - 1
        t = byte_len if final else (b + 1) * 64
        h = _compress_rows(h, [wd[16 * b + i] for i in range(16)], t, final)
    return _as_int32_bits(torch.stack(h))


def hash_words_major_cuda(words: torch.Tensor, byte_len: int) -> torch.Tensor:
    """Launch csrc/blake2s.cu on contiguous CUDA int32 words [16 * n_blocks, N]."""
    kernels.check_cuda_tensor(words, "words")
    total, n = words.shape
    if total == 0 or total % 16:
        raise ValueError("words must hold whole 16-word blocks")
    out = torch.empty((8, n), dtype=torch.int32, device=words.device)
    if n:
        kernels.launch("blake2s", "blake2s", words.device, words.data_ptr(),
                       out.data_ptr(), total // 16, n, byte_len)
    return out


def hash_words_major(words: torch.Tensor, byte_len: int) -> torch.Tensor:
    """blake2s-256 of N messages given word-major as [W, N] LE words.

    W*4 >= byte_len (extra words must be zero).  Returns int32 [8, N]
    digest words."""
    w, n = words.shape
    n_blocks = max(1, -(-byte_len // 64))
    total = n_blocks * 16
    if w < total:
        words = F.pad(words, (0, 0, 0, total - w))
    words = words[:total]
    if kernels.on_cuda(words):
        return hash_words_major_cuda(words.contiguous(), byte_len)
    return hash_words_major_plain(words, byte_len)


def digest_words_to_bytes(words) -> bytes:
    """8 u32 words (numpy or int32 bit-views) -> 32-byte digest."""
    return b"".join((int(w) & _MASK).to_bytes(4, "little") for w in words)


def digest_bytes_to_words(digest: bytes) -> np.ndarray:
    return np.frombuffer(digest, dtype="<u4").copy()
