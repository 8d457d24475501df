"""Batched Blake2s-256 of N equal-length messages, word-major.

Messages are given as u32 words with the batch on the minor axis:
words[w, i] is word w of message i (int32 bit-views of u32 values), and
digests come back the same way as [8, N].  A CUDA tensor goes through the
hand-written kernels of csrc/blake2s.cu; a CPU tensor through the plain
versions, which compute in int64 and mask to 32 bits after every add and
shift (torch's >> on a negative int32 is arithmetic).

Five entry points, each with its `_cuda` and `_plain` version:
`hash_words_major` (N messages from their words), `merkle_layer` (a Merkle
layer from the child layer's pairs and the columns that join there, read
where they lie: no deinterleave, concatenation or padding on the device),
`merkle_tail` (every small layer of a tree down to the root in one
launch), `grind_batch` (the least proof-of-work nonce of a range) and
`transcript` (a Fiat-Shamir step on a device-resident channel state: a
mix, then draws; channel/device.py).

Semantics: standard unkeyed blake2s-256, bit-exact with hashlib.blake2s.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from .. import kernels
from ..utils import as_int32_bits, entry_device, to_host_list, upload

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


def hash_words_major_plain(words: torch.Tensor, byte_len: int) -> torch.Tensor:
    """Plain PyTorch version on any device; words is [W, N] with W at most
    16 * n_blocks, the words past W zero."""
    w, n = words.shape
    n_blocks = _n_blocks(byte_len)
    if w > 16 * n_blocks:
        raise ValueError("more words than the blocks of byte_len hold")
    wd = words.to(torch.int64) & _MASK
    zero = torch.zeros((n,), dtype=torch.int64, device=words.device)
    h = [torch.full((n,), int(iv), dtype=torch.int64, device=words.device)
         for iv in H0]
    for b in range(n_blocks):
        final = b == n_blocks - 1
        t = byte_len if final else (b + 1) * 64
        m = [wd[16 * b + i] if 16 * b + i < w else zero for i in range(16)]
        h = _compress_rows(h, m, t, final)
    return as_int32_bits(torch.stack(h))


def compress(h: torch.Tensor, m: torch.Tensor, t: int,
             is_final: bool) -> torch.Tensor:
    """One Blake2s block compress, batched over leading axes, in plain
    PyTorch: h int32 [..., 8] chaining words, m int32 [..., 16] message
    words (bit-views of u32), t the byte counter.  Returns int32 [..., 8]."""
    hw = h.to(torch.int64) & _MASK
    mw = m.to(torch.int64) & _MASK
    out = _compress_rows([hw[..., i] for i in range(8)],
                         [mw[..., i] for i in range(16)], t, is_final)
    return as_int32_bits(torch.stack(out, dim=-1))


def hash_u32_batch(words: torch.Tensor, byte_len: int) -> torch.Tensor:
    """blake2s-256 of N messages of one length, given message-major as
    int32 [N, n_words] LE words (n_words * 4 >= byte_len; the words past
    byte_len are zero).  Returns int32 [N, 8] digest words.  The batch is
    `hash_words_major` of the transpose: the hand kernel on a CUDA tensor."""
    return hash_words_major(words.t().contiguous(), byte_len).t().contiguous()


def _n_blocks(byte_len: int) -> int:
    return max(1, -(-byte_len // 64))


# csrc/blake2s.cu: kMaxTailLog
MAX_TAIL_LOG = 12
# A layer of at most 2^TAIL_LOG nodes is hashed by the one-block tail
# kernel, with every layer above it, in one launch (see `merkle_tail`).
# One block on one SM hashes a level of 2^11 nodes in ~14 us where a launch
# over the card takes ~3 us, but each launch saved is 15-25 us of the
# enqueueing thread, which is what a prove waits for.  Both were measured
# for every first level on the H100 when the tail kernel came in; CHANGES.md
# records it under the Merkle commit's redesign.
TAIL_LOG = 11


def _launch_layer(prev: Optional[torch.Tensor], entries: Sequence[torch.Tensor],
                  n: int, byte_len: int, counter: str,
                  device) -> torch.Tensor:
    """One launch of csrc/blake2s.cu's layer kernel over n messages: the
    child pairs of `prev` [8, 2n] if given, then the rows of `entries` ([n]
    or [C, n] CUDA int32 tensors) read where they lie."""
    if prev is not None:
        kernels.check_cuda_tensor(prev, "prev")
        if tuple(prev.shape) != (8, 2 * n):
            raise ValueError(f"prev: expected [8, {2 * n}], got "
                             f"{tuple(prev.shape)}")
        if prev.data_ptr() % 8:
            prev = prev.clone()  # the kernel loads 8-byte child pairs
    table = kernels.segment_table(entries, n, device)
    rows = table.rows + (16 if prev is not None else 0)
    if rows > 16 * _n_blocks(byte_len):
        raise ValueError("more words than the blocks of byte_len hold")
    out = torch.empty((8, n), dtype=torch.int32, device=device)
    if n:
        kernels.launch("blake2s_layer", counter, device,
                       None if prev is None else prev.data_ptr(), *table.args,
                       out.data_ptr(), n, byte_len)
    return out


def hash_words_major_cuda(words: torch.Tensor, byte_len: int) -> torch.Tensor:
    """Launch csrc/blake2s.cu on CUDA int32 words [W, N], W at most 16 *
    n_blocks: every word given is hashed, the words past W are zero.  Rows
    may lie a stride apart."""
    kernels.check_cuda_tensor(words, "words", contiguous=False)
    if words.ndim != 2:
        raise ValueError("words must be [W, N]")
    return _launch_layer(None, [words], words.shape[1], byte_len, "blake2s",
                         words.device)


def hash_words_major(words: torch.Tensor, byte_len: int) -> torch.Tensor:
    """blake2s-256 of N messages given word-major as [W, N] LE words.

    W*4 >= byte_len; words and bytes past byte_len must be zero (they are
    not read).  Returns int32 [8, N] digest words."""
    words = words[:-(-byte_len // 4)]
    if kernels.on_cuda(words):
        return hash_words_major_cuda(words, byte_len)
    return hash_words_major_plain(words, byte_len)


def merkle_layer_plain(prev: Optional[torch.Tensor],
                       columns: Sequence[torch.Tensor], n: int = 1,
                       device=None) -> torch.Tensor:
    """One Merkle layer in plain PyTorch, on any device: the even/odd split
    of the child layer, a concatenation with the column rows, the hash.
    `n` and `device` are read only when there is neither prev nor column
    (then `device` is CUDA device 0 unless named)."""
    parts = []
    if prev is not None:
        parts += [prev[:, 0::2], prev[:, 1::2]]
    parts += [c if c.ndim == 2 else c[None, :] for c in columns]
    if parts:
        words = torch.cat(parts, dim=0)
    else:
        words = torch.zeros((0, n), dtype=torch.int32,
                            device=entry_device(device))
    return hash_words_major_plain(words, 4 * words.shape[0])


def merkle_layer_cuda(prev: Optional[torch.Tensor],
                      columns: Sequence[torch.Tensor], n: int = 1,
                      device=None) -> torch.Tensor:
    """One Merkle layer in one launch of csrc/blake2s.cu (counted as
    `merkle_layer` when it reads child pairs, else as `blake2s`)."""
    if prev is not None:
        n, device = prev.shape[1] // 2, prev.device
    elif columns:
        n, device = columns[0].shape[-1], columns[0].device
    rows = sum(c.shape[0] if c.ndim == 2 else 1 for c in columns)
    byte_len = 4 * (rows + (16 if prev is not None else 0))
    return _launch_layer(prev, columns, n, byte_len,
                         "blake2s" if prev is None else "merkle_layer",
                         torch.device(device))


def merkle_layer(prev: Optional[torch.Tensor],
                 columns: Sequence[torch.Tensor], n: int = 1,
                 device=None) -> torch.Tensor:
    """node i = blake2s(prev[:, 2i] || prev[:, 2i+1] || column values at i).

    prev: int32 [8, 2n] digest words of the child layer, or None at a leaf
    layer.  columns: entries [n] or [C, n], hashed in order.  With neither,
    n hashes of the empty message on `device` (CUDA device 0 unless
    named).  Returns int32 [8, n]."""
    first = prev if prev is not None else (columns[0] if columns else None)
    device = entry_device(device) if first is None else first.device
    if kernels.is_cuda(device):
        return merkle_layer_cuda(prev, columns, n, device)
    return merkle_layer_plain(prev, columns, n, device)


def merkle_tail_plain(prev: torch.Tensor) -> List[torch.Tensor]:
    """The layers above prev [8, 2^log], from 2^(log-1) nodes down to the
    root, in plain PyTorch: a loop of `merkle_layer_plain`."""
    layers = []
    while prev.shape[1] > 1:
        prev = merkle_layer_plain(prev, [])
        layers.append(prev)
    return layers


def merkle_tail_cuda(prev: torch.Tensor) -> List[torch.Tensor]:
    """The same layers in one launch of csrc/blake2s.cu's one-block tail
    kernel; they are column slices of one [8, 2^log - 1] buffer, side by
    side and largest first, so their rows are not contiguous."""
    kernels.check_cuda_tensor(prev, "prev")
    log = int(prev.shape[1]).bit_length() - 1
    if prev.ndim != 2 or prev.shape[0] != 8 or prev.shape[1] != 1 << log:
        raise ValueError(f"prev: expected [8, 2^log], got {tuple(prev.shape)}")
    if not 1 <= log <= MAX_TAIL_LOG + 1:
        raise ValueError(f"the tail takes 2 to 2^{MAX_TAIL_LOG + 1} child "
                         f"nodes, got 2^{log}")
    if prev.data_ptr() % 8:
        prev = prev.clone()  # the kernel loads 8-byte child pairs
    out = torch.empty((8, (1 << log) - 1), dtype=torch.int32,
                      device=prev.device)
    kernels.launch("merkle_tail", "merkle_tail", prev.device, prev.data_ptr(),
                   out.data_ptr(), log)
    return list(out.split([1 << j for j in range(log - 1, -1, -1)], dim=1))


def merkle_tail(prev: torch.Tensor) -> List[torch.Tensor]:
    """Every layer above prev [8, 2^log] that takes in no column, largest
    first: node i of each is blake2s(left || right) of the layer below."""
    if kernels.on_cuda(prev):
        return merkle_tail_cuda(prev)
    return merkle_tail_plain(prev)


def digest_words_to_bytes(words) -> bytes:
    """8 u32 words (numpy or int32 bit-views) -> 32-byte digest."""
    return b"".join((int(w) & _MASK).to_bytes(4, "little") for w in words)


def digest_bytes_to_words(digest: bytes) -> np.ndarray:
    return np.frombuffer(digest, dtype="<u4").copy()


# Message of a proof-of-work nonce: the channel digest's 8 words, then the
# nonce as two LE words (proof_of_work.py; tstwo_tpu/proof_of_work.py:29-53).
GRIND_BYTE_LEN = 40


def grind_trailing_zeros(digests: torch.Tensor) -> torch.Tensor:
    """Trailing zeros of digest words 0-3 of [8, N] int32 digests, read as
    one LE u128 (128 when all four are zero), as int64 [N]
    (`Blake2sChannel.trailing_zeros`)."""
    tz = torch.zeros(digests.shape[1], dtype=torch.int64,
                     device=digests.device)
    carry = torch.ones_like(tz, dtype=torch.bool)
    for w in range(4):
        d = digests[w].to(torch.int64) & _MASK
        x, word_tz = d, torch.zeros_like(tz)
        for s in (16, 8, 4, 2, 1):  # halving search for the lowest set bit
            low_zero = (x & ((1 << s) - 1)) == 0
            word_tz = word_tz + torch.where(low_zero, s, 0)
            x = torch.where(low_zero, x >> s, x)
        word_tz = word_tz + (x == 0).to(torch.int64)  # 32 when d == 0
        tz = tz + torch.where(carry, word_tz, 0)
        carry = carry & (d == 0)
    return tz


def _grind_args(digest_words, start: int, count: int, pow_bits: int):
    words = np.asarray(digest_words, dtype=np.uint64)
    if words.shape != (8,) or (words > _MASK).any():
        raise ValueError("digest_words: expected 8 u32 words")
    if count <= 0 or start < 0 or start + count > 1 << 63 or pow_bits < 0:
        raise ValueError(f"grind range [{start}, {start} + {count}) or "
                         f"pow_bits {pow_bits} out of range")
    return words.astype(np.uint32)


def grind_hit_plain(digest_words, start: int, count: int, pow_bits: int,
                    device=None) -> torch.Tensor:
    """Plain PyTorch version on `device` (CUDA device 0 unless named): the
    [10, count] messages, their digests by `hash_words_major_plain`, the
    trailing zeros in int64, and the first nonce with >= pow_bits of them
    as an int64 [1] tensor on `device` (-1 if none), without a wait for
    the device."""
    words = _grind_args(digest_words, start, count, pow_bits)
    device = entry_device(device)
    nonces = start + torch.arange(count, dtype=torch.int64, device=device)
    msg = torch.cat([
        upload(torch.from_numpy(words.astype(np.int64)), device)[:, None]
        .expand(8, count), (nonces & _MASK)[None, :], (nonces >> 32)[None, :]])
    hit = grind_trailing_zeros(
        hash_words_major_plain(msg, GRIND_BYTE_LEN)) >= pow_bits
    first = torch.argmax(hit.to(torch.int8))  # the first of the maxima
    return torch.where(hit[first], nonces[first], -1).reshape(1)


def grind_hit_cuda(digest_words, start: int, count: int, pow_bits: int,
                   device) -> torch.Tensor:
    """One launch of csrc/blake2s.cu's grind kernel over the nonces [start,
    start + count) on CUDA `device`: the least hit as an int64 [1] tensor
    on the device (-1 if none), not waited for."""
    words = _grind_args(digest_words, start, count, pow_bits)
    device = torch.device(device)
    if not kernels.is_cuda(device):
        raise ValueError(f"expected a CUDA device, got {device}")
    best = torch.full((1,), -1, dtype=torch.int64, device=device)  # all ones
    kernels.launch("blake2s_grind", "blake2s_grind", device,
                   words.ctypes.data, start, count, pow_bits, best.data_ptr())
    return best


def grind_batch_plain(digest_words, start: int, count: int, pow_bits: int,
                      device=None) -> int:
    """`grind_hit_plain` read back: the first hit, or -1."""
    return to_host_list(grind_hit_plain(digest_words, start, count,
                                        pow_bits, device))[0]


def grind_batch_cuda(digest_words, start: int, count: int, pow_bits: int,
                     device) -> int:
    """`grind_hit_cuda` and an 8-byte read of the least hit, or -1."""
    return to_host_list(grind_hit_cuda(digest_words, start, count,
                                       pow_bits, device))[0]


def grind_batch(digest_words, start: int, count: int, pow_bits: int,
                device=None) -> int:
    """The least nonce in [start, start + count) whose message digest ||
    LE64(nonce) hashes to >= pow_bits trailing zeros, or -1.
    `digest_words`: the channel digest as 8 u32 words
    (`digest_bytes_to_words`).  A CUDA device (device 0 unless named)
    launches the kernel, the CPU runs the plain version."""
    device = entry_device(device)
    if kernels.is_cuda(device):
        return grind_batch_cuda(digest_words, start, count, pow_bits, device)
    return grind_batch_plain(digest_words, start, count, pow_bits, device)


# The transcript state a step reads and writes: the digest as [8] words,
# n_sent as [2] LE words (channel/device.py).  A drawn hash with a word at
# or above 2P is rejected whole.
_P = (1 << 31) - 1


def _transcript_args(digest, n_sent, msg, msg_bytes, k):
    if tuple(digest.shape) != (8,):
        raise ValueError(f"digest: expected [8] words, got "
                         f"{tuple(digest.shape)}")
    if msg is None:
        if n_sent is None or tuple(n_sent.shape) != (2,):
            raise ValueError("n_sent: expected [2] words without a mix")
        return None
    if msg.ndim != 1:
        raise ValueError("msg: expected [W] words")
    if msg_bytes is None:
        msg_bytes = 4 * msg.shape[0]
    if not 0 <= msg_bytes <= 4 * msg.shape[0] or k < 0:
        raise ValueError(f"msg_bytes {msg_bytes} of {msg.shape[0]} words, "
                         f"k {k}")
    return msg_bytes


def transcript_plain(digest: torch.Tensor, n_sent: Optional[torch.Tensor]
                     = None, msg: Optional[torch.Tensor] = None,
                     msg_bytes: Optional[int] = None, k: int = 0):
    """Plain PyTorch version of one transcript step, on any device (the
    rejection reads each drawn hash on the host).  If `msg` (int32 [W]
    words; `msg_bytes` of them, default all) is given, digest' =
    blake2s(digest || msg) and n_sent' = 0; else n_sent (int32 [2] LE
    words) is read.  Then k draws: h = blake2s(digest' || LE64(n_sent') ||
    0^24), n_sent' += 1, again while a word of h is >= 2P; each draw's 8
    words reduced below P.  Returns (digest' [8], n_sent' [2], draws
    [k, 8]), int32 on the digest's device."""
    msg_bytes = _transcript_args(digest, n_sent, msg, msg_bytes, k)
    device = digest.device
    if msg_bytes is not None:
        words = msg[:-(-msg_bytes // 4)].to(torch.int64) & _MASK
        if msg_bytes % 4:
            words[-1] &= (1 << (8 * (msg_bytes % 4))) - 1
        message = torch.cat([digest.to(torch.int64) & _MASK, words])
        digest = hash_words_major_plain(message[:, None],
                                        32 + msg_bytes)[:, 0]
        count = 0
    else:
        lo, hi = (int(w) & _MASK for w in to_host_list(n_sent))
        count = lo | hi << 32
    d = digest.to(torch.int64) & _MASK
    draws = []
    for _ in range(k):
        while True:
            ctr = torch.tensor([count & _MASK, count >> 32, 0, 0, 0, 0, 0, 0],
                               dtype=torch.int64, device=device)
            h = hash_words_major_plain(torch.cat([d, ctr])[:, None],
                                       64)[:, 0].to(torch.int64) & _MASK
            count += 1
            if not bool((h >= 2 * _P).any()):
                break
        draws.append(torch.where(h >= _P, h - _P, h))
    out = torch.tensor([count & _MASK, count >> 32], dtype=torch.int64,
                       device=device)
    draws = (torch.stack(draws) if draws
             else torch.zeros((0, 8), dtype=torch.int64, device=device))
    return (as_int32_bits(d), as_int32_bits(out), as_int32_bits(draws))


def transcript_cuda(digest: torch.Tensor, n_sent: Optional[torch.Tensor]
                    = None, msg: Optional[torch.Tensor] = None,
                    msg_bytes: Optional[int] = None, k: int = 0):
    """One launch of csrc/blake2s.cu's transcript kernel on CUDA int32
    tensors (`transcript_plain` says what it computes).  The results are
    views of one new [10 + 8k] buffer; nothing is read back."""
    kernels.check_cuda_tensor(digest, "digest")
    msg_bytes = _transcript_args(digest, n_sent, msg, msg_bytes, k)
    device = digest.device
    if msg_bytes is None:
        kernels.check_cuda_tensor(n_sent, "n_sent")
        msg_ptr, stride, n_sent_ptr = None, 1, n_sent.data_ptr()
        msg_bytes = -1
    else:  # the words may lie a stride apart (a root in its layer)
        kernels.check_cuda_tensor(msg, "msg", contiguous=False)
        msg_ptr, stride, n_sent_ptr = msg.data_ptr(), msg.stride(0), None
    for name, t in (("n_sent", n_sent), ("msg", msg)):
        if t is not None and t.device != device:
            raise ValueError(f"{name} on {t.device}, digest on {device}")
    out = torch.empty(10 + 8 * k, dtype=torch.int32, device=device)
    ptr = out.data_ptr()
    kernels.launch("blake2s_transcript", "blake2s_transcript", device,
                   digest.data_ptr(), n_sent_ptr, msg_ptr, stride, msg_bytes,
                   ptr, ptr + 32, ptr + 40 if k else None, k)
    return out[:8], out[8:10], out[10:].view(k, 8)


def transcript(digest: torch.Tensor, n_sent: Optional[torch.Tensor] = None,
               msg: Optional[torch.Tensor] = None,
               msg_bytes: Optional[int] = None, k: int = 0):
    """One transcript step (`transcript_plain`): the kernel for a CUDA
    digest, the plain version for a CPU one."""
    if kernels.on_cuda(digest):
        return transcript_cuda(digest, n_sent, msg, msg_bytes, k)
    return transcript_plain(digest, n_sent, msg, msg_bytes, k)
