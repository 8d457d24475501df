"""Proof-of-work grind: find the smallest nonce whose mixed digest has
>= pow_bits trailing zeros (reference backend/cpu/grind.ts:31-42).

`grind_host` scans one nonce at a time on the host channel (any flavour).
`grind_device` scans batches of nonces from 0 upward on a device, through
`ops.blake2s.grind_batch` (on a CUDA device one launch of the hand-written
grind kernel a batch), and returns the same least nonce.  `grind` picks
between them as the JAX package does (tstwo_tpu/proof_of_work.py:82-86):
the device for a Blake2s channel at pow_bits >= 12, the host otherwise.
"""
from __future__ import annotations

from .channel.blake2s import Blake2sChannel
from .ops import blake2s as b2
from .utils import entry_device

# Nonces a launch on a CUDA device: a pow_bits-26 grind (2^26 nonces
# expected) is about four launches, each ~1 ms of kernel and one 8-byte
# read.  The CPU's plain version holds ~100 int64 temporaries of the batch,
# so its batch stays small.
GRIND_BATCH_CUDA = 1 << 24
GRIND_BATCH_CPU = 1 << 14
DEVICE_MIN_POW_BITS = 12


def grind_host(channel, pow_bits: int) -> int:
    nonce = 0
    while True:
        ch = channel.clone()
        ch.mix_u64(nonce)
        if ch.trailing_zeros() >= pow_bits:
            return nonce
        nonce += 1


def grind_device(channel: Blake2sChannel, pow_bits: int, device=None,
                 batch: int = None) -> int:
    """The least nonce by batches of `batch` nonces on `device` (CUDA
    device 0 unless given); the channel is only read.  On a CUDA device a
    failure to build or launch the kernel raises."""
    device = entry_device(device)
    if batch is None:
        batch = GRIND_BATCH_CUDA if device.type == "cuda" else GRIND_BATCH_CPU
    digest_words = b2.digest_bytes_to_words(channel.digest)
    start = 0
    while True:
        nonce = b2.grind_batch(digest_words, start, batch, pow_bits, device)
        if nonce >= 0:
            return nonce
        start += batch


def grind(channel, pow_bits: int, use_device: bool = True,
          device=None) -> int:
    if (use_device and pow_bits >= DEVICE_MIN_POW_BITS
            and isinstance(channel, Blake2sChannel)):
        return grind_device(channel, pow_bits, device)
    return grind_host(channel, pow_bits)
