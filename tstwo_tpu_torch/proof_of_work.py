"""Proof-of-work grind: find the smallest nonce whose mixed digest has
>= pow_bits trailing zeros (reference backend/cpu/grind.ts:31-42).

`grind_host` scans one nonce at a time on the host channel (any flavour).
`grind_device` scans batches of nonces from 0 upward on a device and
returns the same least nonce: a Blake2s channel through
`ops.blake2s.grind_batch`, a Poseidon252 channel through
`ops.poseidon252.poseidon_grind_batch` (on a CUDA device each is one launch
of a hand-written grind kernel a batch).  `grind` takes the device where
`grinds_on_device` says so, for either channel at pow_bits >= 12 (the JAX
package's threshold, tstwo_tpu/proof_of_work.py:82-86, where only a Blake2s
channel leaves the host), and the host otherwise.  Each batch adds its
nonces to the span tree's counter `grind_nonces`.
"""
from __future__ import annotations

from .channel.blake2s import Blake2sChannel
from .channel.poseidon import Poseidon252Channel
from .ops import blake2s as b2
from .ops import poseidon252 as pos
from .tracing import count
from .utils import entry_device

# Nonces a launch on a CUDA device: a pow_bits-26 grind (2^26 nonces
# expected) is about four launches, each ~1 ms of kernel and one 8-byte
# read.  The CPU's plain version holds ~100 int64 temporaries of the batch,
# so its batch stays small.
GRIND_BATCH_CUDA = 1 << 24
GRIND_BATCH_CPU = 1 << 14
# The same for a Poseidon252 channel, two Hades permutations a nonce: 2^20
# nonces are ~12 ms of kernel.  Its trailing zeros start at bit 248 of a
# felt below 2^252 (channel/poseidon.py `trailing_zeros`), so bits 251-255
# are nearly always zero and pow_bits 26 expects ~2^21 nonces, two launches.
# The plain version's batch is a CPU test's whole scan.
GRIND_BATCH_P252_CUDA = 1 << 20
GRIND_BATCH_P252_CPU = 1 << 8
DEVICE_MIN_POW_BITS = 12


def grind_host(channel, pow_bits: int) -> int:
    nonce = 0
    while True:
        ch = channel.clone()
        ch.mix_u64(nonce)
        if ch.trailing_zeros() >= pow_bits:
            return nonce
        nonce += 1


def grinds_on_device(channel, pow_bits: int) -> bool:
    """Whether `grind` scans for this channel's nonce on the device."""
    return pow_bits >= DEVICE_MIN_POW_BITS and isinstance(
        channel, (Blake2sChannel, Poseidon252Channel))


def grind_device(channel, pow_bits: int, device=None,
                 batch: int = None) -> int:
    """The least nonce by batches of `batch` nonces on `device` (CUDA
    device 0 unless given) for a Blake2s or Poseidon252 channel, which is
    only read.  On a CUDA device a failure to build or launch the kernel
    raises."""
    device = entry_device(device)
    on_cuda = device.type == "cuda"
    if isinstance(channel, Poseidon252Channel):
        digest = channel.digest.value

        def scan(start, n):
            return pos.poseidon_grind_batch(digest, start, n, pow_bits,
                                            device)
        default = GRIND_BATCH_P252_CUDA if on_cuda else GRIND_BATCH_P252_CPU
    elif isinstance(channel, Blake2sChannel):
        words = b2.digest_bytes_to_words(channel.digest)

        def scan(start, n):
            return b2.grind_batch(words, start, n, pow_bits, device)
        default = GRIND_BATCH_CUDA if on_cuda else GRIND_BATCH_CPU
    else:
        raise TypeError(f"no device grind for {type(channel).__name__}")
    batch = default if batch is None else batch
    start = 0
    while True:
        nonce = scan(start, batch)
        count("grind_nonces", batch)
        if nonce >= 0:
            return nonce
        start += batch


def grind(channel, pow_bits: int, use_device: bool = True,
          device=None) -> int:
    if use_device and grinds_on_device(channel, pow_bits):
        return grind_device(channel, pow_bits, device)
    return grind_host(channel, pow_bits)
