"""Device-resident Blake2s Fiat-Shamir transcript.

The host channel (channel/blake2s.py) is a sequential 32-byte hash chain.
Every mix or draw that feeds device work makes a host round trip there:
the root is copied to the host, mixed, and the drawn felt copied back,
and each copy waits for the CUDA stream to drain.  FRI's commit did two
of them a layer.

Here the channel's primitives work on a state kept in device tensors:
the digest as int32 [8] LE words (bit-views of u32) and n_sent as int32
[2] LE words (so any u64 count the host channel can reach).  On a CUDA
tensor each function is ONE launch of csrc/blake2s.cu's transcript kernel
(`ops.blake2s.transcript_cuda`): a mix, then k draws, the whole-hash
rejection of a draw a loop inside the kernel.  On a CPU tensor each is the
plain version (`ops.blake2s.transcript_plain`: the plain hash and a Python
rejection loop).  Bit-exact with the host channel (reference
channel/blake2.ts:25-224 / Rust stwo Blake2sChannel):

  mix_root:   digest' = blake2s(digest || root)             (64-byte block)
  draw bytes: blake2s(digest || LE64(n_sent) || 0^24), n_sent += 1
  draw felts: 8 u32 per hash, rejected whole if any >= 2P, then reduced

Only `state_from_channel` and `sync_host_channel` cross between host and
device: the host channel is re-synced from the final device state after
one fetch.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import blake2s as b2
from ..utils import entry_device, upload

_MASK = 0xFFFFFFFF


def upload_words(words, device=None) -> torch.Tensor:
    """u32 words (any ints) as an int32 tensor on `device`, CUDA device 0
    unless named.  To a CUDA device the copy goes from pinned memory,
    asynchronously: the host does not wait for the stream to drain."""
    arr = (np.asarray(words, dtype=np.uint64) & _MASK).astype(np.uint32)
    host = torch.from_numpy(arr.view(np.int32).copy())
    device = entry_device(device)
    if device.type == "cuda":
        return upload(host.pin_memory(), device, non_blocking=True)
    return host.to(device)


def n_sent_words(n_sent: int):
    """n_sent as its two LE u32 words."""
    return [n_sent & _MASK, (n_sent >> 32) & _MASK]


def state_from_channel(channel, device=None):
    """(digest int32 [8], n_sent int32 [2]) on `device` from a host
    Blake2sChannel, by asynchronous uploads: no fetch, and no upload of a
    digest already on the device (`Blake2sChannel.digest_words_device`).
    Without `device`, where the channel's device digest lies, else on CUDA
    device 0."""
    words = n_sent_words(channel.channel_time.n_sent)
    digest = channel.digest_words_device(device)
    return digest, upload_words(words, digest.device)


def sync_host_channel(channel, digest_words, n_sent: int,
                      n_mixes: int) -> None:
    """Replay the device transcript's effect onto the host channel.

    n_mixes = number of mix_* ops performed on device (each bumps
    n_challenges and resets n_sent); n_sent = device counter after the
    last draw."""
    channel.digest = b2.digest_words_to_bytes(np.asarray(digest_words))
    channel.channel_time.n_challenges += n_mixes
    channel.channel_time.n_sent = int(n_sent)


def mix_root(digest: torch.Tensor, root_words: torch.Tensor):
    """digest' = blake2s(digest || root); resets n_sent
    (reference vcs/blake2_merkle.ts:28-32).  Returns (digest', n_sent')."""
    d, ns, _ = b2.transcript(digest, msg=root_words, msg_bytes=32)
    return d, ns


def mix_root_and_draw_felt(digest: torch.Tensor, root_words: torch.Tensor):
    """`mix_root` then `draw_felt` in one step (one launch on the card):
    an FRI layer's transcript.  Returns (digest', n_sent', felt [4])."""
    d, ns, felts = b2.transcript(digest, msg=root_words, msg_bytes=32, k=1)
    return d, ns, felts[0, :4]


def mix_u64(digest: torch.Tensor, value):
    """digest' = blake2s(digest || LE64(value)); `value` is an int, or its
    two LE words on the digest's device (an int32 [2] tensor or a (lo, hi)
    pair of tensors).  Returns (digest', n_sent')."""
    if isinstance(value, (int, np.integer)):
        msg = upload_words(n_sent_words(int(value)), digest.device)
    elif isinstance(value, torch.Tensor):
        msg = value.reshape(-1)
    else:
        msg = torch.cat([v.reshape(-1) for v in value])
    d, ns, _ = b2.transcript(digest, msg=msg, msg_bytes=8)
    return d, ns


def mix_felts(digest: torch.Tensor, felts: torch.Tensor):
    """digest' = blake2s(digest || 16-byte LE QM31s); felts int32 [k, 4]
    coordinate rows (to_m31_array order).  Returns (digest', n_sent')."""
    d, ns, _ = b2.transcript(digest, msg=felts.reshape(-1),
                     msg_bytes=16 * felts.shape[0])
    return d, ns


def draw_base_felts(digest: torch.Tensor, n_sent: torch.Tensor):
    """8 uniform M31s (reference channel/blake2.ts:159-175): returns
    (n_sent', int32 [8] in [0, P)).  A hash with any word >= 2P
    (probability ~2^-28) is rejected whole and drawn again."""
    _, ns, felts = b2.transcript(digest, n_sent, k=1)
    return ns, felts[0]


def draw_felt(digest: torch.Tensor, n_sent: torch.Tensor):
    """One QM31 as int32 [4] (the first 4 of 8 drawn base felts)."""
    ns, felts = draw_base_felts(digest, n_sent)
    return ns, felts[:4]


def draw_felts(digest: torch.Tensor, n_sent: torch.Tensor, n: int):
    """n QM31s as int32 [n, 4] (reference channel/blake2.ts draw_felts:
    8-felt batches through a 4-felt queue), ceil(n / 2) draws in one
    step."""
    _, ns, felts = b2.transcript(digest, n_sent, k=-(-n // 2))
    return ns, felts.reshape(-1, 4)[:n]
