"""Proof-of-work grind of the PyTorch port against the JAX package
(tolerance 0: the same nonce).

`grind` / `grind_device` on the CPU (the plain version of the grind
kernel, `ops.blake2s.grind_batch_plain`) against
`tstwo_tpu.proof_of_work.grind`, which takes its batched device path at
pow_bits >= 12 through XLA on the CPU, and against both packages'
`grind_host`; the plain batch scan around nonce 2^32 against hashlib; the
dispatch (either channel on the device from pow_bits 12, on the host below
it); and a wide-Fibonacci
proof under pow_bits 14, byte for byte against the JAX package's.
"""
import hashlib
import json

import pytest

from tstwo_tpu import proof_of_work as jax_pow
from tstwo_tpu.channel.blake2s import Blake2sChannel as JaxChannel
from tstwo_tpu.examples import wide_fibonacci as jax_wf
from tstwo_tpu.fields import QM31 as JaxQM31
from tstwo_tpu.fri import FriConfig as JaxFriConfig
from tstwo_tpu.pcs import PcsConfig as JaxPcsConfig
from tstwo_tpu.serialize import proof_from_dict as jax_from_dict
from tstwo_tpu.serialize import proof_to_dict as jax_to_dict
from tstwo_tpu_torch import proof_of_work as pow_
from tstwo_tpu_torch.channel.blake2s import Blake2sChannel
from tstwo_tpu_torch.channel.poseidon import Poseidon252Channel
from tstwo_tpu_torch.examples import wide_fibonacci as wf
from tstwo_tpu_torch.fields import QM31
from tstwo_tpu_torch.fri import FriConfig
from tstwo_tpu_torch.ops import blake2s as b2
from tstwo_tpu_torch.pcs import PcsConfig
from tstwo_tpu_torch.serialize import proof_from_dict, proof_to_dict

FELTS = [(1, 2, 3, 4), (5, 6, 7, (1 << 31) - 2)]


def _channels(state: str):
    """The same transcript state in both packages."""
    ours, theirs = Blake2sChannel(), JaxChannel()
    if state == "mix_u64":
        ours.mix_u64(0x123456789)
        theirs.mix_u64(0x123456789)
    elif state == "mix_felts":
        ours.mix_felts([QM31.from_ints(f) for f in FELTS])
        theirs.mix_felts([JaxQM31.from_ints(f) for f in FELTS])
    assert ours.digest == theirs.digest
    return ours, theirs


def _hashlib_scan(digest: bytes, start: int, count: int, pow_bits: int):
    for nonce in range(start, start + count):
        d = hashlib.blake2s(digest + nonce.to_bytes(8, "little")).digest()
        v = int.from_bytes(d[:16], "little")
        if (128 if v == 0 else (v & -v).bit_length() - 1) >= pow_bits:
            return nonce
    return -1


@pytest.mark.parametrize("state", ["fresh", "mix_u64", "mix_felts"])
@pytest.mark.parametrize("pow_bits", range(17))
def test_grind_equals_jax_and_host(state, pow_bits):
    ours, theirs = _channels(state)
    want = jax_pow.grind(theirs, pow_bits)
    assert jax_pow.grind_host(theirs, pow_bits) == want
    assert pow_.grind_host(ours, pow_bits) == want
    assert pow_.grind(ours, pow_bits, device="cpu") == want
    assert pow_.grind_device(ours, pow_bits, "cpu") == want


def test_grind_device_scans_past_the_first_batch():
    ours, _ = _channels("mix_felts")
    want = pow_.grind_host(ours, 10)
    assert want >= 3 * 64  # the hit lies in a later batch
    assert pow_.grind_device(ours, 10, "cpu", batch=64) == want
    assert pow_.grind_device(ours, 10, "cpu", batch=100) == want


@pytest.mark.parametrize("start,count,pow_bits", [
    ((1 << 32) - 3, 2, 0),       # lo wraps: 2^32 - 3, 2^32 - 2
    ((1 << 32) - 3, 600, 8),     # the hit has a hi word of 1
    ((1 << 32) - 3, 3000, 10),
    (5 << 32, 700, 7),
    (0, 300, 40),                # no hit: -1
])
def test_grind_batch_plain_near_2_32_equals_hashlib(start, count, pow_bits):
    digest = hashlib.blake2s(b"grind").digest()
    want = _hashlib_scan(digest, start, count, pow_bits)
    if pow_bits in (8, 10):
        assert want >= 1 << 32
    got = b2.grind_batch_plain(b2.digest_bytes_to_words(digest), start,
                               count, pow_bits, "cpu")
    assert got == want
    assert b2.grind_batch(b2.digest_bytes_to_words(digest), start, count,
                          pow_bits, "cpu") == want


def test_grind_trailing_zeros_of_a_zero_digest_is_128():
    import torch

    d = torch.zeros((8, 3), dtype=torch.int32)
    d[0, 1] = 1 << 4
    d[1, 2] = -(1 << 31)  # word 1 = 2^31, word 0 zero: 63
    assert b2.grind_trailing_zeros(d).tolist() == [128, 4, 63]


def test_grind_leaves_the_channel_unchanged():
    ours, _ = _channels("mix_u64")
    before = ours.clone()
    pow_.grind(ours, 13, device="cpu")
    pow_.grind_device(ours, 6, "cpu")
    assert ours == before


def test_poseidon_channel_grinds_on_the_host(monkeypatch):
    """Below DEVICE_MIN_POW_BITS, or with use_device=False, either channel
    grinds on the host; from it on, a Poseidon252 channel goes to the
    device scan as a Blake2s channel does."""
    def device(channel, pow_bits, device=None):
        calls.append(("device", channel, pow_bits, device))
        return 55

    def host(channel, pow_bits):
        calls.append(("host", channel, pow_bits))
        return 77

    calls = []
    monkeypatch.setattr(pow_, "grind_device", device)
    monkeypatch.setattr(pow_, "grind_host", host)
    ch = Poseidon252Channel()
    assert pow_.grind(ch, 11, device="cpu") == 77
    assert pow_.grind(ch, 26, use_device=False) == 77
    assert pow_.grind(ch, 12, device="cpu") == 55
    assert calls == [("host", ch, 11), ("host", ch, 26),
                     ("device", ch, 12, "cpu")]
    # a Blake2s channel below the threshold, or with use_device=False, too
    assert pow_.grind(Blake2sChannel(), 11, device="cpu") == 77
    assert pow_.grind(Blake2sChannel(), 16, use_device=False) == 77
    assert pow_.grind(Blake2sChannel(), 12, device="cpu") == 55


def test_grind_batch_refuses_bad_arguments():
    words = b2.digest_bytes_to_words(b"\x00" * 32)
    with pytest.raises(ValueError):
        b2.grind_batch(words[:7], 0, 4, 1, "cpu")
    with pytest.raises(ValueError):
        b2.grind_batch(words, 0, 0, 1, "cpu")
    with pytest.raises(ValueError):
        b2.grind_batch(words, (1 << 63) - 2, 4, 1, "cpu")


LOG_N, SEQ = 8, 8


def test_prove_with_grinding_equals_jax_proof():
    """pow_bits 14 sends both provers' grind to the device path."""
    ours, component, config = wf.prove_wide_fibonacci(
        LOG_N, SEQ, PcsConfig(14, FriConfig(0, 1, 8)), seed=0, device="cpu")
    theirs, jax_component, jax_config = jax_wf.prove_wide_fibonacci(
        LOG_N, SEQ, JaxPcsConfig(14, JaxFriConfig(0, 1, 8)), seed=0)
    ours_d, theirs_d = proof_to_dict(ours), jax_to_dict(theirs)
    assert ours_d["proof_of_work"] > 0
    assert json.dumps(ours_d, sort_keys=True) == json.dumps(theirs_d,
                                                            sort_keys=True)
    wf.verify_wide_fibonacci(proof_from_dict(theirs_d), component, config,
                             LOG_N)
    jax_wf.verify_wide_fibonacci(jax_from_dict(ours_d), jax_component,
                                 jax_config, LOG_N)
