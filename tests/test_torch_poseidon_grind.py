"""The proof-of-work grind of a Poseidon252 channel on the CPU (tolerance 0:
the same nonce).

`ops.poseidon252`'s plain grind scan (`poseidon_grind_hit_plain`, the CUDA
kernel's CPU version) against `grind_host` of both packages on seeded
channel states, from nonce 0, from past the first hit, across nonce 2^32
and over a range without a hit; the channel's trailing-zero rule on edge
felts; `proof_of_work.grind`'s route through the scan and the counters
`grind_nonces` and `host_hades` of the span tree.
"""
import numpy as np
import pytest
import torch

from tstwo_tpu import proof_of_work as jax_pow
from tstwo_tpu.channel.poseidon import FieldElement252 as JaxFelt
from tstwo_tpu.channel.poseidon import Poseidon252Channel as JaxChannel
from tstwo_tpu_torch import proof_of_work as pow_
from tstwo_tpu_torch import tracing
from tstwo_tpu_torch.channel.poseidon import (P252, FieldElement252,
                                              Poseidon252Channel)
from tstwo_tpu_torch.fields import QM31
from tstwo_tpu_torch.ops import poseidon252 as pos


def _channel(seed: int) -> Poseidon252Channel:
    """A channel state made by a seeded mix of each kind."""
    rng = np.random.default_rng(seed)
    ch = Poseidon252Channel()
    ch.mix_root(FieldElement252(int(rng.integers(0, 1 << 62)) << 180))
    ch.mix_u64(int(rng.integers(0, 1 << 63)))
    ch.mix_felts([QM31.from_ints(rng.integers(0, (1 << 31) - 1, 4).tolist())])
    return ch


def _host_scan(ch, start: int, count: int, pow_bits: int) -> int:
    for nonce in range(start, start + count):
        probe = ch.clone()
        probe.mix_u64(nonce)
        if probe.trailing_zeros() >= pow_bits:
            return nonce
    return -1


def _plain(ch, start, count, pow_bits) -> int:
    hit = pos.poseidon_grind_hit_plain(ch.digest.value, start, count,
                                       pow_bits, "cpu")
    assert hit.shape == (1,) and hit.dtype == torch.int64
    return int(hit)


SEEDS = [3, 17, 2 ** 33 + 1, 2 ** 61 - 5]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("pow_bits", [6, 7, 8, 9, 10])
def test_plain_scan_equals_grind_host(seed, pow_bits):
    ch = _channel(seed)
    want = pow_.grind_host(ch, pow_bits)
    assert want == jax_pow.grind_host(
        JaxChannel(JaxFelt(ch.digest.value)), pow_bits)
    count = max(64, want + 1)
    assert _plain(ch, 0, count, pow_bits) == want
    assert pos.poseidon_grind_batch(ch.digest.value, 0, count, pow_bits,
                                    "cpu") == want


@pytest.mark.parametrize("seed", SEEDS[:2])
def test_plain_scan_from_past_the_first_hit(seed):
    ch = _channel(seed)
    first = pow_.grind_host(ch, 8)
    want = _host_scan(ch, first + 1, 128, 8)
    assert want > first
    assert _plain(ch, first + 1, 128, 8) == want


@pytest.mark.parametrize("start,count,pow_bits", [
    ((1 << 32) - 3, 2, 0),       # the low word wraps between the two
    ((1 << 32) - 1, 96, 8),      # a hit with a high word of 1
    ((7 << 40) + 5, 64, 6),
    (0, 24, 60),                 # no hit: -1
])
def test_plain_scan_near_2_32_equals_a_host_scan(start, count, pow_bits):
    ch = _channel(SEEDS[2])
    want = _host_scan(ch, start, count, pow_bits)
    if pow_bits == 8:
        assert want >= 1 << 32
    if pow_bits == 60:
        assert want == -1
    assert _plain(ch, start, count, pow_bits) == want


@pytest.mark.parametrize("value", [
    0, 1, P252 - 1, 1 << 248, 1 << 251, (1 << 224) - 1, 3 << 224,
    0xFF << 240, 1 << 127, 5 << 200, 0x07 << 248])
def test_trailing_zeros_are_the_channels(value):
    ch = Poseidon252Channel(FieldElement252(value))
    felts = pos.ints_to_felts([value], "cpu")
    assert pos.channel_trailing_zeros(felts).tolist() == \
        [ch.trailing_zeros()]


def test_grind_routes_a_poseidon_channel_through_the_scan(monkeypatch):
    """At pow_bits 12 on a CPU device the grind is batches of the plain
    scan; the nonce is the host's and the channel is left as it was."""
    ch = _channel(SEEDS[1])
    before = ch.clone()
    want = pow_.grind_host(ch, 12)
    calls = []
    scan = pos.poseidon_grind_batch

    def recorded(digest, start, count, pow_bits, device):
        calls.append((digest, start, count, pow_bits, device.type))
        return scan(digest, start, count, pow_bits, device)

    monkeypatch.setattr(pos, "poseidon_grind_batch", recorded)
    assert pow_.grinds_on_device(ch, 12)
    assert pow_.grind(ch, 12, device="cpu") == want
    batch = pow_.GRIND_BATCH_P252_CPU
    assert calls == [(ch.digest.value, k * batch, batch, 12, "cpu")
                     for k in range(want // batch + 1)]
    calls.clear()
    assert pow_.grind_device(ch, 12, "cpu", batch=32) == want
    assert len(calls) == want // 32 + 1
    assert ch == before


def test_grinds_on_device_names_the_routes():
    for cls in (Poseidon252Channel, pow_.Blake2sChannel):
        assert not pow_.grinds_on_device(cls(), pow_.DEVICE_MIN_POW_BITS - 1)
        assert pow_.grinds_on_device(cls(), pow_.DEVICE_MIN_POW_BITS)
    assert not pow_.grinds_on_device(object(), 26)
    with pytest.raises(TypeError):
        pow_.grind_device(object(), 12, "cpu")


def test_counters_of_the_grind_and_the_host_permutations():
    ch = _channel(SEEDS[0])
    want = pow_.grind_host(ch, 10)
    tracing.reset()
    tracing.enable(sync=False)
    try:
        with tracing.request(0):
            assert pow_.grind_device(ch, 10, "cpu", batch=16) == want
            ch.clone().mix_u64(want)  # one sponge of two permutations
        counts = tracing.counts()[0]
    finally:
        tracing.disable()
        tracing.reset()
    assert counts["grind_nonces"] == 16 * (want // 16 + 1)
    assert counts["host_hades"] == 2
    pow_.grind_device(ch, 10, "cpu", batch=16)
    assert tracing.counts() == {}


def test_scan_refuses_bad_arguments():
    with pytest.raises(ValueError):
        pos.poseidon_grind_batch(P252, 0, 4, 1, "cpu")
    with pytest.raises(ValueError):
        pos.poseidon_grind_batch(5, 0, 0, 1, "cpu")
    with pytest.raises(ValueError):
        pos.poseidon_grind_batch(5, (1 << 63) - 2, 4, 1, "cpu")
    with pytest.raises(ValueError):
        pos.poseidon_grind_hit_cuda(5, 0, 8, 1, "cpu")
