"""The port's device-resident Blake2s transcript (channel/device.py, the
lazy device digest of Blake2sChannel) against the JAX package's
(tstwo_tpu/channel/device.py, on JAX's CPU backend), the host channels and
hashlib, exactly (tolerance 0).

Every case feeds the same numpy-seeded state to both packages.  The port's
tensors lie on the CPU, so each function runs the plain version of the
transcript kernel (ops/blake2s.transcript_plain); chip_smoke.py holds the
kernel against that plain version on the card.  The rejecting state (a
zero digest at n_sent 238,210,102, whose draw has word 3 = 0xFFFFFFFE >=
2P) covers the whole-hash rejection in both packages and the host channel.
"""
import hashlib

import numpy as np
import pytest

import jax.numpy as jnp

from tstwo_tpu.channel import ChannelTime as JaxChannelTime
from tstwo_tpu.channel import device as jax_dev
from tstwo_tpu.channel.blake2s import Blake2sChannel as JaxChannel
from tstwo_tpu_torch.channel import ChannelTime
from tstwo_tpu_torch.channel import device as dev
from tstwo_tpu_torch.channel.blake2s import Blake2sChannel
from tstwo_tpu_torch.fields import QM31
from tstwo_tpu_torch.ops import blake2s as b2
from tstwo_tpu_torch.utils import to_numpy_u32, to_torch_u32

P = (1 << 31) - 1
REJECTING = (bytes(32), 238_210_102)  # draw word 3 = 0xFFFFFFFE >= 2P


def _state(seed):
    """(digest bytes, n_sent) from a seed; seed None is the rejecting
    state."""
    if seed is None:
        return REJECTING
    rng = np.random.default_rng(seed)
    digest = rng.integers(0, 256, size=32, dtype=np.uint8).tobytes()
    return digest, int(rng.integers(0, 1 << 20))


def _port(digest, n_sent):
    words = np.frombuffer(digest, dtype="<u4")
    return (to_torch_u32(words),
            to_torch_u32(np.array(dev.n_sent_words(n_sent), np.uint32)))


def _jax(digest, n_sent):
    return (jnp.asarray(np.frombuffer(digest, dtype="<u4").copy()),
            jnp.int32(n_sent))


def _n(port_n_sent):
    lo, hi = to_numpy_u32(port_n_sent).tolist()
    return lo | hi << 32


def _bytes(words):
    return b2.digest_words_to_bytes(np.asarray(words, dtype=np.uint32)
                                    if not hasattr(words, "numpy")
                                    else to_numpy_u32(words))


def _same(port_tensor, jax_array):
    np.testing.assert_array_equal(to_numpy_u32(port_tensor),
                                  np.asarray(jax_array, dtype=np.uint32))


SEEDS = [0, 1, 2, None]


@pytest.mark.parametrize("seed", SEEDS)
def test_mix_root_matches_jax_host_and_hashlib(seed):
    digest, n_sent = _state(seed)
    root = np.random.default_rng(100 if seed is None else seed + 100) \
        .integers(0, 1 << 32, size=8, dtype=np.uint64).astype(np.uint32)
    d, ns = dev.mix_root(_port(digest, n_sent)[0], to_torch_u32(root))
    jd, jns = jax_dev.mix_root(_jax(digest, n_sent)[0], jnp.asarray(root))
    _same(d, jd)
    assert _n(ns) == int(jns) == 0
    host = Blake2sChannel(digest, ChannelTime(0, n_sent))
    host.mix_root(root.tobytes())
    assert _bytes(d) == host.digest == hashlib.blake2s(
        digest + root.tobytes()).digest()


@pytest.mark.parametrize("value", [0, 7, (1 << 32) + 5, (1 << 64) - 1])
@pytest.mark.parametrize("as_words", [False, True])
def test_mix_u64_matches_jax_and_host(value, as_words):
    digest, n_sent = _state(3)
    lo, hi = value & 0xFFFFFFFF, value >> 32
    if as_words:
        arg = to_torch_u32(np.array([lo, hi], np.uint32))
        jarg = (jnp.uint32(lo), jnp.uint32(hi))
    else:
        arg, jarg = value, value
    d, ns = dev.mix_u64(_port(digest, n_sent)[0], arg)
    jd, _ = jax_dev.mix_u64(_jax(digest, n_sent)[0], jarg)
    _same(d, jd)
    assert _n(ns) == 0
    host = Blake2sChannel(digest, ChannelTime(0, n_sent))
    host.mix_u64(value)
    assert _bytes(d) == host.digest


@pytest.mark.parametrize("k", [1, 2, 4])
def test_mix_felts_matches_jax_and_host(k):
    digest, n_sent = _state(4 + k)
    felts = np.random.default_rng(k).integers(0, P, size=(k, 4),
                                              dtype=np.uint32)
    d, ns = dev.mix_felts(_port(digest, n_sent)[0], to_torch_u32(felts))
    jd, _ = jax_dev.mix_felts(_jax(digest, n_sent)[0], jnp.asarray(felts))
    _same(d, jd)
    assert _n(ns) == 0
    host = Blake2sChannel(digest, ChannelTime(0, n_sent))
    host.mix_felts([QM31.from_ints(f.tolist()) for f in felts])
    assert _bytes(d) == host.digest


@pytest.mark.parametrize("seed", SEEDS)
def test_draw_base_felts_and_draw_felt_match_jax_and_host(seed):
    digest, n_sent = _state(seed)
    ns, felts = dev.draw_base_felts(*_port(digest, n_sent))
    jns, jfelts = jax_dev.draw_base_felts(*_jax(digest, n_sent))
    _same(felts, jfelts)
    assert _n(ns) == int(jns)
    ns1, felt = dev.draw_felt(*_port(digest, n_sent))
    jns1, jfelt = jax_dev.draw_felt(*_jax(digest, n_sent))
    _same(felt, jfelt)
    assert _n(ns1) == int(jns1) == _n(ns)
    host = Blake2sChannel(digest, ChannelTime(0, n_sent))
    assert to_numpy_u32(felt).tolist() == list(host.draw_felt().to_ints())
    assert host.channel_time.n_sent == _n(ns)
    assert to_numpy_u32(felts).max() < P


def test_the_rejecting_state_rejects_in_every_implementation():
    """hashlib says the draw at n_sent rejects and the next one holds; the
    port, JAX and both host channels skip it alike."""
    digest, n_sent = REJECTING
    words = [np.frombuffer(hashlib.blake2s(
        digest + n.to_bytes(8, "little") + bytes(24)).digest(), "<u4")
        for n in (n_sent, n_sent + 1)]
    assert words[0].max() >= 2 * P and words[1].max() < 2 * P
    want = np.where(words[1] >= P, words[1] - P, words[1]).tolist()
    ns, felts = dev.draw_base_felts(*_port(digest, n_sent))
    jns, jfelts = jax_dev.draw_base_felts(*_jax(digest, n_sent))
    assert to_numpy_u32(felts).tolist() == np.asarray(jfelts).tolist() == want
    assert _n(ns) == int(jns) == n_sent + 2
    for host in (Blake2sChannel(digest, ChannelTime(0, n_sent)),
                 JaxChannel(digest, JaxChannelTime(0, n_sent))):
        assert [int(x) for x in host.draw_felt().to_ints()] == want[:4]
        assert host.channel_time.n_sent == n_sent + 2
    # and the plain step on a 64-bit count past 2^32
    lo = dev.n_sent_words((1 << 40) + 3)
    _, ns64, _ = b2.transcript_plain(
        to_torch_u32(np.zeros(8, np.uint32)),
        to_torch_u32(np.array(lo, np.uint32)), k=1)
    assert _n(ns64) == (1 << 40) + 4


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("seed", [5, None])
def test_draw_felts_matches_jax_and_host(n, seed):
    digest, n_sent = _state(seed)
    ns, felts = dev.draw_felts(*_port(digest, n_sent), n)
    jns, jfelts = jax_dev.draw_felts(*_jax(digest, n_sent), n)
    assert tuple(felts.shape) == (n, 4)
    _same(felts, jfelts)
    assert _n(ns) == int(jns)
    host = Blake2sChannel(digest, ChannelTime(0, n_sent))
    assert to_numpy_u32(felts).tolist() == [
        list(f.to_ints()) for f in host.draw_felts(n)]
    assert host.channel_time.n_sent == _n(ns)


@pytest.mark.parametrize("seed", [6, None])
def test_state_from_channel_and_sync_host_channel_match_jax(seed):
    digest, n_sent = _state(seed)
    ours = Blake2sChannel(digest, ChannelTime(3, n_sent))
    theirs = JaxChannel(digest, JaxChannelTime(3, n_sent))
    d, ns = dev.state_from_channel(ours, "cpu")
    jd, jns = jax_dev.state_from_channel(theirs)
    _same(d, jd)
    assert _n(ns) == int(jns) == n_sent
    # a mix and two draws on the device, synced back: the host channel's
    # own mix and draws
    root = np.arange(8, dtype=np.uint32) * 0x01010101
    d, ns = dev.mix_root(d, to_torch_u32(root))
    ns, _ = dev.draw_felt(d, ns)
    ns, _ = dev.draw_felt(d, ns)
    jd, jns = jax_dev.mix_root(jd, jnp.asarray(root))
    jns, _ = jax_dev.draw_felt(jd, jns)
    jns, _ = jax_dev.draw_felt(jd, jns)
    dev.sync_host_channel(ours, to_numpy_u32(d), _n(ns), n_mixes=1)
    jax_dev.sync_host_channel(theirs, np.asarray(jd), int(jns), n_mixes=1)
    host = Blake2sChannel(digest, ChannelTime(3, n_sent))
    host.mix_root(root.tobytes())
    host.draw_felt()
    host.draw_felt()
    assert ours == host
    assert ours.digest == theirs.digest
    assert (ours.channel_time.n_challenges, ours.channel_time.n_sent) == (
        theirs.channel_time.n_challenges, theirs.channel_time.n_sent)


def test_state_from_channel_reads_a_device_digest_in_place():
    ch = Blake2sChannel(*_state(7)[:1], ChannelTime(0, 5))
    ch.mix_root_device(to_torch_u32(np.arange(8, dtype=np.uint32)))
    pending = ch._device_digest
    d, ns = dev.state_from_channel(ch)
    assert ch._device_digest is pending  # not fetched
    assert _n(ns) == 0
    assert _bytes(d) == ch.digest


@pytest.mark.parametrize("seed", [8, None])
def test_lazy_device_digest_equals_the_host_mix(seed):
    digest, n_sent = _state(seed)
    root = np.random.default_rng(9).integers(
        0, 1 << 32, size=8, dtype=np.uint64).astype(np.uint32)
    lazy = Blake2sChannel(digest, ChannelTime(2, n_sent))
    host = Blake2sChannel(digest, ChannelTime(2, n_sent))
    jax_lazy = JaxChannel(digest, JaxChannelTime(2, n_sent))
    lazy.mix_root_device(to_torch_u32(root))
    jax_lazy.mix_root_device(jnp.asarray(root))
    host.mix_root(root.tobytes())
    assert lazy._device_digest is not None
    assert lazy.channel_time == host.channel_time
    clone = lazy.clone()  # reads the digest: one fetch, then host bytes
    assert lazy._device_digest is None
    assert clone == lazy == host
    assert lazy.digest == host.digest == jax_lazy.digest
    assert repr(lazy) == repr(host)
    assert lazy.draw_felt() == host.draw_felt()
    assert lazy.channel_time == host.channel_time
    # a second device mix, then a draw straight away
    lazy.mix_root_device(to_torch_u32(root))
    host.mix_root(root.tobytes())
    assert lazy.draw_felt() == host.draw_felt()
    # the setter drops a pending device digest
    lazy.mix_root_device(to_torch_u32(root))
    lazy.digest = host.digest
    assert lazy._device_digest is None and lazy.digest == host.digest


def test_digest_words_device_uploads_or_returns_the_pending_words():
    ch = Blake2sChannel(bytes(range(32)))
    words = ch.digest_words_device("cpu")
    np.testing.assert_array_equal(to_numpy_u32(words),
                                  np.frombuffer(bytes(range(32)), "<u4"))
    ch.mix_root_device(words)
    assert ch.digest_words_device() is ch._device_digest


@pytest.mark.parametrize("msg_bytes", [0, 3, 32, 33, 64, 96, 101])
def test_plain_transcript_mixes_a_message_of_any_length(msg_bytes):
    """The plain step of the kernel: a mix of one or more blocks, the
    bytes past msg_bytes ignored, against hashlib."""
    rng = np.random.default_rng(msg_bytes)
    digest = rng.integers(0, 256, size=32, dtype=np.uint8).tobytes()
    words = rng.integers(0, 1 << 32, size=-(-msg_bytes // 4) + 1,
                         dtype=np.uint64).astype(np.uint32)
    d, ns, draws = b2.transcript_plain(
        to_torch_u32(np.frombuffer(digest, "<u4")), msg=to_torch_u32(words),
        msg_bytes=msg_bytes, k=2)
    want = hashlib.blake2s(digest + words.tobytes()[:msg_bytes]).digest()
    assert _bytes(d) == want
    host = Blake2sChannel(want)
    assert to_numpy_u32(draws).reshape(-1, 4).tolist() == [
        list(f.to_ints()) for f in host.draw_felts(4)]
    assert _n(ns) == host.channel_time.n_sent == 2


def test_transcript_cuda_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        b2.transcript_cuda(to_torch_u32(np.zeros(8, np.uint32)),
                           msg=to_torch_u32(np.zeros(8, np.uint32)))
