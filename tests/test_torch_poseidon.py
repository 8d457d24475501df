"""Poseidon252 parity of the PyTorch port on the CPU (tolerance 0).

The port's host channel (channel/poseidon.py) against the JAX package's,
call for call, and against the stwo values the JAX package's tests pin;
the plain felt252 arithmetic of ops/poseidon252.py (the versions the CUDA
kernels of csrc/poseidon252.cu are held against on the card) against the
JAX package's limb arithmetic run eagerly and against Python integers;
the plain Hades permutation and sponge against the host's Python-int
Hades, which the JAX package's device Hades is pinned to.  Inputs come
from a numpy seed; felts cross as Python ints (`ints_to_felts`,
`felts_to_ints` here, `ints_to_limb_array`, `limb_array_to_ints` there).
"""
import jax.numpy as jnp
import numpy as np
import pytest

from tstwo_tpu.channel import poseidon as jax_channel
from tstwo_tpu.fields import QM31 as JaxQM31
from tstwo_tpu.ops import poseidon252 as jax_pos
from tstwo_tpu_torch.channel import poseidon as channel
from tstwo_tpu_torch.channel.logging import LoggingChannel
from tstwo_tpu_torch.fields import M31, QM31
from tstwo_tpu_torch.ops import poseidon252 as pos
from tstwo_tpu_torch.proof_of_work import grind_host
from tstwo_tpu_torch.utils import to_numpy_u32, to_torch_u32
from tstwo_tpu_torch.vcs.poseidon252_merkle import (
    Poseidon252MerkleChannel, construct_felt252_from_m31s, hash_node)

P = channel.P252
M31_P = (1 << 31) - 1
EDGE = [0, 1, 2, P - 1, P - 2, 1 << 251, (1 << 251) - 1, 17 << 192,
        (1 << 224) - 1, 1 << 224, (1 << 32) - 1, 1 << 32]


def _felts(rng, n):
    """n ints below p from the generator."""
    return [int.from_bytes(rng.bytes(32), "little") % P for _ in range(n)]


def _qm31s(rng, n, cls):
    vals = rng.integers(0, M31_P, size=(n, 4), dtype=np.uint32)
    return [cls.from_ints([int(x) for x in row]) for row in vals]


# ---------------------------------------------------------------------------
# (a) the host channel, call for call
# ---------------------------------------------------------------------------

def test_constants_match_jax():
    assert channel.P252 == jax_channel.P252
    assert channel._ARK == jax_channel._ARK
    assert len(channel._ARK) == 91 and len(channel._ARK[0]) == 3


def test_pinned_hash_node_values():
    """stwo's values, as tests/test_poseidon.py pins them."""
    assert hash_node(None, [M31(0), M31(1)]).value == \
        2552053700073128806553921687214114320458351061521275103654266875084493044716
    assert hash_node((channel.FieldElement252(1), channel.FieldElement252(2)),
                     [M31(3)]).value == \
        159358216886023795422515519110998391754567506678525778721401012606792642769


def test_pinned_mix_u32s_digest():
    ch = channel.Poseidon252Channel()
    ch.mix_u32s([1, 2, 3, 4, 5, 6, 7, 8, 9])
    assert ch.digest.value == int(
        "0x078f5cf6a2e7362b75fc1f94daeae7ebddd64e6b2db771717519af7193dfa80b", 16)


def test_channel_time_semantics():
    ch = channel.Poseidon252Channel()
    ch.draw_random_bytes()
    assert (ch.channel_time.n_challenges, ch.channel_time.n_sent) == (0, 1)
    ch.draw_felts(9)
    assert (ch.channel_time.n_challenges, ch.channel_time.n_sent) == (0, 6)
    ch.mix_u64(3)
    assert (ch.channel_time.n_challenges, ch.channel_time.n_sent) == (1, 0)


@pytest.mark.parametrize("seed", range(3))
def test_host_hades_and_hashes_match_jax(seed):
    rng = np.random.default_rng(seed)
    state = _felts(rng, 3)
    assert channel.hades_permutation(state) == \
        jax_channel.hades_permutation(state)
    assert channel.poseidon_hash(*state[:2]) == \
        jax_channel.poseidon_hash(*state[:2])
    for k in range(6):
        vals = _felts(rng, k)
        assert channel.poseidon_hash_many(vals) == \
            jax_channel.poseidon_hash_many(vals)


# one step of a transcript: name -> (apply to both channels, compare)
def _mix_root(rng, ours, theirs):
    v = _felts(rng, 1)[0]
    ours.mix_root(channel.FieldElement252(v))
    theirs.mix_root(jax_channel.FieldElement252(v))


def _mix_u32s(rng, ours, theirs):
    data = [int(x) for x in rng.integers(0, 1 << 32, size=rng.integers(0, 17),
                                         dtype=np.uint64)]
    ours.mix_u32s(data)
    theirs.mix_u32s(data)


def _mix_u64(rng, ours, theirs):
    v = int(rng.integers(0, 1 << 63, dtype=np.uint64)) * 2 + 1
    ours.mix_u64(v)
    theirs.mix_u64(v)


def _mix_felts(rng, ours, theirs):
    n = int(rng.integers(0, 6))
    seed = int(rng.integers(0, 1 << 30))
    ours.mix_felts(_qm31s(np.random.default_rng(seed), n, QM31))
    theirs.mix_felts(_qm31s(np.random.default_rng(seed), n, JaxQM31))


def _draw_felt(rng, ours, theirs):
    assert ours.draw_felt().to_ints() == theirs.draw_felt().to_ints()


def _draw_felts(rng, ours, theirs):
    n = int(rng.integers(0, 11))
    assert [f.to_ints() for f in ours.draw_felts(n)] == \
        [f.to_ints() for f in theirs.draw_felts(n)]


def _draw_random_bytes(rng, ours, theirs):
    assert ours.draw_random_bytes() == theirs.draw_random_bytes()


def _trailing_zeros(rng, ours, theirs):
    assert ours.trailing_zeros() == theirs.trailing_zeros()


STEPS = {f.__name__[1:]: f for f in (
    _mix_root, _mix_u32s, _mix_u64, _mix_felts, _draw_felt, _draw_felts,
    _draw_random_bytes, _trailing_zeros)}


def _same_state(ours, theirs):
    assert ours.digest.value == theirs.digest.value
    assert (ours.channel_time.n_challenges, ours.channel_time.n_sent) == \
        (theirs.channel_time.n_challenges, theirs.channel_time.n_sent)


@pytest.mark.parametrize("name", sorted(STEPS))
def test_channel_call_matches_jax(name):
    """Each call alone, from a fresh channel and from a mixed one."""
    rng = np.random.default_rng(sorted(STEPS).index(name))
    for warm in (False, True):
        ours = channel.Poseidon252Channel()
        theirs = jax_channel.Poseidon252Channel()
        if warm:
            _mix_u32s(rng, ours, theirs)
            _draw_felt(rng, ours, theirs)
        for _ in range(3):
            STEPS[name](rng, ours, theirs)
            _same_state(ours, theirs)


@pytest.mark.parametrize("seed", range(4))
def test_channel_transcript_matches_jax(seed):
    """A random transcript of 25 calls; state compared after each."""
    rng = np.random.default_rng(100 + seed)
    ours = channel.Poseidon252Channel()
    theirs = jax_channel.Poseidon252Channel()
    names = sorted(STEPS)
    for _ in range(25):
        STEPS[names[int(rng.integers(0, len(names)))]](rng, ours, theirs)
        _same_state(ours, theirs)
    clone = ours.clone()
    clone.mix_u64(1)
    assert clone.digest != ours.digest


def test_merkle_channel_and_logging_channel_wrap_the_poseidon_channel():
    plain, logged = channel.Poseidon252Channel(), LoggingChannel(
        channel.Poseidon252Channel())
    root = channel.FieldElement252(12345)
    Poseidon252MerkleChannel.mix_root(plain, root)
    logged.mix_root(root)
    plain.mix_u64(7)
    logged.mix_u64(7)
    assert logged.draw_felt() == plain.draw_felt()
    assert logged.digest == plain.digest
    assert [e["op"] for e in logged.log] == ["mix_root", "mix_u64",
                                             "draw_felt"]


@pytest.mark.parametrize("pow_bits", [0, 3, 5])
def test_grind_takes_a_poseidon_channel(pow_bits):
    ours, theirs = channel.Poseidon252Channel(), \
        jax_channel.Poseidon252Channel()
    for ch in (ours, theirs):
        ch.mix_u64(pow_bits + 11)
    from tstwo_tpu.proof_of_work import grind as jax_grind

    nonce = grind_host(ours, pow_bits)
    assert nonce == jax_grind(theirs, pow_bits)
    ours.mix_u64(nonce)
    assert ours.trailing_zeros() >= pow_bits


def test_field_element_252_matches_jax():
    rng = np.random.default_rng(9)
    for a, b in zip(EDGE + _felts(rng, 8), reversed(EDGE + _felts(rng, 8))):
        fa, fb = channel.FieldElement252(a), channel.FieldElement252(b)
        ja, jb = jax_channel.FieldElement252(a), jax_channel.FieldElement252(b)
        assert (fa + fb).value == (ja + jb).value == (a + b) % P
        assert (fa - fb).value == (ja - jb).value == (a - b) % P
        assert (fa * fb).value == (ja * jb).value == (a * b) % P
        assert fa.to_bytes_be() == ja.to_bytes_be()
        assert fa.try_into_u32() == ja.try_into_u32()
    assert channel.FieldElement252.from_int(P + 7).value == 7


@pytest.mark.parametrize("n", [0, 1, 63, 64, 65, 1023, 1024, 1025, 3079])
def test_blake3_matches_jax(n):
    """vcs/blake3.py, the other host module of the flavours' surface."""
    from tstwo_tpu.vcs import blake3 as jax_blake3
    from tstwo_tpu_torch.vcs import blake3

    data = np.random.default_rng(n).bytes(n)
    assert blake3.blake3(data) == jax_blake3.blake3(data)
    assert blake3.concat_and_hash(data, b"x") == blake3.blake3(data + b"x")
    if n == 0:
        assert blake3.blake3(b"").hex() == (
            "af1349b9f5f9a1a6a0404dea36dcc9499bcb25c9adc112b7cc9a93cae41f3262")


# ---------------------------------------------------------------------------
# (b) plain felt arithmetic against the JAX limbs (eager) and Python ints
# ---------------------------------------------------------------------------

def _operands(seed):
    """Pairs that cover 0, 1, p-1, sums and differences that wrap, and
    random values."""
    rng = np.random.default_rng(seed)
    a = EDGE + list(reversed(EDGE)) + _felts(rng, 16)
    b = EDGE + EDGE + _felts(rng, 16)
    return a, b


def _jax(vals):
    return jnp.asarray(jax_pos.ints_to_limb_array(vals))


def test_converters_roundtrip_and_refuse_out_of_range():
    vals = EDGE + _felts(np.random.default_rng(0), 5)
    felts = pos.ints_to_felts(vals, "cpu")
    assert tuple(felts.shape) == (8, len(vals))
    assert pos.felts_to_ints(felts) == vals
    assert jax_pos.limb_array_to_ints(jax_pos.ints_to_limb_array(vals)) == vals
    words = to_numpy_u32(felts)
    assert int(words[7, 3]) == (P - 1) >> 224 and int(words[0, 3]) == 0
    for bad in (P, -1, 1 << 256):
        with pytest.raises(ValueError, match="out of range"):
            pos.ints_to_felts([bad], "cpu")


@pytest.mark.parametrize("op", ["add", "sub"])
def test_plain_add_sub_match_jax_limbs(op):
    """Against Python ints on every pair, and against the JAX limbs on the
    pairs whose sum fits their 252 bits (see the next test)."""
    a, b = _operands(1)
    got = pos.felts_to_ints(getattr(pos, op)(pos.ints_to_felts(a, "cpu"),
                                             pos.ints_to_felts(b, "cpu")))
    assert got == [(x + y) % P if op == "add" else (x - y) % P
                   for x, y in zip(a, b)]
    fits = [i for i, (x, y) in enumerate(zip(a, b))
            if (x + y if op == "add" else x + P - y) < 1 << 252]
    assert len(fits) > len(a) // 2
    want = jax_pos.limb_array_to_ints(getattr(jax_pos, op)(
        _jax([a[i] for i in fits]), _jax([b[i] for i in fits])))
    assert [got[i] for i in fits] == want


def test_add_keeps_the_carry_the_jax_limbs_drop():
    """The JAX package's `add` loses the carry out of its 21 limbs when
    a + b >= 2^252 (both operands within 17 * 2^192 of p: a 2^-55 share of
    random pairs), and `sub` with it.  The port's results are the
    integers', which the host's Hades, the verifier's oracle, computes."""
    a, b = [P - 1, P - 2, P - 1], [P - 1, P - 1, 0]
    fa, fb = pos.ints_to_felts(a, "cpu"), pos.ints_to_felts(b, "cpu")
    assert pos.felts_to_ints(pos.add(fa, fb))[:2] == [P - 2, P - 3]
    assert pos.felts_to_ints(pos.sub(fa, fb))[2] == P - 1
    assert jax_pos.limb_array_to_ints(jax_pos.add(_jax(a[:2]), _jax(b[:2]))) \
        != [P - 2, P - 3]


def test_plain_product_matches_jax_montgomery_and_ints():
    a, b = _operands(2)
    got = pos.felts_to_ints(pos.mul(pos.ints_to_felts(a, "cpu"),
                                    pos.ints_to_felts(b, "cpu")))
    assert got == [(x * y) % P for x, y in zip(a, b)]
    # a b through the JAX package's Montgomery product (radix 2^252)
    via_jax = jax_pos.from_mont(jax_pos.mont_mul(jax_pos.to_mont(_jax(a)),
                                                 jax_pos.to_mont(_jax(b))))
    assert got == jax_pos.limb_array_to_ints(via_jax)


def test_plain_product_at_the_final_subtraction():
    """Operands whose Montgomery result lands in [p, 2p) before the last
    conditional subtraction, and products with 0, 1 and p - 1."""
    a = [P - 1, P - 1, P - 2, 1 << 251, (1 << 251) + 5, 1, 0, P - 1]
    b = [P - 1, P - 2, P - 2, 1 << 251, (1 << 251) - 9, P - 1, P - 1, 1]
    got = pos.felts_to_ints(pos.mul(pos.ints_to_felts(a, "cpu"),
                                    pos.ints_to_felts(b, "cpu")))
    assert got == [(x * y) % P for x, y in zip(a, b)]


@pytest.mark.parametrize("seed", range(2))
def test_pack_m31_columns_matches_jax_and_host(seed):
    rng = np.random.default_rng(seed)
    cols = rng.integers(0, M31_P, size=(8, 12), dtype=np.uint32)
    cols[:, 0] = 0
    cols[:, 1] = M31_P - 1
    cols[:, 2] = [0, M31_P - 1] * 4
    got = pos.felts_to_ints(pos.pack_m31_columns(to_torch_u32(cols)))
    want = jax_pos.limb_array_to_ints(
        jax_pos.pack_m31_columns(jnp.asarray(cols)))
    assert got == want
    assert got == [construct_felt252_from_m31s([M31(int(v)) for v in col])
                   for col in cols.T]
    with pytest.raises(ValueError, match="8 M31 rows"):
        pos.pack_m31_columns(to_torch_u32(cols[:7]))


# ---------------------------------------------------------------------------
# (c) plain Hades and sponge against the host's Python-int Hades
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("batch", [1, 37])
def test_plain_hades_matches_host(batch):
    rng = np.random.default_rng(batch)
    states = [_felts(rng, 3) for _ in range(batch)]
    states[0] = [0, 0, 0]
    if batch > 3:
        states[1] = [P - 1, P - 1, P - 1]
        states[2] = [1, 0, P - 1]
    felts = [pos.ints_to_felts([s[k] for s in states], "cpu")
             for k in range(3)]
    out = pos.hades_permutation(felts)
    assert [tuple(o.shape) for o in out] == [(8, batch)] * 3
    got = list(zip(*(pos.felts_to_ints(o) for o in out)))
    assert got == [tuple(jax_channel.hades_permutation(s)) for s in states]
    # one [3, 8, n] tensor is taken as well
    import torch

    again = pos.hades_permutation_plain(torch.stack(felts))
    assert all(torch.equal(x, y) for x, y in zip(again, out))


@pytest.mark.parametrize("batch", [1, 37])
@pytest.mark.parametrize("n_inputs", [1, 2, 3, 4, 5])
def test_plain_poseidon_hash_many_matches_host(n_inputs, batch):
    rng = np.random.default_rng(10 * n_inputs + batch)
    rows = [_felts(rng, n_inputs) for _ in range(batch)]
    cols = [pos.ints_to_felts([r[k] for r in rows], "cpu")
            for k in range(n_inputs)]
    got = pos.felts_to_ints(pos.poseidon_hash_many(cols))
    assert got == [jax_channel.poseidon_hash_many(r) for r in rows]


def test_hash_many_and_state_shapes_are_checked():
    with pytest.raises(ValueError, match="at least one"):
        pos.poseidon_hash_many([])
    with pytest.raises(ValueError, match="three"):
        pos.hades_permutation_plain([pos.ints_to_felts([1], "cpu")] * 2)


def test_cuda_wrappers_refuse_cpu_tensors():
    felts = pos.ints_to_felts([1, 2], "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        pos.hades_permutation_cuda([felts] * 3)
    with pytest.raises(ValueError, match="CUDA"):
        pos.merkle_layer_cuda(pos.ints_to_felts([1, 2, 3, 4], "cpu"), [])
    with pytest.raises(ValueError, match="CUDA"):
        pos.merkle_layer_cuda(None, [], 2, "cpu")
