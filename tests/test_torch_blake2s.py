"""Blake2s and Merkle parity of the PyTorch port (tolerance 0).

The port's plain batched Blake2s (the CPU path, and the version its CUDA
kernel csrc/blake2s.cu is held against on the card) must equal hashlib and
the JAX Pallas kernel run in interpret mode; Merkle layers, roots and
decommitments must equal the JAX MerkleProver's.
"""
import hashlib

import numpy as np
import pytest

import jax.numpy as jnp

from tstwo_tpu.channel.blake2s import Blake2sChannel as JaxChannel
from tstwo_tpu.fields import QM31 as JaxQM31
from tstwo_tpu.ops import blake2s as jax_blake2s
from tstwo_tpu.vcs import MerkleProver as JaxMerkleProver
from tstwo_tpu.vcs import MerkleVerifier as JaxMerkleVerifier
from tstwo_tpu_torch.channel.blake2s import Blake2sChannel
from tstwo_tpu_torch.fields import QM31
from tstwo_tpu_torch.ops import blake2s
from tstwo_tpu_torch.utils import to_numpy_u32, to_torch_u32
from tstwo_tpu_torch.vcs import MerkleProver, MerkleVerifier

P = (1 << 31) - 1


def _messages(seed, byte_len, n):
    n_words = -(-byte_len // 4)
    words = np.random.default_rng(seed).integers(
        0, 1 << 32, size=(n_words, n), dtype=np.uint64).astype(np.uint32)
    if byte_len % 4:  # keep the bytes past byte_len zero (API contract)
        words[-1] &= np.uint32((1 << (8 * (byte_len % 4))) - 1)
    return words


@pytest.mark.parametrize("byte_len", [32, 64, 128, 200])
def test_plain_hash_matches_hashlib_and_pallas(byte_len):
    n = 2048
    words = _messages(byte_len, byte_len, n)
    got = to_numpy_u32(blake2s.hash_words_major(to_torch_u32(words),
                                                byte_len))
    assert got.shape == (8, n)
    total = max(1, -(-byte_len // 64)) * 16
    padded = np.zeros((total, n), dtype=np.uint32)
    padded[:words.shape[0]] = words
    want = np.asarray(jax_blake2s._hash_words_major_pallas(
        jnp.asarray(padded), byte_len, interpret=True))
    np.testing.assert_array_equal(got, want)
    for c in (0, 1, n // 2, n - 1):
        msg = words[:, c].astype("<u4").tobytes()[:byte_len]
        assert blake2s.digest_words_to_bytes(got[:, c]) == \
            hashlib.blake2s(msg).digest()


def test_plain_hash_of_empty_messages():
    got = to_numpy_u32(blake2s.hash_words_major(
        to_torch_u32(np.zeros((0, 4), np.uint32)), 0))
    for c in range(4):
        assert blake2s.digest_words_to_bytes(got[:, c]) == \
            hashlib.blake2s(b"").digest()


def test_digest_word_conversions_roundtrip():
    d = hashlib.blake2s(b"tstwo").digest()
    words = blake2s.digest_bytes_to_words(d)
    assert blake2s.digest_words_to_bytes(words) == d
    as_int32 = to_torch_u32(words).tolist()
    assert blake2s.digest_words_to_bytes(as_int32) == d


def test_cuda_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        blake2s.hash_words_major_cuda(
            to_torch_u32(np.zeros((16, 8), np.uint32)), 64)


# ---------------------------------------------------------------------------
# Merkle trees
# ---------------------------------------------------------------------------

LOG_SIZES = [7, 7, 5, 5, 5, 3, 0]


def _columns(seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, P, size=1 << ls, dtype=np.uint32)
            for ls in LOG_SIZES]


QUERIES = {7: [0, 5, 6, 100, 127], 5: [3, 17], 3: [7], 0: [0]}


@pytest.mark.parametrize("stacked", [False, True])
def test_merkle_layers_root_and_decommitment_match_jax(stacked):
    cols = _columns(3)
    if stacked:  # same-size columns as one [C, n] entry, as FRI commits
        port_cols = [to_torch_u32(np.stack(cols[:2])),
                     to_torch_u32(np.stack(cols[2:5]))] + \
            [to_torch_u32(c) for c in cols[5:]]
    else:
        port_cols = [to_torch_u32(c) for c in cols]
    jax_cols = [jnp.asarray(c) for c in cols]
    port = MerkleProver.commit(port_cols)
    jax_tree = JaxMerkleProver.commit(jax_cols)
    assert len(port.layers) == len(jax_tree.layers)
    for a, b in zip(port.layers, jax_tree.layers):
        np.testing.assert_array_equal(to_numpy_u32(a), np.asarray(b))
    assert port.root() == jax_tree.root()

    values, dec = port.decommit(QUERIES, port_cols)
    jvalues, jdec = jax_tree.decommit(QUERIES, jax_cols)
    assert [v.value for v in values] == [v.value for v in jvalues]
    assert dec.hash_witness == jdec.hash_witness
    assert [v.value for v in dec.column_witness] == \
        [v.value for v in jdec.column_witness]
    # each package's verifier accepts the other's opening
    MerkleVerifier(jax_tree.root(), LOG_SIZES).verify(QUERIES, jvalues, jdec)
    JaxMerkleVerifier(port.root(), LOG_SIZES).verify(QUERIES, values, dec)


def test_merkle_of_no_columns_matches_jax():
    assert MerkleProver.commit([]).root() == JaxMerkleProver.commit([]).root()


def test_channel_transcript_matches_jax():
    ours, theirs = Blake2sChannel(), JaxChannel()
    for ch, q in ((ours, QM31), (theirs, JaxQM31)):
        ch.mix_u64(0x1234_5678_9ABC)
        ch.mix_root(hashlib.blake2s(b"root").digest())
        ch.mix_felts([q.from_ints([1, 2, 3, P - 1])])
    assert ours.digest == theirs.digest
    assert ours.draw_felt().to_ints() == theirs.draw_felt().to_ints()
    assert ours.draw_random_bytes() == theirs.draw_random_bytes()
    assert ours.trailing_zeros() == theirs.trailing_zeros()
