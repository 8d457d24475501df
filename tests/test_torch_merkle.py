"""Merkle commit parity of the PyTorch port (tolerance 0), on the CPU.

`MerkleProver.commit` of the port goes layer by layer through
`ops/blake2s.merkle_layer` and finishes with one `merkle_tail` for the
layers of at most 2^TAIL_LOG nodes.  Here both take their plain versions
(the ones the CUDA kernels of csrc/blake2s.cu are held against on the
card); every layer and the root must equal the JAX MerkleProver's, the
openings must verify, and a single layer must equal the JAX package's
`commit_on_layer`, its Pallas kernel in interpret mode, and hashlib node
by node.  Inputs come from a numpy seed.
"""
import hashlib

import numpy as np
import pytest

import jax.numpy as jnp

from tstwo_tpu.ops import blake2s as jax_blake2s
from tstwo_tpu.vcs import MerkleProver as JaxMerkleProver
from tstwo_tpu.vcs import MerkleVerifier as JaxMerkleVerifier
from tstwo_tpu.vcs.blake2s_merkle import commit_on_layer as jax_commit_on_layer
from tstwo_tpu_torch.ops import blake2s
from tstwo_tpu_torch.ops.blake2s import TAIL_LOG
from tstwo_tpu_torch.utils import to_numpy_u32, to_torch_u32
from tstwo_tpu_torch.vcs import MerkleProver, MerkleVerifier
from tstwo_tpu_torch.vcs.blake2s_merkle import commit_on_layer

P = (1 << 31) - 1
T = TAIL_LOG

# name -> entries of one commit: (log size, columns) with columns 0 for a
# single column [n] and C >= 1 for a stack [C, n]
TREES = {
    "one_stack": [(6, 4)],
    "single_columns": [(5, 0), (5, 0), (5, 0)],
    "mixed_entries": [(6, 0), (6, 3), (6, 0), (6, 1)],
    # node layers that take in columns: 68 and 80-byte two-block messages
    "mixed_sizes": [(7, 2), (6, 0), (4, 4), (7, 0), (2, 0), (0, 0)],
    "columns_below_tail": [(T + 2, 1), (3, 2), (1, 0)],
    "log_0": [(0, 3)],
    "log_1": [(1, 0)],
    "log_T-1": [(T - 1, 2)],
    "log_T": [(T, 0)],
    "log_T+1": [(T + 1, 4)],
    "log_T+2": [(T + 2, 0)],
    # leaf messages of 4 ... 256 bytes: 1 ... 64 columns
    **{f"leaf_{4 * c}B": [(5, c)] for c in (1, 4, 15, 16, 17, 32, 33, 64)},
    # node messages of 64 + 4 ... 64 + 68 bytes
    **{f"node_{64 + 4 * c}B": [(5, 1), (4, c)] for c in (1, 15, 16, 17)},
}


def _entries(name):
    """The numpy columns of TREES[name], entry by entry."""
    rng = np.random.default_rng(sorted(TREES).index(name))
    return [rng.integers(0, P, size=((1 << log) if c == 0 else (c, 1 << log)),
                         dtype=np.uint32) for log, c in TREES[name]]


def _flat(entries):
    """The single columns of a list of entries, in order."""
    return [col for e in entries for col in (e if e.ndim == 2 else [e])]


def _queries(entries):
    """A few positions per column size, first and last among them."""
    out = {}
    for e in entries:
        n = e.shape[-1]
        out[n.bit_length() - 1] = sorted({0, n // 3, n // 2, n - 1})
    return out


@pytest.mark.parametrize("name", sorted(TREES))
def test_commit_layers_and_root_match_jax(name):
    entries = _entries(name)
    port = MerkleProver.commit([to_torch_u32(e) for e in entries])
    jax_tree = JaxMerkleProver.commit([jnp.asarray(c) for c in _flat(entries)])
    assert len(port.layers) == len(jax_tree.layers)
    for log, (a, b) in enumerate(zip(port.layers, jax_tree.layers)):
        assert tuple(a.shape) == (8, 1 << log)
        np.testing.assert_array_equal(to_numpy_u32(a), np.asarray(b))
    assert port.root() == jax_tree.root()


@pytest.mark.parametrize("name", sorted(TREES))
def test_decommit_verifies_and_matches_jax(name):
    entries = _entries(name)
    port_cols = [to_torch_u32(e) for e in entries]
    jax_cols = [jnp.asarray(c) for c in _flat(entries)]
    queries = _queries(entries)
    log_sizes = [c.shape[-1].bit_length() - 1 for c in _flat(entries)]
    port = MerkleProver.commit(port_cols)
    values, dec = port.decommit(queries, port_cols)
    jvalues, jdec = JaxMerkleProver.commit(jax_cols).decommit(queries,
                                                              jax_cols)
    assert [v.value for v in values] == [v.value for v in jvalues]
    assert dec.hash_witness == jdec.hash_witness
    assert [v.value for v in dec.column_witness] == \
        [v.value for v in jdec.column_witness]
    MerkleVerifier(port.root(), log_sizes).verify(queries, values, dec)
    JaxMerkleVerifier(port.root(), log_sizes).verify(queries, values, dec)


def test_empty_commit_matches_jax_and_hashlib():
    port = MerkleProver.commit([], "cpu")
    with pytest.raises(ValueError, match="needs its device"):
        MerkleProver.commit([])
    assert port.root() == JaxMerkleProver.commit([]).root()
    assert port.root() == hashlib.blake2s(b"").digest()
    assert [tuple(layer.shape) for layer in port.layers] == [(8, 1)]


def test_tail_layers_are_the_layer_loop():
    prev = to_torch_u32(np.random.default_rng(5).integers(
        0, 1 << 32, size=(8, 1 << 6), dtype=np.uint64).astype(np.uint32))
    tail = blake2s.merkle_tail(prev)
    assert [tuple(t.shape) for t in tail] == [(8, 1 << j)
                                              for j in range(5, -1, -1)]
    for layer in tail:
        prev = blake2s.merkle_layer(prev, [])
        assert (layer == prev).all()


@pytest.mark.parametrize("log,n_cols,with_prev", [
    (4, 0, True), (4, 1, True), (3, 17, True), (4, 1, False), (4, 15, False),
    (3, 16, False), (3, 33, False), (0, 2, True), (0, 0, True)])
def test_layer_plain_matches_jax_pallas_and_hashlib(log, n_cols, with_prev):
    rng = np.random.default_rng(100 * log + n_cols)
    n = 1 << log
    prev = rng.integers(0, 1 << 32, size=(8, 2 * n), dtype=np.uint64) \
        .astype(np.uint32) if with_prev else None
    cols = [rng.integers(0, P, size=n, dtype=np.uint32)
            for _ in range(n_cols)]
    # half of the columns as one stack, the rest single
    entries = ([np.stack(cols[:n_cols // 2])] if n_cols >= 2 else []) + \
        cols[n_cols // 2 if n_cols >= 2 else 0:]
    got = to_numpy_u32(blake2s.merkle_layer_plain(
        None if prev is None else to_torch_u32(prev),
        [to_torch_u32(e) for e in entries]))
    via_vcs = to_numpy_u32(commit_on_layer(
        log, None if prev is None else to_torch_u32(prev),
        [to_torch_u32(e) for e in entries]))
    np.testing.assert_array_equal(got, via_vcs)

    want = np.asarray(jax_commit_on_layer(
        log, None if prev is None else jnp.asarray(prev),
        [jnp.asarray(c) for c in cols]))
    np.testing.assert_array_equal(got, want)

    # the message words, as the JAX package hands them to its Pallas kernel
    words = np.concatenate(
        ([prev[:, 0::2], prev[:, 1::2]] if with_prev else [])
        + [c[None, :] for c in cols])
    byte_len = 4 * words.shape[0]
    lanes = 128  # the kernel's tiling: whole 16-word blocks, N % 128 == 0
    padded = np.zeros((max(1, -(-byte_len // 64)) * 16, lanes), np.uint32)
    padded[:words.shape[0], :n] = words
    pallas = np.asarray(jax_blake2s._hash_words_major_pallas(
        jnp.asarray(padded), byte_len, interpret=True))[:, :n]
    np.testing.assert_array_equal(got, pallas)

    for i in range(n):
        msg = words[:, i].astype("<u4").tobytes()
        assert blake2s.digest_words_to_bytes(got[:, i]) == \
            hashlib.blake2s(msg).digest()


def test_cuda_wrappers_refuse_cpu_tensors():
    prev = to_torch_u32(np.zeros((8, 4), np.uint32))
    with pytest.raises(ValueError, match="CUDA"):
        blake2s.merkle_layer_cuda(prev, [])
    with pytest.raises(ValueError, match="CUDA"):
        blake2s.merkle_tail_cuda(prev)


def test_plain_hash_refuses_more_words_than_its_blocks():
    with pytest.raises(ValueError, match="more words"):
        blake2s.hash_words_major_plain(
            to_torch_u32(np.zeros((17, 2), np.uint32)), 64)
