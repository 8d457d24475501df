"""Poseidon252 Merkle commit parity of the PyTorch port (tolerance 0), on
the CPU.

`Poseidon252MerkleProver.commit` of the port hashes every layer through
`ops/poseidon252.merkle_layer`, here its plain version (the one the CUDA
layer kernel of csrc/poseidon252.cu is held against on the card).  Every
layer and the root must equal the JAX Poseidon252MerkleProver's, the
openings must be equal and verify under both packages' verifiers with the
host `hash_node`, and a tampered value must be refused.  All trees stay
below 256 nodes a layer, where the JAX prover hashes on the host with
Python-int Hades (its jitted device path costs minutes to compile and is
pinned to the same Hades by the JAX package's own tests).  Inputs come
from a numpy seed.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from tstwo_tpu.channel.poseidon import FieldElement252 as JaxFelt
from tstwo_tpu.ops import poseidon252 as jax_pos
from tstwo_tpu.vcs.poseidon252_merkle import \
    Poseidon252MerkleProver as JaxProver
from tstwo_tpu.vcs.poseidon252_merkle import hash_node as jax_hash_node
from tstwo_tpu.vcs.verifier import MerkleVerifier as JaxMerkleVerifier
from tstwo_tpu_torch.channel.poseidon import FieldElement252
from tstwo_tpu_torch.fields import M31
from tstwo_tpu_torch.ops import poseidon252 as pos
from tstwo_tpu_torch.utils import to_torch_u32
from tstwo_tpu_torch.vcs import MerkleVerificationError, MerkleVerifier
from tstwo_tpu_torch.vcs.ops import MERKLE_OPS
from tstwo_tpu_torch.vcs.poseidon252_merkle import (Poseidon252MerkleProver,
                                                    hash_node)

P = (1 << 31) - 1

# name -> entries of one commit: (log size, columns) with columns 0 for a
# single column [n] and C >= 1 for a stack [C, n]
TREES = {
    "one_size": [(5, 0), (5, 0), (5, 0)],
    "mixed_sizes": [(5, 0), (3, 0), (5, 0)],
    "9_columns": [(4, 0)] * 9,
    "17_columns": [(3, 0)] * 17,
    "stack": [(4, 4)],
    "stack_joins_below_single_columns": [(4, 0), (2, 4), (4, 3), (0, 0)],
}


def _entries(name):
    rng = np.random.default_rng(sorted(TREES).index(name))
    return [rng.integers(0, P, size=((1 << log) if c == 0 else (c, 1 << log)),
                         dtype=np.uint32) for log, c in TREES[name]]


def _flat(entries):
    return [col for e in entries for col in (e if e.ndim == 2 else [e])]


def _queries(entries):
    out = {}
    for e in entries:
        n = e.shape[-1]
        out[n.bit_length() - 1] = sorted({0, n // 3, n - 1})
    return out


@pytest.fixture(scope="module")
def trees():
    """name -> (entries, port columns, port tree, JAX columns, JAX tree),
    each committed once."""
    cache = {}

    def get(name):
        if name not in cache:
            entries = _entries(name)
            port_cols = [to_torch_u32(e) for e in entries]
            jax_cols = [jnp.asarray(c) for c in _flat(entries)]
            cache[name] = (entries, port_cols,
                           Poseidon252MerkleProver.commit(port_cols),
                           jax_cols, JaxProver.commit(jax_cols))
        return cache[name]

    return get


@pytest.mark.parametrize("name", sorted(TREES))
def test_commit_layers_and_root_match_jax(trees, name):
    _, _, port, _, jax_tree = trees(name)
    assert len(port.layers) == len(jax_tree.layers)
    for log, (a, b) in enumerate(zip(port.layers, jax_tree.layers)):
        assert tuple(a.shape) == (8, 1 << log)
        assert pos.felts_to_ints(a) == jax_pos.limb_array_to_ints(b)
    assert isinstance(port.root(), FieldElement252)
    assert port.root().value == jax_tree.root().value


@pytest.mark.parametrize("name", sorted(TREES))
def test_decommit_matches_jax_and_verifies_under_both(trees, name):
    entries, port_cols, port, jax_cols, jax_tree = trees(name)
    queries = _queries(entries)
    log_sizes = [c.shape[-1].bit_length() - 1 for c in _flat(entries)]
    values, dec = port.decommit(queries, port_cols)
    jvalues, jdec = jax_tree.decommit(queries, jax_cols)
    assert [v.value for v in values] == [v.value for v in jvalues]
    assert [h.value for h in dec.hash_witness] == \
        [h.value for h in jdec.hash_witness]
    assert all(isinstance(h, FieldElement252) for h in dec.hash_witness)
    assert [v.value for v in dec.column_witness] == \
        [v.value for v in jdec.column_witness]
    MerkleVerifier(port.root(), log_sizes, hasher=hash_node).verify(
        queries, values, dec)
    # the JAX verifier and its hash_node read `.value` of what they are given
    JaxMerkleVerifier(JaxFelt(port.root().value), log_sizes,
                      hasher=jax_hash_node).verify(queries, values, dec)
    MerkleVerifier(FieldElement252(jax_tree.root().value), log_sizes,
                   hasher=MERKLE_OPS["poseidon252"].hash_node).verify(
        queries, jvalues, jdec)


@pytest.mark.parametrize("name", ["mixed_sizes", "stack"])
def test_tampered_opening_is_refused(trees, name):
    entries, port_cols, port, _, _ = trees(name)
    queries = _queries(entries)
    log_sizes = [c.shape[-1].bit_length() - 1 for c in _flat(entries)]
    values, dec = port.decommit(queries, port_cols)
    verifier = MerkleVerifier(port.root(), log_sizes, hasher=hash_node)
    bad = [M31((values[0].value + 1) % P)] + list(values[1:])
    with pytest.raises(MerkleVerificationError, match="Root mismatch"):
        verifier.verify(queries, bad, dec)
    dec.hash_witness[0] = FieldElement252(dec.hash_witness[0].value ^ 1)
    with pytest.raises(MerkleVerificationError, match="Root mismatch"):
        verifier.verify(queries, values, dec)
    # the Blake2s hasher does not open a Poseidon252 tree
    with pytest.raises((MerkleVerificationError, TypeError)):
        MerkleVerifier(port.root(), log_sizes).verify(queries, values, dec)


def test_empty_tree_matches_jax_and_host():
    port = MERKLE_OPS["poseidon252"].commit([], "cpu")
    with pytest.raises(ValueError, match="needs its device"):
        MERKLE_OPS["poseidon252"].commit([])
    assert [tuple(layer.shape) for layer in port.layers] == [(8, 1)]
    assert port.root().value == JaxProver.commit([]).root().value
    assert port.root() == hash_node(None, [])


@pytest.mark.parametrize("log,n_cols,with_prev", [
    (2, 3, False), (2, 8, False), (1, 9, False), (2, 0, True), (1, 4, True),
    (0, 17, True), (0, 0, True), (2, 0, False)])
def test_layer_plain_matches_host_hash_node(log, n_cols, with_prev):
    """One layer against `hash_node` node by node: leaves of one to three
    blocks, inner nodes without columns and with joining ones, the layer
    that hashes no value; half of the columns as one stack."""
    rng = np.random.default_rng(100 * log + n_cols)
    n = 1 << log
    prev = [int.from_bytes(rng.bytes(31), "little") for _ in range(2 * n)] \
        if with_prev else None
    cols = rng.integers(0, P, size=(n_cols, n), dtype=np.uint32)
    entries = ([to_torch_u32(cols[:n_cols // 2])] if n_cols >= 2 else []) + \
        [to_torch_u32(c) for c in cols[n_cols // 2 if n_cols >= 2 else 0:]]
    got = pos.felts_to_ints(pos.merkle_layer(
        None if prev is None else pos.ints_to_felts(prev, "cpu"), entries, n,
        "cpu"))
    want = [hash_node(
        (FieldElement252(prev[2 * i]), FieldElement252(prev[2 * i + 1]))
        if with_prev else None, [M31(int(c[i])) for c in cols]).value
        for i in range(n)]
    assert got == want
