"""Merkle commit parity of the PyTorch port (tolerance 0), on the CPU.

`MerkleProver.commit` of the port goes layer by layer through
`ops/blake2s.merkle_layer` and finishes with one `merkle_tail` for the
layers of at most 2^TAIL_LOG nodes.  Here both take their plain versions
(the ones the CUDA kernels of csrc/blake2s.cu are held against on the
card); every layer and the root must equal the JAX MerkleProver's, the
openings must verify, and a single layer must equal the JAX package's
`commit_on_layer`, its Pallas kernel in interpret mode, and hashlib node
by node.  The decommitment's array plan is held to the node-by-node
traversal the verifier walks, and its bulk digests and M31s to the
per-node conversions.  Inputs come from a numpy seed.
"""
import hashlib

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from tstwo_tpu.ops import blake2s as jax_blake2s
from tstwo_tpu.vcs import MerkleProver as JaxMerkleProver
from tstwo_tpu.vcs import MerkleVerifier as JaxMerkleVerifier
from tstwo_tpu.vcs.blake2s_merkle import commit_on_layer as jax_commit_on_layer
from tstwo_tpu.vcs.poseidon252_merkle import \
    Poseidon252MerkleProver as JaxPoseidonProver
from tstwo_tpu_torch.channel.blake2s import Blake2sChannel
from tstwo_tpu_torch.channel.poseidon import FieldElement252
from tstwo_tpu_torch.fields import M31
from tstwo_tpu_torch.fri import (
    CIRCLE_TO_LINE_FOLD_STEP, FOLD_STEP,
    compute_decommitment_positions_and_witness_evals)
from tstwo_tpu_torch.ops import blake2s
from tstwo_tpu_torch.ops.blake2s import TAIL_LOG
from tstwo_tpu_torch.parallel.merkle import ShardedMerkleProver
from tstwo_tpu_torch.queries import Queries, get_query_positions_by_log_size
from tstwo_tpu_torch.utils import to_numpy_u32, to_torch_u32
from tstwo_tpu_torch.vcs import MerkleProver, MerkleVerifier
from tstwo_tpu_torch.vcs.blake2s_merkle import commit_on_layer
from tstwo_tpu_torch.vcs.ops import MERKLE_OPS
from tstwo_tpu_torch.vcs.poseidon252_merkle import Poseidon252MerkleProver
from tstwo_tpu_torch.vcs.prover import plan_decommitment
from tstwo_tpu_torch.vcs.utils import Peekable, next_decommitment_node

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


# -- the decommitment's plan, digests and values ----------------------------

def _plan_node_by_node(queries, n_layers):
    """Per layer (big->small) the visited nodes, the children whose hashes
    enter the witness and the queried flags, one node at a time as the
    verifier's peekable merge walks them."""
    out, prev = [], []
    for log in range(n_layers - 1, -1, -1):
        prev_q, direct_q = Peekable(prev), Peekable(queries.get(log, []))
        nodes, children, queried = [], [], []
        while (node := next_decommitment_node(prev_q, direct_q)) is not None:
            if log + 1 < n_layers:
                children += [c for c in (2 * node, 2 * node + 1)
                             if not prev_q.next_if_eq(c)]
            queried.append(direct_q.next_if_eq(node))
            nodes.append(node)
        out.append((nodes, children, queried))
        prev = nodes
    return out


PLAN_SEEDS = range(16)


def _plan_case(seed):
    """Columns at 1-3 log sizes of 0..9, often with layers of no column
    between them, and up to 70 distinct queries at some of the column sizes
    and some sizes without a column; seed 0 queries nothing."""
    rng = np.random.default_rng(1000 + seed)
    logs = sorted(rng.choice(10, 1 + seed % 3, replace=False).tolist(),
                  reverse=True)
    col_logs = [log for log in logs for _ in range(1 + rng.integers(2))]
    queried_logs = [log for log in range(logs[0] + 1)
                    if seed and (log == logs[0] or rng.random() < 0.3)]
    queries = {}
    for log in queried_logs:
        k = int(rng.integers(1, min(70, 1 << log) + 1))
        queries[log] = sorted(rng.choice(1 << log, k, replace=False).tolist())
    return col_logs, queries


@pytest.mark.parametrize("seed", PLAN_SEEDS)
def test_plan_is_the_node_by_node_traversal(seed):
    col_logs, queries = _plan_case(seed)
    cols = [torch.zeros(1 << log, dtype=torch.int32) for log in col_logs]
    n_layers = max(col_logs) + 1
    plans = plan_decommitment(queries, n_layers, cols)
    want = _plan_node_by_node(queries, n_layers)
    assert [p["log"] for p in plans] == list(range(n_layers - 1, -1, -1))
    for plan, (nodes, children, queried) in zip(plans, want):
        assert plan["node_idxs"].tolist() == nodes
        assert plan["hash_idxs"].tolist() == children
        assert plan["queried"].tolist() == queried
        assert [id(c) for c in plan["cols"]] == [
            id(c) for c, log in zip(cols, col_logs) if log == plan["log"]]


@pytest.mark.parametrize("seed", range(6))
def test_plan_nodes_are_the_folded_query_set_at_every_depth(seed):
    """Queries drawn by a channel and folded to each column size, as the
    commitment trees get them, visit unique(q >> d) at depth d below the
    largest layer; a FRI layer's tree, whose leaves are the queried
    cosets, visits the same sets above its leaves."""
    max_log = 8 + seed % 4
    channel = Blake2sChannel()
    channel.mix_u64(seed)
    queries = Queries.generate(channel, max_log, 70 - 9 * seed)
    q = np.asarray(queries.positions)
    col_logs = sorted({max_log, max_log - 1 - seed % 2, max_log - 3},
                      reverse=True)
    n_layers = max_log + 1
    plans = plan_decommitment(
        get_query_positions_by_log_size(queries, col_logs), n_layers,
        [torch.zeros(1 << log, dtype=torch.int32) for log in col_logs])
    for d, plan in enumerate(plans):
        assert plan["node_idxs"].tolist() == np.unique(q >> d).tolist()

    # FRI's first layer folds circle to line, an inner layer by FOLD_STEP
    for step in (CIRCLE_TO_LINE_FOLD_STEP, FOLD_STEP):
        positions, _ = compute_decommitment_positions_and_witness_evals(
            torch.zeros((4, 1 << max_log), dtype=torch.int32),
            queries.positions, step)
        plans = plan_decommitment({max_log: positions}, n_layers,
                                  [torch.zeros((4, 1 << max_log),
                                               dtype=torch.int32)])
        assert plans[0]["node_idxs"].tolist() == positions
        assert plans[0]["queried"].all()
        for d, plan in enumerate(plans[step:], start=step):
            assert plan["node_idxs"].tolist() == np.unique(q >> d).tolist()


# flavour -> (port prover, JAX prover, a hash witness entry as plain data)
FLAVOURS = {
    "blake2s": (MerkleProver, JaxMerkleProver, lambda h: h),
    "poseidon252": (Poseidon252MerkleProver, JaxPoseidonProver,
                    lambda h: h.value),
}


@pytest.mark.parametrize("flavour,seed", [
    *(("blake2s", s) for s in PLAN_SEEDS if s % 3 == 0 or s < 6),
    ("poseidon252", 2), ("poseidon252", 4)])
def test_decommitment_equals_jax_on_random_queries(flavour, seed):
    prover, jax_prover, plain = FLAVOURS[flavour]
    col_logs, queries = _plan_case(seed)
    rng = np.random.default_rng(seed)
    cols = [rng.integers(0, P, size=1 << log, dtype=np.uint32)
            for log in col_logs]
    port_cols = [to_torch_u32(c) for c in cols]
    jax_cols = [jnp.asarray(c) for c in cols]
    values, dec = prover.commit(port_cols).decommit(queries, port_cols)
    jvalues, jdec = jax_prover.commit(jax_cols).decommit(queries, jax_cols)
    assert [v.value for v in values] == [v.value for v in jvalues]
    assert [plain(h) for h in dec.hash_witness] == \
        [plain(h) for h in jdec.hash_witness]
    assert [v.value for v in dec.column_witness] == \
        [v.value for v in jdec.column_witness]


def _sharded_digests(flavour):
    return ShardedMerkleProver(None, [], False, MERKLE_OPS[flavour]).digests


@pytest.mark.parametrize("flavour,sharded", [
    ("blake2s", False), ("blake2s", True),
    ("poseidon252", False), ("poseidon252", True)])
@pytest.mark.parametrize("k", [0, 1, 7])
def test_digests_are_the_per_node_digests(flavour, sharded, k):
    """A flavour's `digests` of [8, k] words is each node's own digest:
    Blake2s the 32 little-endian bytes, Poseidon252 the felt whose word i
    weighs 2^(32 i); int32 bit-views read as their unsigned words."""
    rng = np.random.default_rng(k)
    words = rng.integers(0, 1 << 32, size=(8, k), dtype=np.uint64) \
        .astype(np.uint32)
    if k:
        words[:, 0] = [0, 1, 0xFFFFFFFF, 1 << 31, 0, 0, 7, 0]
    prover = MERKLE_OPS[flavour].prover_cls()
    digests = _sharded_digests(flavour) if sharded else prover.digests
    for view in (words, words.view(np.int32)):
        got = digests(view)
        assert len(got) == k
        for i in range(k):
            if flavour == "blake2s":
                assert got[i] == blake2s.digest_words_to_bytes(view[:, i])
            else:
                assert got[i] == FieldElement252(sum(
                    (int(w) & 0xFFFFFFFF) << (32 * j)
                    for j, w in enumerate(view[:, i])))
    column = to_torch_u32(rng.integers(0, P, size=8, dtype=np.uint32))
    tree = prover.commit([column])
    assert tree.root() == digests(to_numpy_u32(tree.layers[0]))[0]


def test_m31_many_is_m31_of_each_value():
    ints = [0, 1, P - 1, 2, P - 2, 1 << 30] + np.random.default_rng(0) \
        .integers(0, P, size=200).tolist()
    got, want = M31.many(ints), [M31(v) for v in ints]
    assert got == want and M31.many([]) == []
    assert [type(m) for m in got] == [M31] * len(ints)
    assert [hash(m) for m in got] == [hash(m) for m in want]
    assert [m.to_bytes() for m in got] == [m.to_bytes() for m in want]
    assert M31.into_slice(got) == M31.into_slice(want)
    assert len(set(got) | set(want)) == len(set(ints))
    assert got[2] + got[1] == M31(0) and got[2] == M31.from_int(-1)
