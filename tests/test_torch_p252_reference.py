"""The port's wide Fibonacci proof under the Poseidon252 flavour against the
benchmark's plain reference for it (stark_bench/reference/
wide_fibonacci_p252.py with felt252.py, which import nothing of the port)
on the CPU, tolerance 0.

First the reference's vectorised pieces against the host definitions of
stark_bench/reference/hashes.py and merkle.py, which hash one Python int
at a time: the Hades permutation, the sponge, the packing of M31 values,
a tree of mixed sizes and its decommitment, the channel's trailing zeros
and the least-nonce scan.  Then a whole proof at 2^5 rows, pow_bits 12 and
3 queries, field by field through the recipe's `proof_fields` and the
harness's comparison over a STARK proof's five parts, and the control (one
query fewer) that must differ; the count of the trees' permutations that
the Merkle roofline reads; the recipe's refusal of a port that grinds a
Poseidon252 channel on the host; the prove's counters.
"""
from __future__ import annotations

import copy
import json
import random
from pathlib import Path

import numpy as np
import pytest
import torch

from stark_bench.compare import compare, parts_of
from stark_bench.recipes import wide_fibonacci_p252 as recipe
from stark_bench.reference import felt252, hashes
from stark_bench.reference import wide_fibonacci as plain_wf
from stark_bench.reference import wide_fibonacci_p252 as reference
from stark_bench.reference.merkle import MerkleTree, Poseidon252Tree
from tstwo_tpu_torch import proof_of_work, tracing

P252 = hashes.P252
P = (1 << 31) - 1
SEED = 2 ** 40 + 23  # a large seed, as the benchmark's are
CONFIG = json.loads((Path(__file__).resolve().parents[1] / "stark_bench" /
                     "configs" / "wide_fib100_poseidon252.json").read_text())
PARTS = parts_of(CONFIG)
EDGE = [0, 1, 2, P252 - 1, P252 - 2, 1 << 251, (1 << 251) - 1, 17 << 192,
        (1 << 224) - 1, (1 << 32) - 1, (1 << 192) - 1, (1 << 248) - 1]


def _small_config(n_queries: int = 3) -> dict:
    cfg = copy.deepcopy(CONFIG)
    cfg["air"]["n_columns"] = 12
    cfg["security"].update(pow_bits=12, n_queries=n_queries)
    return cfg


def _felts(seed: int, n: int) -> list:
    rng = random.Random(seed)
    return [rng.randrange(P252) for _ in range(n)]


@pytest.mark.parametrize("seed", [0, 1])
def test_hades_equals_the_host_permutation(seed):
    n = 29
    states = [_felts(seed + 10 * k, n) for k in range(3)]
    for k in range(3):
        states[k][:len(EDGE)] = EDGE[k:] + EDGE[:k]
    got = felt252.hades(torch.stack([felt252.from_ints(s, "cpu")
                                     for s in states]))
    got = [felt252.to_ints(got[k]) for k in range(3)]
    for i in range(n):
        assert [got[k][i] for k in range(3)] == hashes.hades(
            [states[0][i], states[1][i], states[2][i]])


@pytest.mark.parametrize("k", [1, 2, 3, 4, 5])
def test_hash_many_equals_the_host_sponge(k):
    n = 9
    cols = [_felts(100 + j, n) for j in range(k)]
    cols[0][:len(EDGE) - 3] = EDGE[3:]
    got = felt252.to_ints(felt252.hash_many(
        [felt252.from_ints(c, "cpu") for c in cols]))
    assert got == [hashes.poseidon_hash_many([c[i] for c in cols])
                   for i in range(n)]


def test_products_are_field_products():
    a, b = _felts(7, 20) + EDGE, EDGE + _felts(8, 20)
    x, y = felt252.from_ints(a, "cpu"), felt252.from_ints(b, "cpu")
    got = felt252.from_mont(felt252.mont_mul(felt252.to_mont(x),
                                             felt252.to_mont(y)))
    assert felt252.to_ints(got) == [u * v % P252 for u, v in zip(a, b)]


def test_pack_m31_is_the_hosts_packing():
    rng = np.random.default_rng(5)
    block = rng.integers(0, P, size=(8, 6))
    block[:, 0] = P - 1
    block[:, 1] = 0
    got = felt252.to_ints(felt252.pack_m31(torch.from_numpy(block)))
    want = []
    for col in block.T.tolist():
        acc = 0
        for v in col:
            acc = (acc << 31) | v
        want.append(acc)
    assert got == want


def _columns(seed: int, shape) -> list:
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.integers(0, P, size=1 << log))
            for log, n in shape for _ in range(n)]


# a tree of mixed sizes: 3 columns of 2^5 values, 9 of 2^3 (two felts a
# node), 1 of 2^2 and 8 of 2^1
TREE = [(5, 3), (3, 9), (2, 1), (1, 8)]


def test_tree_of_mixed_sizes_equals_the_host_tree(monkeypatch):
    monkeypatch.setattr(felt252, "HOST_LAYER_NODES", 1)  # vectorised
    cols = _columns(3, TREE)
    ours = MerkleTree(felt252.Poseidon252Layers, cols, "cpu")
    host = MerkleTree(Poseidon252Tree, cols, "cpu")
    assert ours.root() == host.root()
    for log, layer in enumerate(ours.layers):
        assert felt252.Poseidon252Layers.digests(
            layer, range(1 << log)) == host.layers[log]
    queries = {5: [0, 7, 8, 31], 3: [2], 1: [1]}
    assert ours.decommit(queries) == host.decommit(queries)


def test_host_layers_and_vectorised_layers_agree(monkeypatch):
    cols = _columns(4, [(6, 4)])
    host_root = MerkleTree(felt252.Poseidon252Layers, cols, "cpu").root()
    monkeypatch.setattr(felt252, "HOST_LAYER_NODES", 0)
    assert MerkleTree(felt252.Poseidon252Layers, cols, "cpu").root() == \
        host_root
    # the tree without columns, one node that hashes nothing
    assert MerkleTree(felt252.Poseidon252Layers, [], "cpu").root() == \
        hashes.poseidon_hash_many([])


@pytest.mark.parametrize("value", EDGE + [3 << 224, 0xFF << 240, 7 << 248])
def test_trailing_zeros_are_the_channels(value):
    ch = hashes.Poseidon252Channel()
    ch.digest = value
    assert felt252.trailing_zeros(felt252.from_ints([value], "cpu")
                                  ).tolist() == [ch.trailing_zeros()]


@pytest.mark.parametrize("mixed", [1, 2 ** 40, 2 ** 63 - 25])
def test_least_nonce_equals_the_host_grind(mixed):
    ch = hashes.Poseidon252Channel()
    ch.mix_u64(mixed)
    want = hashes.poseidon_grind(ch, 8)
    assert felt252.least_nonce(ch.digest, 8, "cpu", batch=64) == want
    # from later batches too
    assert felt252.least_nonce(ch.digest, 8, "cpu", batch=4) == want


@pytest.fixture(scope="module")
def proofs():
    """The port's proof and the reference's of one trace at 2^5 rows."""
    cfg = _small_config()
    got = recipe.proof_fields(recipe.prove(cfg, 5, SEED, "cpu"))
    inputs = reference.trace_inputs(SEED, 5)
    return cfg, got, reference.prove(inputs, cfg, 5, "cpu"), inputs


def test_port_proof_equals_the_reference_proof(proofs):
    cfg, got, want, _ = proofs
    assert compare(got, want, PARTS) == dict.fromkeys(PARTS, 0)
    assert got == want
    assert got["proof_of_work"] == want["proof_of_work"] > 0
    assert all(isinstance(c, int) for c in got["commitments"])
    assert len(got["fri"]["inner_layers"]) == 5  # logs 6 down to 2


def test_the_control_differs(proofs):
    cfg, _, want, inputs = proofs
    weaker = _small_config(n_queries=2)
    control = reference.prove(inputs, weaker, 5, "cpu")
    readings = compare(control, want, PARTS)
    assert readings["commitments"] == readings["oods_values"] == 0
    assert readings["fri"] > 0 and readings["decommitment"] > 0


def test_the_reference_shares_the_blake2s_cells_air():
    assert reference.trace_inputs is plain_wf.trace_inputs
    assert reference.merkle_trees is plain_wf.merkle_trees
    assert reference.HADES_OPS == 33_308


@pytest.mark.parametrize("log_n", [2, 3])
def test_permutations_are_the_trees_hades_calls(monkeypatch, log_n):
    """Each tree of `merkle_trees` built from columns of its shape by the
    host layers: `poseidon_permutations` counts its permutations."""
    calls = []
    host_hades = hashes.hades
    monkeypatch.setattr(hashes, "hades",
                        lambda s: calls.append(1) or host_hades(s))
    cfg = _small_config()
    for tree in reference.merkle_trees(cfg, log_n):
        MerkleTree(felt252.Poseidon252Layers, _columns(6, tree), "cpu")
    assert len(calls) == reference.poseidon_permutations(cfg, log_n)
    ops, n_bytes = reference.poseidon_work(cfg, log_n)
    assert ops == 33_308 * len(calls) and n_bytes > 0
    assert reference.grind_work([0, 9]) == (33_308 * 2 * 11, 80)


def test_recipe_refuses_a_port_that_grinds_on_the_host(monkeypatch):
    recipe.require_device_grind(CONFIG)
    monkeypatch.setattr(proof_of_work, "grinds_on_device", lambda c, b: False)
    with pytest.raises(RuntimeError, match="on the host"):
        recipe.prove(CONFIG, 20, SEED, "cpu")
    monkeypatch.delattr(proof_of_work, "grinds_on_device")
    with pytest.raises(RuntimeError, match="Poseidon252Channel"):
        recipe.require_device_grind(CONFIG)


def test_counters_of_the_prove():
    cfg = _small_config()
    tracing.reset()
    tracing.enable(sync=False)
    try:
        with tracing.request(0):
            proof = recipe.prove(cfg, 4, SEED, "cpu")
        counts = tracing.counts()[0]
        names = [r["name"] for r in tracing.records()]
    finally:
        tracing.disable()
        tracing.reset()
    nonce = proof.commitment_scheme_proof.proof_of_work
    batch = proof_of_work.GRIND_BATCH_P252_CPU
    assert counts["grind_nonces"] == batch * (nonce // batch + 1)
    # the transcript: at least a mix (two permutations) a root and a draw
    # a FRI layer
    assert counts["host_hades"] >= 2 * 4 + 3 * 5
    assert names.count("grind") == 1
    recipe.prove(cfg, 4, SEED, "cpu")
    assert tracing.counts() == {}
