"""The wide Fibonacci AIR under the Poseidon252 flavour in the reference:
the trace, constraints and work counts of `.wide_fibonacci`, and a proof
made with the vectorised Poseidon252 trees and proof-of-work scan of
`.felt252`, over `hashes.Poseidon252Channel`.

`prover.prove_air` takes, for this flavour, the host's tree and grind,
which hash one Python int at a time: hours a 2^20-row proof.  It takes no
tree hasher or grind of the caller's, so `prove_air` here is its flow step
for step with those two replaced (a copy, until `prover.prove_air` takes
both).  Also here: the Hades permutations of the trees the proof commits
and of a grind, whose integer operations the roofline readers count.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from .algebra import evaluate, interpolate, eval_at_point
from .felt252 import SCAN_BATCH, Poseidon252Layers, least_nonce
from .hashes import Poseidon252Channel
from .merkle import MerkleTree
from .prover import (_decommitment, _pairs, _values_at, deep_quotient,
                     fold_circle_into, fold_line, fold_queries,
                     generate_queries, last_layer_poly, random_point)
from .wide_fibonacci import (CONSTRAINT_LOG_BLOWUP, cfft_transforms,
                             composition_values, constraint_ops,
                             merkle_trees, trace, trace_inputs)

__all__ = ["trace_inputs", "prove", "prove_air", "constraint_ops",
           "cfft_transforms", "merkle_trees", "poseidon_permutations",
           "poseidon_work", "grind_work", "HADES_OPS"]

# Integer operations of one Hades permutation as the function needs them
# (tests/torch_cuda_cases.py HADES_OPS): 107 cubes of a square and a
# product of eight-word felts (36 and 64 wide multiply-adds, each with a
# reduction of 24) and 91 rounds of 12 modular additions of 16.
HADES_OPS = 107 * ((64 + 24) + (36 + 24)) + 91 * 12 * 16


def prove(inputs, config: dict, log_n: int, device) -> dict:
    """The reference proof, as plain data, of the trace from `inputs`."""
    a, b = (torch.as_tensor(x).to(device) for x in inputs)
    return prove_air(trace(a, b, config["air"]["n_columns"]), log_n,
                     log_n + CONSTRAINT_LOG_BLOWUP, composition_values,
                     config["security"], device)


def prove_air(trace_cols: torch.Tensor, log_n: int, eval_log: int,
              composition, security: dict, device) -> dict:
    """`prover.prove_air` for the Poseidon252 flavour, with
    `felt252.Poseidon252Layers` as the tree hasher and
    `felt252.least_nonce` as the grind."""
    blowup = security["log_blowup_factor"]
    hasher = Poseidon252Layers
    channel = Poseidon252Channel()

    trees = [MerkleTree(hasher, [], device)]
    channel.mix_root(trees[0].root())
    channel.mix_u64(log_n)
    coeffs = interpolate(trace_cols, log_n)
    trace_log = log_n + blowup
    ext = evaluate(coeffs, trace_log)
    trees.append(MerkleTree(hasher, list(ext), device))
    channel.mix_root(trees[1].root())

    random_coeff = channel.draw_felt()
    ev = ext if eval_log == trace_log else evaluate(coeffs, eval_log)
    comp_coeffs = interpolate(composition(ev, log_n, eval_log, random_coeff),
                              eval_log)
    del ev
    comp_log = eval_log + blowup
    comp_ext = evaluate(comp_coeffs, comp_log)
    trees.append(MerkleTree(hasher, list(comp_ext), device))
    channel.mix_root(trees[2].root())

    point = random_point(channel)
    trace_samples = eval_at_point(coeffs, *point, log_n)
    comp_samples = eval_at_point(comp_coeffs, *point, eval_log)
    del coeffs, comp_coeffs
    channel.mix_felts(trace_samples + comp_samples)

    quotient_coeff = channel.draw_felt()
    groups: Dict[int, Tuple[List[torch.Tensor], List]] = {}
    for evals, samples, log in ((ext, trace_samples, trace_log),
                                (comp_ext, comp_samples, comp_log)):
        cols, smp = groups.setdefault(log, ([], []))
        cols.extend(evals)
        smp.extend((point, s) for s in samples)
    quotients = [(log, deep_quotient(torch.stack(groups[log][0]),
                                     groups[log][1], quotient_coeff, log))
                 for log in sorted(groups, reverse=True)]

    # FRI commitment
    first_tree = MerkleTree(hasher, [v for _, qv in quotients for v in qv],
                            device)
    channel.mix_root(first_tree.root())
    alpha = channel.draw_felt()
    max_log = quotients[0][0]
    layer = fold_circle_into(
        torch.zeros((4, 1 << (max_log - 1)), dtype=torch.int64,
                    device=device), quotients[0][1], alpha)
    pending = list(quotients[1:])
    inner = []
    last_size = 1 << (security["log_last_layer_degree_bound"] + blowup)
    while layer.shape[1] > last_size:
        tree = MerkleTree(hasher, list(layer), device)
        channel.mix_root(tree.root())
        alpha = channel.draw_felt()
        inner.append((tree, layer))
        layer = fold_line(layer, alpha)
        if pending and 1 << (pending[0][0] - 1) == layer.shape[1]:
            layer = fold_circle_into(layer, pending.pop(0)[1], alpha)
    last = last_layer_poly(layer, security["log_last_layer_degree_bound"])
    channel.mix_felts(last)

    nonce = least_nonce(channel.digest, security["pow_bits"], device,
                        SCAN_BATCH if torch.device(device).type == "cuda"
                        else 1 << 8)
    channel.mix_u64(nonce)

    # decommitment
    queries = generate_queries(channel, max_log, security["n_queries"])
    first_witness, positions_by_log = [], {}
    for log, values in quotients:
        pos, wit = _pairs(fold_queries(queries, max_log - log))
        positions_by_log[log] = pos
        first_witness += _values_at(values, wit)
    _, hw, cw = first_tree.decommit(positions_by_log)
    fri = {"first_layer": {"commitment": first_tree.root(),
                           "fri_witness": first_witness,
                           "decommitment": _decommitment(hw, cw)},
           "inner_layers": [],
           "last_layer_poly": [list(c) for c in last]}
    layer_queries = fold_queries(queries, 1)
    for tree, values in inner:
        pos, wit = _pairs(layer_queries)
        log = values.shape[1].bit_length() - 1
        _, hw, cw = tree.decommit({log: pos})
        fri["inner_layers"].append({
            "commitment": tree.root(), "fri_witness": _values_at(values, wit),
            "decommitment": _decommitment(hw, cw)})
        layer_queries = fold_queries(layer_queries, 1)

    trace_positions = {log: fold_queries(queries, max_log - log)
                       for log, _ in quotients}
    queried_values, decommitments = [], []
    for tree in trees:
        vals, hw, cw = tree.decommit(trace_positions)
        queried_values.append(vals)
        decommitments.append(_decommitment(hw, cw))
    return {
        "commitments": [t.root() for t in trees],
        "sampled_values": [[], [[list(s)] for s in trace_samples],
                           [[list(s)] for s in comp_samples]],
        "decommitments": decommitments,
        "queried_values": queried_values,
        "proof_of_work": nonce,
        "fri": fri,
    }


# -- the work the hashes need ---------------------------------------------

def _tree_permutations(tree: Sequence[Tuple[int, int]]) -> Tuple[int, int,
                                                                  int]:
    """(permutations, nodes, column values) of a Poseidon252 tree whose
    columns are given as (log size, columns) per size: a node absorbs its
    two children (below the top layer of columns), its values eight to a
    felt and the padding felt 1, two felts a permutation; a tree without
    columns is one node that absorbs the 1 alone."""
    cols = dict(tree)
    top = max(cols, default=0)
    perms = nodes = values = 0
    for log in range(top, -1, -1):
        felts = (2 if log < top else 0) + -(-cols.get(log, 0) // 8) + 1
        perms += (1 << log) * -(-felts // 2)
        nodes += 1 << log
        values += (1 << log) * cols.get(log, 0)
    return perms, nodes, values


def poseidon_permutations(config: dict, log_n: int) -> int:
    """Hades permutations of every tree the proof commits
    (`merkle_trees`)."""
    return sum(_tree_permutations(t)[0] for t in merkle_trees(config, log_n))


def poseidon_work(config: dict, log_n: int) -> Tuple[float, float]:
    """(operations, bytes) of the proof's Poseidon252 trees: every
    permutation, every column value read once (4 bytes) and every node's
    felt written once (32 bytes)."""
    perms = n_bytes = 0
    for tree in merkle_trees(config, log_n):
        p, nodes, values = _tree_permutations(tree)
        perms += p
        n_bytes += 4 * values + 32 * nodes
    return HADES_OPS * perms, n_bytes


def grind_work(nonces: Sequence[int]) -> Tuple[float, float]:
    """(operations, bytes) of grinds whose least hits are `nonces`: two
    permutations for each nonce up to the hit, which any least-hit grind
    must hash, and the 32-byte digest in and 8-byte nonce out of each."""
    return (HADES_OPS * sum(2 * (n + 1) for n in nonces),
            40 * len(nonces))
