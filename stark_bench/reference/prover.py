"""The whole proof of an AIR of one component, made from its trace.

The prove follows stwo's order of transcript operations:

  preprocessed root (an empty tree), log_n, trace root; random coefficient;
  composition root; OODS point; sampled values; DEEP coefficient; FRI
  layer roots with their folding coefficients, the last layer; the grind's
  nonce; the queries; then every decommitment.

Returned is the proof as plain data (`fields`): roots as hex (Blake2s) or
ints (Poseidon252), field elements as ints, a QM31 as [a, b, c, d].
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from .algebra import (P, CanonicDomain, QM31, bit_reverse, coset_points,
                      eval_at_point, evaluate, interpolate, q, q_add, q_conj,
                      q_inv, q_mul, q_pow, q_sub, qv_mul_scalar, vinv)
from .hashes import (Blake2sChannel, Poseidon252Channel, blake2s_grind,
                     poseidon_grind)
from .merkle import TREES, MerkleTree

CHANNELS = {"blake2s": Blake2sChannel, "poseidon252": Poseidon252Channel}


def qv_scalar_times_m31(s: QM31, m: torch.Tensor) -> torch.Tensor:
    return torch.stack([(m * c) % P for c in s])


def random_point(channel) -> Tuple[QM31, QM31]:
    t = channel.draw_felt()
    t2 = q_mul(t, t)
    inv = q_inv(q_add(t2, q(1)))
    return q_mul(q_sub(q(1), t2), inv), q_mul(q_add(t, t), inv)


def deep_quotient(columns: torch.Tensor,
                  samples: Sequence[Tuple[Tuple[QM31, QM31], QM31]],
                  alpha: QM31, log_size: int) -> torch.Tensor:
    """The DEEP quotients of a group of same-size columns [K, n] with one
    sample (point, value) each, combined into [4, n].  Columns sampled at
    one point form a batch: column j of a batch is weighted alpha^(j+1) and
    contributes (c F_j(x) - a_j y - b_j) over the CM31 denominator
    (Re p.x - x) Im p.y - (Re p.y - y) Im p.x, where the line a_j y + b_j
    meets (p, v_j) and its conjugate; batches chain by alpha^(batch size)."""
    device = columns.device
    xs, ys = CanonicDomain(log_size).points_bitrev(device)
    batches: Dict[Tuple, List[Tuple[int, QM31]]] = {}
    for col, (point, value) in enumerate(samples):
        batches.setdefault(point, []).append((col, value))
    acc = torch.zeros((4, columns.shape[1]), dtype=torch.int64, device=device)
    for (px, py), members in batches.items():
        c = q_sub(q_conj(py), py)
        weighted = torch.zeros_like(acc)
        big_a, big_b, weight = q(0), q(0), q(1)
        for col, v in members:
            weight = q_mul(weight, alpha)
            a = q_sub(q_conj(v), v)
            b = q_sub(q_mul(v, c), q_mul(a, py))
            big_a = q_add(big_a, q_mul(weight, a))
            big_b = q_add(big_b, q_mul(weight, b))
            weighted = (weighted + qv_scalar_times_m31(weight, columns[col])
                        ) % P
        numerator = (qv_mul_scalar(weighted, c)
                     - qv_scalar_times_m31(big_a, ys)
                     - torch.tensor(big_b, dtype=torch.int64,
                                    device=device)[:, None]) % P
        dx, dy = (px[0] - xs) % P, (py[0] - ys) % P
        d0 = (dx * py[2] % P - px[1] * py[3] - dy * px[2] % P
              + py[1] * px[3]) % P
        d1 = (dx * py[3] % P + px[1] * py[2] - dy * px[3] % P
              - py[1] * px[2]) % P
        norm_inv = vinv((d0 * d0 + d1 * d1) % P)
        i0, i1 = (d0 * norm_inv) % P, (-d1 * norm_inv) % P
        quot = torch.stack([
            (numerator[0] * i0 - numerator[1] * i1) % P,
            (numerator[0] * i1 + numerator[1] * i0) % P,
            (numerator[2] * i0 - numerator[3] * i1) % P,
            (numerator[2] * i1 + numerator[3] * i0) % P])
        acc = (qv_mul_scalar(acc, q_pow(alpha, len(members))) + quot) % P
    return acc


def _line_x(log_size: int, device) -> torch.Tensor:
    """x of the first half of the line domain of 2^log_size points (the
    half coset of the canonic domain of twice its size), in bit-reversed
    order."""
    dom = CanonicDomain(log_size + 1)
    xs, _ = coset_points(dom.half_initial, dom.half_step, log_size, device)
    return xs[bit_reverse(log_size - 1, device)]


def fold_line(values: torch.Tensor, alpha: QM31) -> torch.Tensor:
    log_size = values.shape[1].bit_length() - 1
    itw = vinv(_line_x(log_size, values.device))
    v0, v1 = values[:, 0::2], values[:, 1::2]
    f1 = ((v0 - v1) * itw[None, :]) % P
    return ((v0 + v1) + qv_mul_scalar(f1, alpha)) % P


def fold_circle_into(dst: torch.Tensor, src: torch.Tensor,
                     alpha: QM31) -> torch.Tensor:
    log_size = src.shape[1].bit_length() - 1
    _, ys = CanonicDomain(log_size).points_bitrev(src.device)
    v0, v1 = src[:, 0::2], src[:, 1::2]
    f1 = ((v0 - v1) * vinv(ys[0::2])[None, :]) % P
    folded = (qv_mul_scalar(f1, alpha) + v0 + v1) % P
    return (qv_mul_scalar(dst, q_mul(alpha, alpha)) + folded) % P


def last_layer_poly(values: torch.Tensor, log_degree_bound: int
                    ) -> List[QM31]:
    """The line polynomial of the last layer, coefficients in the
    bit-reversed order the proof holds; raises if its degree is too high."""
    log_size = values.shape[1].bit_length() - 1
    perm = bit_reverse(log_size, "cpu").tolist()
    rows = values.t().tolist()
    v = [tuple(rows[perm[i]]) for i in range(len(rows))]  # natural order
    dom = CanonicDomain(log_size + 1)
    layer_log = log_size
    init, step = dom.half_initial, dom.half_step
    while layer_log > 0:
        size, half = 1 << layer_log, 1 << (layer_log - 1)
        xs, _ = coset_points(init, step, layer_log, "cpu")
        xinv = [pow(int(x), P - 2, P) for x in xs[:half].tolist()]
        for start in range(0, len(v), size):
            for i in range(half):
                a, b = v[start + i], v[start + i + half]
                v[start + i] = q_add(a, b)
                v[start + i + half] = tuple(
                    (c * xinv[i]) % P for c in q_sub(a, b))
        init, step, layer_log = 2 * init, 2 * step, layer_log - 1
    n_inv = pow(len(v), P - 2, P)
    coeffs_bitrev = [tuple((c * n_inv) % P for c in x) for x in v]
    ordered = [coeffs_bitrev[p] for p in perm]
    bound = 1 << log_degree_bound
    if any(x != q(0) for x in ordered[bound:]):
        raise ValueError("the last FRI layer is of too high a degree")
    kept = ordered[:bound]
    keep_perm = bit_reverse(log_degree_bound, "cpu").tolist()
    return [kept[p] for p in keep_perm]


def generate_queries(channel, log_size: int, n_queries: int) -> List[int]:
    seen = set()
    while len(seen) < n_queries:
        data = channel.draw_random_bytes()
        for i in range(0, len(data) - 3, 4):
            seen.add(int.from_bytes(data[i: i + 4], "little")
                     & ((1 << log_size) - 1))
            if len(seen) == n_queries:
                break
    return sorted(seen)


def fold_queries(queries: Sequence[int], n_folds: int) -> List[int]:
    return sorted({p >> n_folds for p in queries})


def _pairs(queries: Sequence[int]) -> Tuple[List[int], List[int]]:
    """Every position of each queried pair, and those not queried."""
    qset = set(queries)
    pos, witness = [], []
    for pair in sorted({p >> 1 for p in queries}):
        for p in (2 * pair, 2 * pair + 1):
            pos.append(p)
            if p not in qset:
                witness.append(p)
    return pos, witness


def _values_at(values: torch.Tensor, idxs: Sequence[int]) -> List[List[int]]:
    if not idxs:
        return []
    idx = torch.tensor(list(idxs), dtype=torch.int64, device=values.device)
    return values.index_select(1, idx).t().tolist()


def _decommitment(hash_witness, column_witness) -> dict:
    return {"hash_witness": hash_witness, "column_witness": column_witness}




def prove_air(trace: torch.Tensor, log_n: int, eval_log: int,
              composition, security: dict, flavor: str, device) -> dict:
    """The proof of one component whose trace [C, 2^log_n] (bit-reversed
    order, as the trace tree commits it) has all its constraints in
    `composition(evaluations on the domain of 2^eval_log, log_n, eval_log,
    random coefficient)`, which gives the composition's values there."""
    blowup = security["log_blowup_factor"]
    hasher = TREES[flavor]
    channel = CHANNELS[flavor]()

    trees = [MerkleTree(hasher, [], device)]
    channel.mix_root(trees[0].root())
    channel.mix_u64(log_n)
    coeffs = interpolate(trace, log_n)
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

    if flavor == "blake2s":
        batch = 1 << (22 if torch.device(device).type == "cuda" else 12)
        nonce = blake2s_grind(channel, security["pow_bits"], device, batch)
    else:
        nonce = poseidon_grind(channel, security["pow_bits"])
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
