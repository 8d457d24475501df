"""The Poseidon2 AIR with LogUp in the reference: its permutation and trace,
its interaction trace, its composition, the whole three-tree proof, and the
work its prove needs.

Written from stwo's examples/poseidon (PoseidonEval,
eval_poseidon_constraints, gen_trace, gen_interaction_trace,
prove_poseidon).  Departures from stwo:

- the input states are a counter-based map of the trace seed
  (`trace_inputs`; stwo writes a plain counter pattern): data, not shape;
- row r of every column is position r of its committed (bit-reversed)
  evaluation, as the program's trace has it.

Everything else is stwo's example: 8 permutations a row, 16-element state,
4 + 14 + 4 rounds, every round constant 1234, the external matrix
circ(2 M4, M4, M4, M4), the internal matrix s_i 2^(i+1) + sum, each applied
before the S-box x^5; instance k owns columns [158k, 158k + 158).  LogUp:
instance k adds 1/combine(input) - 1/combine(output), combine(v) = sum_i
alpha^i v_i - z over a relation of width 16; each instance's pair is one
batch, so 8 secure interaction columns, the last prefix-summed in coset
order with the shift claimed_sum / 2^log_n taken off every row; its mask
is at offsets 0 and -1.  The composition holds 1136 round constraints then
the 8 LogUp constraints, at LOG_EXPAND 2 (degree 5).

The row evaluation is written once over a field's operations (`Ops`):
int64 tensors here, a counting field in the tests, so that
`constraint_ops` is held to what this evaluation does.
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from .algebra import (P, CanonicDomain, Ops, bit_reverse, double_x,
                      eval_at_point, evaluate, interpolate, point_of_index, q,
                      q_mul, q_pow, subgroup_gen_index, vinv)
from .hashes import blake2s_grind, bytes_to_words, poseidon_grind
from .merkle import TREES, MerkleTree
from .prover import (CHANNELS, _decommitment, _pairs, _values_at,
                     deep_quotient, fold_circle_into, fold_line,
                     fold_queries, generate_queries, last_layer_poly,
                     random_point)

N_STATE = 16
N_INSTANCES = 8
N_HALF_FULL_ROUNDS = 4
N_PARTIAL_ROUNDS = 14
COLUMNS_PER_INSTANCE = N_STATE * (1 + 2 * N_HALF_FULL_ROUNDS) + N_PARTIAL_ROUNDS
N_COLUMNS = N_INSTANCES * COLUMNS_PER_INSTANCE  # 1264
N_ROUND_CONSTRAINTS = N_INSTANCES * (2 * N_HALF_FULL_ROUNDS * N_STATE
                                     + N_PARTIAL_ROUNDS)  # 1136
N_CONSTRAINTS = N_ROUND_CONSTRAINTS + N_INSTANCES  # and 8 LogUp pairs
LOG_EXPAND = 2
ROUND_CONSTANT = 1234
DIAGONAL = [1 << (i + 1) for i in range(N_STATE)]
INTERACTION_COLUMNS = 4 * N_INSTANCES
ROW_BLOCK = 1 << 18  # rows of the evaluation domain evaluated at once


# -- field operations ------------------------------------------------------

def q_add(f, x, y):
    return [f.add(a, b) for a, b in zip(x, y)]


def q_sub(f, x, y):
    return [f.sub(a, b) for a, b in zip(x, y)]


def q_scale(f, base, s):
    """A base value times a QM31: four products."""
    return [f.mul(base, c) for c in s]


def _cm_mul(f, x, y):
    m1, m2 = f.mul(x[0], y[0]), f.mul(x[1], y[1])
    m3 = f.mul(f.add(x[0], x[1]), f.add(y[0], y[1]))
    return [f.sub(m1, m2), f.sub(f.sub(m3, m1), m2)]


def q_mul(f, x, y):
    """QM31 product, u^2 = 2 + i, by Karatsuba: 9 products, 29 additions."""
    a, b, c, d = x[:2], x[2:], y[:2], y[2:]
    ac, bd = _cm_mul(f, a, c), _cm_mul(f, b, d)
    t = _cm_mul(f, [f.add(a[0], b[0]), f.add(a[1], b[1])],
                [f.add(c[0], d[0]), f.add(c[1], d[1])])
    rbd = [f.sub(f.add(bd[0], bd[0]), bd[1]), f.add(bd[0], f.add(bd[1], bd[1]))]
    lo = [f.add(ac[0], rbd[0]), f.add(ac[1], rbd[1])]
    hi = [f.sub(t[0], f.add(ac[0], bd[0])), f.sub(t[1], f.add(ac[1], bd[1]))]
    return lo + hi


# -- the permutation ---------------------------------------------------------

def _m4(f, x):
    t0, t1 = f.add(x[0], x[1]), f.add(x[2], x[3])
    t02, t12 = f.add(t0, t0), f.add(t1, t1)
    t2 = f.add(f.add(x[1], x[1]), t1)
    t3 = f.add(f.add(x[3], x[3]), t0)
    t4 = f.add(f.add(t12, t12), t3)
    t5 = f.add(f.add(t02, t02), t2)
    return [f.add(t3, t5), t5, f.add(t2, t4), t4]


def external_matrix(f, s):
    s = [v for c in range(4) for v in _m4(f, s[4 * c:4 * c + 4])]
    for j in range(4):
        t = f.add(f.add(s[j], s[j + 4]), f.add(s[j + 8], s[j + 12]))
        for c in range(4):
            s[4 * c + j] = f.add(s[4 * c + j], t)
    return s


def internal_matrix(f, s):
    total = s[0]
    for v in s[1:]:
        total = f.add(total, v)
    return [f.add(f.mul(v, d), total) for v, d in zip(s, DIAGONAL)]


def pow5(f, x):
    x2 = f.mul(x, x)
    return f.mul(f.mul(x2, x2), x)


def permutation_rounds(f, state) -> List:
    """The committed values of one permutation, in column order: the input,
    the state after each full round 0-3, s_0 after each partial round, the
    state after each full round 4-7."""
    s, out = list(state), list(state)
    for rnd in range(2 * N_HALF_FULL_ROUNDS + N_PARTIAL_ROUNDS):
        if N_HALF_FULL_ROUNDS <= rnd < N_HALF_FULL_ROUNDS + N_PARTIAL_ROUNDS:
            s[0] = f.add(s[0], ROUND_CONSTANT)
            s = internal_matrix(f, s)
            s[0] = pow5(f, s[0])
            out.append(s[0])
        else:
            s = [pow5(f, v) for v in external_matrix(
                f, [f.add(v, ROUND_CONSTANT) for v in s])]
            out += s
    return out


def trace_inputs(trace_seed: int, log_n: int) -> torch.Tensor:
    """int64 [8, 16, 2^log_n]: element i (row-major) is y_3 of
    y_0 = i b + a, y_(k+1) = (y_k + c + k)^5 mod P, where a, b, c are the
    seed's digits: a = seed mod P, b = 1 + (seed div P) mod (P - 1),
    c = (seed div (P (P - 1))) mod P."""
    a, rest = trace_seed % P, trace_seed // P
    b, c = 1 + rest % (P - 1), rest // (P - 1) % P
    y = (torch.arange(N_INSTANCES * N_STATE << log_n, dtype=torch.int64)
         * b + a) % P
    for k in range(3):
        y = pow5(Ops, (y + (c + k) % P) % P)
    return y.reshape(N_INSTANCES, N_STATE, 1 << log_n)


def trace(inputs: torch.Tensor) -> torch.Tensor:
    """int64 [8, 16, n] -> the 1264 columns, int64 [1264, n]."""
    cols = []
    for k in range(N_INSTANCES):
        cols += permutation_rounds(Ops, [inputs[k, i] % P
                                         for i in range(N_STATE)])
    return torch.stack(cols)


# -- LogUp -------------------------------------------------------------------

def draw_lookup_elements(channel) -> Tuple[list, list]:
    """(z, alpha) of one hash of the channel: eight words, drawn again
    while any is 2P or more."""
    while True:
        words = bytes_to_words(channel.draw_random_bytes())
        if all(w < 2 * P for w in words):
            return [w % P for w in words[:4]], [w % P for w in words[4:]]


def combine(f, values, alpha_powers, z):
    """sum_i alpha^i v_i - z of base values."""
    acc = q_scale(f, values[0], alpha_powers[0])
    for v, a in zip(values[1:], alpha_powers[1:]):
        acc = q_add(f, acc, q_scale(f, v, a))
    return q_sub(f, acc, z)


def _coset_order(log_n: int, device) -> torch.Tensor:
    """The committed (bit-reversed) row of the k-th point of the canonic
    coset's walk p, p + step, p + 2 step, ...: circle-domain index k / 2
    for even k, (2n - k) / 2 for odd k, bit-reversed."""
    n = 1 << log_n
    k = torch.arange(n, dtype=torch.int64, device=device)
    circle = torch.where(k % 2 == 0, k // 2, (2 * n - k) // 2)
    return bit_reverse(log_n, device)[circle]


def interaction_trace(cols: torch.Tensor, log_n: int, z, alpha
                      ) -> Tuple[torch.Tensor, list]:
    """The 32 interaction columns, int64 [32, n], and the claimed sum."""
    alpha_powers = [q(1)]
    for _ in range(N_STATE - 1):
        alpha_powers.append(q_mul(Ops, alpha_powers[-1], alpha))
    out, running = [], None
    for k in range(N_INSTANCES):
        base = k * COLUMNS_PER_INSTANCE
        d_in = combine(Ops, [cols[base + i] for i in range(N_STATE)],
                       alpha_powers, z)
        d_out = combine(Ops, [cols[base + COLUMNS_PER_INSTANCE - N_STATE + i]
                              for i in range(N_STATE)], alpha_powers, z)
        # 1/d_in - 1/d_out = (d_out - d_in) / (d_in d_out)
        num, den = q_sub(Ops, d_out, d_in), q_mul(Ops, d_in, d_out)
        frac = torch.stack(q_mul(Ops, num, _q_inv(den)))
        running = frac if running is None else (running + frac) % P
        out.append(running)
    claimed = [int(v) for v in (running.sum(dim=1) % P).tolist()]
    shift = [(c * pow(1 << log_n, P - 2, P)) % P for c in claimed]
    last = (running - torch.tensor(shift, dtype=torch.int64,
                                   device=cols.device)[:, None]) % P
    order = _coset_order(log_n, cols.device)
    summed = torch.empty_like(last)
    summed[:, order] = torch.cumsum(last[:, order], dim=1) % P
    out[-1] = summed
    return torch.cat(out), claimed


def _q_inv(x):
    """Inverse of a QM31 vector [4 coordinate tensors]:
    (a + bu)^-1 = (a - bu) / (a^2 - (2 + i) b^2)."""
    a, b = x[:2], x[2:]
    b2 = _cm_mul(Ops, b, b)
    rb2 = [(2 * b2[0] - b2[1]) % P, (b2[0] + 2 * b2[1]) % P]
    a2 = _cm_mul(Ops, a, a)
    den = [(a2[0] - rb2[0]) % P, (a2[1] - rb2[1]) % P]
    n_inv = vinv((den[0] * den[0] + den[1] * den[1]) % P)
    inv = [(den[0] * n_inv) % P, (-den[1] * n_inv) % P]
    return _cm_mul(Ops, a, inv) + _cm_mul(Ops, [(-b[0]) % P, (-b[1]) % P],
                                          inv)


# -- the composition -----------------------------------------------------------

def row_composition(f, cols, inter, prev_last, alpha_powers, z, coeffs,
                    shift, dinv):
    """The composition at a row: sum_k coeffs[k] C_k times the vanishing
    polynomial's inverse.  cols: the 1264 trace values, inter: the 32
    interaction values, prev_last: the last secure column one trace step
    back (4 values); coeffs: constraint k's QM31 coefficient."""
    acc, k = None, 0

    def accumulate(term):
        nonlocal acc
        acc = term if acc is None else q_add(f, acc, term)

    fracs = []
    for i in range(N_INSTANCES):
        c = cols[i * COLUMNS_PER_INSTANCE:(i + 1) * COLUMNS_PER_INSTANCE]
        s, pos = list(c[:N_STATE]), N_STATE
        for rnd in range(2 * N_HALF_FULL_ROUNDS + N_PARTIAL_ROUNDS):
            if N_HALF_FULL_ROUNDS <= rnd < N_HALF_FULL_ROUNDS + \
                    N_PARTIAL_ROUNDS:
                s[0] = f.add(s[0], ROUND_CONSTANT)
                s = internal_matrix(f, s)
                accumulate(q_scale(f, f.sub(pow5(f, s[0]), c[pos]),
                                   coeffs[k]))
                s[0], pos, k = c[pos], pos + 1, k + 1
            else:
                s = external_matrix(f, [f.add(v, ROUND_CONSTANT) for v in s])
                for j in range(N_STATE):
                    accumulate(q_scale(f, f.sub(pow5(f, s[j]), c[pos + j]),
                                       coeffs[k + j]))
                s, pos, k = list(c[pos:pos + N_STATE]), pos + N_STATE, \
                    k + N_STATE
        d_in = combine(f, c[:N_STATE], alpha_powers, z)
        d_out = combine(f, c[-N_STATE:], alpha_powers, z)
        fracs.append((q_sub(f, d_out, d_in), q_mul(f, d_in, d_out)))
    prev = None
    for i, (num, den) in enumerate(fracs):
        cur = inter[4 * i:4 * i + 4]
        diff = cur if prev is None else q_sub(f, cur, prev)
        if i == N_INSTANCES - 1:
            diff = q_add(f, q_sub(f, diff, prev_last), shift)
        prev = cur
        accumulate(q_mul(f, q_sub(f, q_mul(f, diff, den), num), coeffs[k]))
        k += 1
    return [f.mul(v, dinv) for v in acc]


def _prev_rows(trace_log: int, eval_log: int, device) -> torch.Tensor:
    """For each row of the bit-reversed evaluation domain, the row of the
    point one trace step back."""
    half = 1 << (eval_log - 1)
    step = 1 << (eval_log - trace_log - 1)
    rev = bit_reverse(eval_log, device)
    moved = torch.where(rev < half, (rev - step) % half,
                        (rev + step) % half + half)
    return rev[moved]


def _vanishing_inv(log_n: int, eval_log: int, device) -> torch.Tensor:
    xs, ys = CanonicDomain(eval_log).points_bitrev(device)
    initial, step = subgroup_gen_index(log_n + 1), subgroup_gen_index(log_n)
    sx, sy = point_of_index(-initial + step // 2)
    x = (xs * sx - ys * sy) % P
    for _ in range(1, log_n):
        x = double_x(x)
    return vinv(x)


def composition_values(ev_trace: torch.Tensor, ev_inter: torch.Tensor,
                       log_n: int, eval_log: int, random_coeff, z, alpha,
                       claimed) -> torch.Tensor:
    """[4, 2^eval_log], bit-reversed: the composition over the evaluation
    domain, in blocks of ROW_BLOCK rows."""
    device = ev_trace.device
    n = ev_trace.shape[1]
    alpha_powers = [q(1)]
    for _ in range(N_STATE - 1):
        alpha_powers.append(q_mul(Ops, alpha_powers[-1], alpha))
    coeffs = [q_pow(random_coeff, N_CONSTRAINTS - 1 - k)
              for k in range(N_CONSTRAINTS)]
    shift = [(c * pow(1 << log_n, P - 2, P)) % P for c in claimed]
    prev_rows = _prev_rows(log_n, eval_log, device)
    dinv = _vanishing_inv(log_n, eval_log, device)
    out = torch.empty((4, n), dtype=torch.int64, device=device)
    for lo in range(0, n, ROW_BLOCK):
        rows = slice(lo, min(n, lo + ROW_BLOCK))
        prev_last = ev_inter[-4:].index_select(1, prev_rows[rows])
        out[:, rows] = torch.stack(row_composition(
            Ops, list(ev_trace[:, rows]), list(ev_inter[:, rows]),
            list(prev_last), alpha_powers, z, coeffs, shift, dinv[rows]))
    return out


# -- the proof -----------------------------------------------------------------

def _prev_point(point, log_n: int):
    """The QM31 point one trace step back from `point`."""
    (px, py), (sx, sy) = point, point_of_index(-subgroup_gen_index(log_n))
    return (tuple((a * sx - b * sy) % P for a, b in zip(px, py)),
            tuple((a * sy + b * sx) % P for a, b in zip(px, py)))


def prove(inputs, config: dict, log_n: int, device) -> dict:
    """The reference proof, as plain data, of the trace from `inputs`."""
    security, flavor = config["security"], config["merkle_channel"]
    blowup = security["log_blowup_factor"]
    hasher, channel = TREES[flavor], CHANNELS[flavor]()
    trace_log, eval_log = log_n + blowup, log_n + LOG_EXPAND
    comp_log = eval_log + blowup

    trees = [MerkleTree(hasher, [], device)]
    channel.mix_root(trees[0].root())
    channel.mix_u64(log_n)
    cols = trace(torch.as_tensor(inputs).to(device))
    coeffs = interpolate(cols, log_n)
    ext = evaluate(coeffs, trace_log)
    trees.append(MerkleTree(hasher, list(ext), device))
    channel.mix_root(trees[1].root())

    z, alpha = draw_lookup_elements(channel)
    inter, claimed = interaction_trace(cols, log_n, tuple(z), tuple(alpha))
    del cols
    inter_coeffs = interpolate(inter, log_n)
    inter_ext = evaluate(inter_coeffs, trace_log)
    trees.append(MerkleTree(hasher, list(inter_ext), device))
    channel.mix_root(trees[2].root())

    random_coeff = channel.draw_felt()
    comp = composition_values(evaluate(coeffs, eval_log),
                              evaluate(inter_coeffs, eval_log), log_n,
                              eval_log, random_coeff, z, alpha, claimed)
    comp_coeffs = interpolate(comp, eval_log)
    del comp
    comp_ext = evaluate(comp_coeffs, comp_log)
    trees.append(MerkleTree(hasher, list(comp_ext), device))
    channel.mix_root(trees[3].root())

    point = random_point(channel)
    prev = _prev_point(point, log_n)
    trace_samples = eval_at_point(coeffs, *point, log_n)
    inter_samples = eval_at_point(inter_coeffs, *point, log_n)
    inter_prev = eval_at_point(inter_coeffs[-4:], *prev, log_n)
    comp_samples = eval_at_point(comp_coeffs, *point, eval_log)
    del coeffs, inter_coeffs, comp_coeffs
    inter_sampled = ([[list(s)] for s in inter_samples[:-4]]
                     + [[list(s), list(p)] for s, p in
                        zip(inter_samples[-4:], inter_prev)])
    sampled = [[], [[list(s)] for s in trace_samples], inter_sampled,
               [[list(s)] for s in comp_samples]]
    channel.mix_felts([tuple(v) for tree in sampled for col in tree
                       for v in col])

    quotient_coeff = channel.draw_felt()
    # columns of one size in tree order; a column sampled at two points
    # is listed once for each (the batch of the second point)
    low = torch.cat([ext, inter_ext, inter_ext[-4:]])
    low_samples = ([(point, s) for s in trace_samples + inter_samples]
                   + [(prev, p) for p in inter_prev])
    quotients = [
        (comp_log, deep_quotient(comp_ext, [(point, s) for s in comp_samples],
                                 quotient_coeff, comp_log)),
        (trace_log, deep_quotient(low, low_samples, quotient_coeff,
                                  trace_log))]
    del low

    # FRI commitment
    first_tree = MerkleTree(hasher, [v for _, qv in quotients for v in qv],
                            device)
    channel.mix_root(first_tree.root())
    fri_alpha = channel.draw_felt()
    max_log = quotients[0][0]
    layer = fold_circle_into(
        torch.zeros((4, 1 << (max_log - 1)), dtype=torch.int64,
                    device=device), quotients[0][1], fri_alpha)
    pending = list(quotients[1:])
    inner = []
    last_size = 1 << (security["log_last_layer_degree_bound"] + blowup)
    while layer.shape[1] > last_size:
        tree = MerkleTree(hasher, list(layer), device)
        channel.mix_root(tree.root())
        fri_alpha = channel.draw_felt()
        inner.append((tree, layer))
        layer = fold_line(layer, fri_alpha)
        if pending and 1 << (pending[0][0] - 1) == layer.shape[1]:
            layer = fold_circle_into(layer, pending.pop(0)[1], fri_alpha)
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

    positions = {log: fold_queries(queries, max_log - log)
                 for log, _ in quotients}
    queried_values, decommitments = [], []
    for tree in trees:
        vals, hw, cw = tree.decommit(positions)
        queried_values.append(vals)
        decommitments.append(_decommitment(hw, cw))
    return {
        "commitments": [t.root() for t in trees],
        "sampled_values": sampled,
        "decommitments": decommitments,
        "queried_values": queried_values,
        "proof_of_work": nonce,
        "fri": fri,
    }


# -- the work the prove needs ------------------------------------------------

FULL_ROUND_ADDS = N_STATE + 4 * 14 + 4 * (3 + 4) + N_STATE  # 116
FULL_ROUND_PRODUCTS = 3 * N_STATE  # 48
PARTIAL_ROUND_ADDS = 1 + (N_STATE - 1) + N_STATE + 1  # 33
PARTIAL_ROUND_PRODUCTS = N_STATE + 3  # 19
QM31_MUL = (9, 29)  # products, additions


def constraint_ops(config: dict, log_n: int) -> int:
    """Integer operations of the composition over the evaluation domain of
    2^(log_n + 2) rows, counted from the equations at 9 a product and 3 an
    addition: the rounds, each base constraint times its QM31 coefficient
    and added into the sum, the 16 combines, the 8 pair fractions and
    their constraints, and the sum times the vanishing inverse."""
    products = adds = 0
    per_instance_rounds = 2 * N_HALF_FULL_ROUNDS
    products += N_INSTANCES * (per_instance_rounds * FULL_ROUND_PRODUCTS
                               + N_PARTIAL_ROUNDS * PARTIAL_ROUND_PRODUCTS)
    adds += N_INSTANCES * (per_instance_rounds * FULL_ROUND_ADDS
                           + N_PARTIAL_ROUNDS * PARTIAL_ROUND_ADDS)
    # coefficient times constraint, added into the running sum
    products += 4 * N_ROUND_CONSTRAINTS
    adds += 4 * (N_CONSTRAINTS - 1)
    # combines: 16 base x QM31 terms, 15 sums and the - z
    products += 2 * N_INSTANCES * 4 * N_STATE
    adds += 2 * N_INSTANCES * 4 * N_STATE
    # pair fractions: d_out - d_in and d_in d_out
    products += N_INSTANCES * QM31_MUL[0]
    adds += N_INSTANCES * (4 + QM31_MUL[1])
    # LogUp constraints: column differences (7, the last also less the
    # previous row and plus the shift), diff * den - num, times the
    # coefficient
    adds += 4 * (N_INSTANCES - 1 + 2)
    products += N_INSTANCES * 2 * QM31_MUL[0]
    adds += N_INSTANCES * (2 * QM31_MUL[1] + 4)
    # the sum times the vanishing polynomial's inverse
    products += 4
    ops_per_row = 9 * products + 3 * adds
    return ops_per_row << (log_n + LOG_EXPAND)


def cfft_transforms(config: dict, log_n: int) -> List[Tuple[int, int, int]]:
    """(columns, log size of the result, log size of the source) of every
    circle FFT the prove needs: the trace and the interaction trace
    interpolated and extended, both evaluated on the composition's domain,
    the composition interpolated and extended."""
    blowup = config["security"]["log_blowup_factor"]
    eval_log = log_n + LOG_EXPAND
    out = []
    for n_cols in (N_COLUMNS, INTERACTION_COLUMNS):
        out += [(n_cols, log_n, log_n), (n_cols, log_n + blowup, log_n)]
    out += [(N_COLUMNS, eval_log, log_n), (INTERACTION_COLUMNS, eval_log, log_n),
            (4, eval_log, eval_log), (4, eval_log + blowup, eval_log)]
    return out


def merkle_trees(config: dict, log_n: int) -> List[List[Tuple[int, int]]]:
    """Every tree the prove commits, as (log size, columns) per size: the
    preprocessed (empty), trace, interaction and composition trees, FRI's
    first layer (the quotients of both sizes) and each inner FRI layer."""
    sec = config["security"]
    blowup = sec["log_blowup_factor"]
    trace_log = log_n + blowup
    comp_log = log_n + LOG_EXPAND + blowup
    trees = [[], [(trace_log, N_COLUMNS)], [(trace_log, INTERACTION_COLUMNS)],
             [(comp_log, 4)], [(comp_log, 4), (trace_log, 4)]]
    last_log = sec["log_last_layer_degree_bound"] + blowup
    trees += [[(log, 4)] for log in range(comp_log - 1, last_log, -1)]
    return trees
