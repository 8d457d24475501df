"""The wide Fibonacci AIR in the reference: its trace, its constraints, and
the work its prove needs (the transforms and the Merkle trees, which the
roofline readers count).

Row r of the trace starts with (a_r, b_r), both drawn from
`numpy.random.default_rng(trace_seed)` (two calls of `integers(0, P, n)`,
the example's stream); column j >= 2 is col[j-2]^2 + col[j-1]^2.  Its
N - 2 constraints c - (a^2 + b^2) have degree 2: the composition
polynomial lives on the domain of twice the trace's size.  The row
evaluation is written once over a field's operations (`algebra.Ops`):
int64 tensors here, a counting field in the tests, so that
`constraint_ops` is held to what this evaluation does.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from .algebra import (P, CanonicDomain, Ops, double_x, point_of_index, q_pow,
                      subgroup_gen_index, vinv)
from .prover import prove_air

CONSTRAINT_LOG_BLOWUP = 1  # degree-2 constraints


def trace_inputs(trace_seed: int, log_n: int) -> Tuple[np.ndarray, ...]:
    rng = np.random.default_rng(trace_seed)
    n = 1 << log_n
    return rng.integers(0, P, size=n), rng.integers(0, P, size=n)


def trace(a: torch.Tensor, b: torch.Tensor, n_columns: int) -> torch.Tensor:
    cols = [a.to(torch.int64) % P, b.to(torch.int64) % P]
    while len(cols) < n_columns:
        cols.append((cols[-2] * cols[-2] + cols[-1] * cols[-1]) % P)
    return torch.stack(cols)


def row_composition(f, cols, coeffs, dinv):
    """The composition at a row: sum_i coeffs[i] C_i times the vanishing
    polynomial's inverse, C_i = col[i+2] - col[i]^2 - col[i+1]^2, each
    column squared once; coeffs[i]: constraint i's QM31 coefficient."""
    acc, square = None, f.mul(cols[0], cols[0])
    for i in range(len(cols) - 2):
        square_next = f.mul(cols[i + 1], cols[i + 1])
        c = f.sub(f.sub(cols[i + 2], square), square_next)
        term = [f.mul(c, k) for k in coeffs[i]]
        acc = term if acc is None else [f.add(a, t)
                                        for a, t in zip(acc, term)]
        square = square_next
    return [f.mul(v, dinv) for v in acc]


def composition_values(ev: torch.Tensor, log_n: int, eval_log: int,
                       alpha) -> torch.Tensor:
    """sum_i alpha^(N-1-i) C_i / Z over the evaluation domain, [4, 2^eval_log]
    in bit-reversed order; C_i = col[i+2] - col[i]^2 - col[i+1]^2 and Z the
    vanishing polynomial of the trace's canonic coset."""
    n_constraints = ev.shape[0] - 2
    coeffs = [q_pow(alpha, n_constraints - 1 - i)
              for i in range(n_constraints)]
    xs, ys = CanonicDomain(eval_log).points_bitrev(ev.device)
    # the coset {G_{n+1} + k G_n}: shift p by -initial + step / 2, then
    # x -> 2x^2 - 1, log_n - 1 times
    initial, step = subgroup_gen_index(log_n + 1), subgroup_gen_index(log_n)
    sx, sy = point_of_index(-initial + step // 2)
    x = (xs * sx - ys * sy) % P
    for _ in range(1, log_n):
        x = double_x(x)
    return torch.stack(row_composition(Ops, list(ev), coeffs, vinv(x)))


def prove(inputs, config: dict, log_n: int, device) -> dict:
    """The reference proof, as plain data, of the trace from `inputs`."""
    a, b = (torch.as_tensor(x).to(device) for x in inputs)
    return prove_air(trace(a, b, config["air"]["n_columns"]), log_n,
                     log_n + CONSTRAINT_LOG_BLOWUP, composition_values,
                     config["security"], config["merkle_channel"], device)


# -- the work the prove needs ------------------------------------------------

def constraint_ops(config: dict, log_n: int) -> int:
    """Integer operations of the composition over the evaluation domain of
    2^(log_n + 1) rows, counted from the equations at 9 a product and 3 an
    addition (`row_composition`): every column but the last squared once,
    each constraint's two subtractions, its QM31 coefficient times it (4
    products) added into the sum (4 additions), and the sum times the
    vanishing polynomial's inverse (4 products)."""
    n_columns = config["air"]["n_columns"]
    n_constraints = n_columns - 2
    products = (n_columns - 1) + 4 * n_constraints + 4
    adds = 2 * n_constraints + 4 * (n_constraints - 1)
    return (9 * products + 3 * adds) << (log_n + CONSTRAINT_LOG_BLOWUP)


def cfft_transforms(config: dict, log_n: int) -> List[Tuple[int, int, int]]:
    """(columns, log size of the result, log size of the source) of every
    circle FFT the prove needs: the trace's interpolation and extension,
    the composition's interpolation and extension, and the trace on the
    constraint domain where that is not the extension's domain."""
    n_cols = config["air"]["n_columns"]
    blowup = config["security"]["log_blowup_factor"]
    eval_log = log_n + CONSTRAINT_LOG_BLOWUP
    out = [(n_cols, log_n, log_n), (n_cols, log_n + blowup, log_n),
           (4, eval_log, eval_log), (4, eval_log + blowup, eval_log)]
    if eval_log != log_n + blowup:
        out.append((n_cols, eval_log, log_n))
    return out


def merkle_trees(config: dict, log_n: int) -> List[List[Tuple[int, int]]]:
    """Every tree the prove commits, as (log size, columns) per size: the
    preprocessed (empty), trace and composition trees, FRI's first layer
    (the quotients of both sizes) and each inner FRI layer."""
    sec = config["security"]
    blowup = sec["log_blowup_factor"]
    trace_log = log_n + blowup
    comp_log = log_n + CONSTRAINT_LOG_BLOWUP + blowup
    first = {}
    for log in (comp_log, trace_log):
        first[log] = first.get(log, 0) + 4
    trees = [[], [(trace_log, config["air"]["n_columns"])], [(comp_log, 4)],
             sorted(first.items(), reverse=True)]
    last_log = sec["log_last_layer_degree_bound"] + blowup
    trees += [[(log, 4)] for log in range(comp_log - 1, last_log, -1)]
    return trees
