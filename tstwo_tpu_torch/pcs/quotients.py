"""DEEP/FRI quotient computation.

For a column f and a sample (p, v), the quotient is (f(x) - V0(x)) / V1(x)
where V0 interpolates (p, v), (conj(p), conj(v)) and V1 vanishes on
{p, conj(p)}; batches of columns sampled at the same point are combined by
powers of a random coefficient (reference pcs/quotients.ts embedded Rust,
backend/cpu/quotients.ts).

The whole-domain accumulation runs on the columns' device in plain
PyTorch: per sample batch, a CM31 denominator per row, a QM31 numerator
(c*F - (a*y+b)) per column, inverse + Horner accumulation, on wide int64
values.  The verifier's per-query recomputation (fri_answers) runs the
same accumulation over the queried rows on the host.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..circle import CanonicCoset, CircleDomain, CirclePoint
from ..fields import CM31, M31, QM31
from ..ops import cm31 as cm31_ops
from ..ops import m31 as m31_ops
from ..ops import qm31 as qm31_ops
from ..poly.circle_poly import CircleEvaluation, SecureEvaluation
from ..utils import bit_reverse_permutation, to_numpy_u32, to_torch_u32
from .utils import TreeVec

P = (1 << 31) - 1


@dataclass(frozen=True)
class PointSample:
    point: CirclePoint  # CirclePoint[QM31]
    value: QM31


@dataclass
class ColumnSampleBatch:
    point: CirclePoint
    columns_and_values: List[Tuple[int, QM31]]

    @staticmethod
    def new_vec(samples: Sequence[Sequence[PointSample]]) -> List["ColumnSampleBatch"]:
        """Group samples by point, insertion-ordered (embedded Rust IndexMap)."""
        grouped: Dict[Tuple, List[Tuple[int, QM31]]] = {}
        order: List[Tuple] = []
        points: Dict[Tuple, CirclePoint] = {}
        for column_index, column_samples in enumerate(samples):
            for s in column_samples:
                key = (s.point.x.to_ints(), s.point.y.to_ints())
                if key not in grouped:
                    grouped[key] = []
                    order.append(key)
                    points[key] = s.point
                grouped[key].append((column_index, s.value))
        return [ColumnSampleBatch(points[k], grouped[k]) for k in order]


def complex_conjugate_line_coeffs(sample: PointSample,
                                  alpha: QM31) -> Tuple[QM31, QM31, QM31]:
    """(alpha*a, alpha*b, alpha*c) for the line through (p, v), (conj p, conj v)
    (reference constraints.ts:117-128)."""
    if sample.point.y == sample.point.y.complex_conjugate():
        raise ValueError("Cannot evaluate a line with a single point")
    a = sample.value.complex_conjugate() - sample.value
    c = sample.point.complex_conjugate().y - sample.point.y
    b = sample.value * c - a * sample.point.y
    return (alpha * a, alpha * b, alpha * c)


@dataclass
class QuotientConstants:
    line_coeffs: List[List[Tuple[QM31, QM31, QM31]]]
    batch_random_coeffs: List[QM31]


def quotient_constants(sample_batches: Sequence[ColumnSampleBatch],
                       random_coeff: QM31) -> QuotientConstants:
    line_coeffs = []
    for batch in sample_batches:
        alpha = QM31.one()
        coeffs = []
        for _, value in batch.columns_and_values:
            alpha = alpha * random_coeff
            coeffs.append(complex_conjugate_line_coeffs(
                PointSample(batch.point, value), alpha))
        line_coeffs.append(coeffs)
    batch_coeffs = [random_coeff.pow(len(b.columns_and_values))
                    for b in sample_batches]
    return QuotientConstants(line_coeffs, batch_coeffs)


# ---------------------------------------------------------------------------
# Device path
# ---------------------------------------------------------------------------

@lru_cache(maxsize=None)
def _domain_points_bitrev_np(initial_index: int, half_log_size: int
                             ) -> Tuple[np.ndarray, np.ndarray]:
    """(x, y) of all domain points in bit-reversed evaluation order."""
    from ..circle import CirclePointIndex, Coset

    half_coset = Coset(CirclePointIndex(initial_index), half_log_size)
    half = half_coset.size()
    init = half_coset.initial
    xs = np.array([init.x.value], dtype=np.uint64)
    ys = np.array([init.y.value], dtype=np.uint64)
    j = 0
    while len(xs) < half:
        sp = half_coset.step_size.scale(1 << j).to_point()
        sx, sy = np.uint64(sp.x.value), np.uint64(sp.y.value)
        nx = (xs * sx + np.uint64(P) * P - ys * sy) % P
        ny = (xs * sy + ys * sx) % P
        xs = np.concatenate([xs, nx])
        ys = np.concatenate([ys, ny])
        j += 1
    # natural domain order: half coset then its conjugate
    full_x = np.concatenate([xs, xs])
    full_y = np.concatenate([ys, (P - ys) % P])
    perm = bit_reverse_permutation(half_log_size + 1)
    return (full_x[perm].astype(np.uint32), full_y[perm].astype(np.uint32))


def domain_points_bitrev(domain: CircleDomain, device="cpu"):
    xs, ys = _domain_points_bitrev_np(domain.half_coset.initial_index.value,
                                      domain.half_coset.log_size)
    return to_torch_u32(xs, device), to_torch_u32(ys, device)


def _wide_scalar(values, device) -> torch.Tensor:
    """Host field coordinates -> int64 [len(values), 1] for broadcasting."""
    return torch.tensor([int(v) for v in values], dtype=torch.int64,
                        device=device)[:, None]


def _accumulate_rows(columns: torch.Tensor, xs: torch.Tensor,
                     ys: torch.Tensor,
                     sample_batches: Sequence[ColumnSampleBatch],
                     random_coeff: QM31) -> torch.Tensor:
    """Quotient accumulation over rows: columns int32 [K, n] and the rows'
    domain points xs, ys int32 [n]; returns int32 [4, n].

    Per batch: denominator (prx - x) * piy - (pry - y) * pix in CM31, and
    numerator sum over its columns of c * F(row) - (a * y + b); rows
    accumulate as row_acc * batch_coeff + numerator / denominator.  The
    arithmetic is the JAX package's _accumulate_quotients_kernel, on wide
    int64 values."""
    consts = quotient_constants(sample_batches, random_coeff)
    dev = columns.device
    n = columns.shape[-1]
    xw = m31_ops.wide(xs)[None, :]
    yw = m31_ops.wide(ys)
    row_acc = torch.zeros((4, n), dtype=torch.int64, device=dev)
    for batch, line_coeffs, batch_coeff in zip(
            sample_batches, consts.line_coeffs, consts.batch_random_coeffs):
        px, py = batch.point.x, batch.point.y
        prx = _wide_scalar((px.c0.a, px.c0.b), dev)
        pry = _wide_scalar((py.c0.a, py.c0.b), dev)
        pix = _wide_scalar((px.c1.a, px.c1.b), dev)
        piy = _wide_scalar((py.c1.a, py.c1.b), dev)
        zero = torch.zeros_like(xw)
        dx = m31_ops.sub_w(prx, torch.cat([xw, zero]))
        dy = m31_ops.sub_w(pry, torch.cat([yw[None, :], zero]))
        denom = m31_ops.sub_w(cm31_ops.mul_w(dx, piy), cm31_ops.mul_w(dy, pix))
        denom_inv = cm31_ops.inv_w(denom)
        numerator = torch.zeros((4, n), dtype=torch.int64, device=dev)
        for (col_idx, _), (a, b, c) in zip(batch.columns_and_values,
                                           line_coeffs):
            col = m31_ops.wide(columns[col_idx])[None, :]
            value = m31_ops.mul_w(_wide_scalar(c.to_ints(), dev), col)
            linear = m31_ops.add_w(
                m31_ops.mul_w(_wide_scalar(a.to_ints(), dev), yw[None, :]),
                _wide_scalar(b.to_ints(), dev))
            numerator = m31_ops.add_w(numerator,
                                      m31_ops.sub_w(value, linear))
        quot = torch.cat([cm31_ops.mul_w(numerator[:2], denom_inv),
                          cm31_ops.mul_w(numerator[2:], denom_inv)])
        row_acc = m31_ops.add_w(
            qm31_ops.mul_w(row_acc, _wide_scalar(batch_coeff.to_ints(), dev)),
            quot)
    return m31_ops.narrow(row_acc)


def accumulate_quotients(domain: CircleDomain,
                         columns: Sequence[torch.Tensor],
                         random_coeff: QM31,
                         sample_batches: Sequence[ColumnSampleBatch],
                         log_blowup_factor: int) -> SecureEvaluation:
    """Quotient accumulation over the whole domain
    (reference backend/cpu/quotients.ts:52-75)."""
    device = columns[0].device
    xs, ys = domain_points_bitrev(domain, device)
    values = _accumulate_rows(torch.stack(list(columns)), xs, ys,
                              sample_batches, random_coeff)
    return SecureEvaluation(domain, values)


def compute_fri_quotients(columns: Sequence[CircleEvaluation],
                          samples: Sequence[List[PointSample]],
                          random_coeff: QM31,
                          log_blowup_factor: int) -> List[SecureEvaluation]:
    """Group columns by log size (descending) and accumulate
    (embedded Rust pcs/quotients.rs compute_fri_quotients)."""
    by_log: Dict[int, List[int]] = {}
    for i, col in enumerate(columns):
        by_log.setdefault(col.domain.log_size(), []).append(i)
    out = []
    for log_size in sorted(by_log, reverse=True):
        idxs = by_log[log_size]
        domain = CanonicCoset.new(log_size).circle_domain()
        sub_samples = [samples[i] for i in idxs]
        sample_batches = ColumnSampleBatch.new_vec(sub_samples)
        out.append(accumulate_quotients(
            domain, [columns[i].values for i in idxs], random_coeff,
            sample_batches, log_blowup_factor))
    return out


# ---------------------------------------------------------------------------
# Host path (verifier per-query recomputation)
# ---------------------------------------------------------------------------

def accumulate_row_quotients(sample_batches: Sequence[ColumnSampleBatch],
                             queried_values_at_row: Sequence[M31],
                             constants: QuotientConstants,
                             domain_point: CirclePoint) -> QM31:
    """reference backend/cpu/quotients.ts:80-116 (denominator in CM31 per the
    Rust ground truth, not the TS real-part-only deviation)."""
    denominators = []
    for batch in sample_batches:
        prx, pry = batch.point.x.c0, batch.point.y.c0
        pix, piy = batch.point.x.c1, batch.point.y.c1
        denominators.append(
            (prx.sub_m31(domain_point.x)) * piy
            - (pry.sub_m31(domain_point.y)) * pix)
    from ..fields import batch_inverse

    denominator_inverses = batch_inverse(denominators)
    row_acc = QM31.zero()
    for batch, line_coeffs, batch_coeff, dinv in zip(
            sample_batches, constants.line_coeffs,
            constants.batch_random_coeffs, denominator_inverses):
        numerator = QM31.zero()
        for (column_index, _), (a, b, c) in zip(batch.columns_and_values,
                                                line_coeffs):
            value = c.mul_m31(queried_values_at_row[column_index])
            linear = a.mul_m31(domain_point.y) + b
            numerator = numerator + (value - linear)
        row_acc = row_acc * batch_coeff + numerator.mul_cm31(dinv)
    return row_acc


def fri_answers(column_log_sizes: TreeVec,
                samples: TreeVec,
                random_coeff: QM31,
                query_positions_per_log_size: Dict[int, List[int]],
                queried_values: TreeVec,
                n_columns_per_log_size: TreeVec) -> List[List[QM31]]:
    """Recompute quotient values at queried points
    (embedded Rust pcs/quotients.rs fri_answers)."""
    iters = TreeVec(iter(v) for v in queried_values)
    flat = list(zip(column_log_sizes.flatten(), samples.flatten()))
    by_log: Dict[int, List] = {}
    for log_size, sample in flat:
        by_log.setdefault(log_size, []).append(sample)
    out = []
    for log_size in sorted(by_log, reverse=True):
        out.append(_fri_answers_for_log_size(
            log_size, by_log[log_size], random_coeff,
            query_positions_per_log_size[log_size], iters,
            TreeVec(npl.get(log_size, 0) for npl in n_columns_per_log_size)))
    return out


def _fri_answers_for_log_size(log_size, samples, random_coeff,
                              query_positions, queried_values_iters,
                              n_columns) -> List[QM31]:
    from ..utils import bit_reverse_index

    sample_batches = ColumnSampleBatch.new_vec(samples)
    commitment_domain = CanonicCoset.new(log_size).circle_domain()
    points = []
    rows: List[List[M31]] = []
    for q in query_positions:
        points.append(commitment_domain.at(bit_reverse_index(q, log_size)))
        row_values: List[M31] = []
        for it, n_cols in zip(queried_values_iters, n_columns):
            for _ in range(n_cols):
                row_values.append(next(it))
        rows.append(row_values)
    if not rows:
        return []
    # One pass over all query rows: the queried values form a
    # [K, n_queries] column matrix and the query points stand in for
    # the domain points -- the prover's whole-domain accumulation.
    cols = to_torch_u32(np.array([[v.value for v in r] for r in rows],
                                 dtype=np.uint32).T)
    xs = to_torch_u32(np.array([p.x.value for p in points], np.uint32))
    ys = to_torch_u32(np.array([p.y.value for p in points], np.uint32))
    vals = to_numpy_u32(_accumulate_rows(cols, xs, ys, sample_batches,
                                         random_coeff))
    return [QM31.from_ints(vals[:, i].tolist())
            for i in range(vals.shape[1])]
