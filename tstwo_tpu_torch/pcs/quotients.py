"""DEEP/FRI quotient computation.

For a column f and a sample (p, v), the quotient is (f(x) - V0(x)) / V1(x)
where V0 interpolates (p, v), (conj(p), conj(v)) and V1 vanishes on
{p, conj(p)}; batches of columns sampled at the same point are combined by
powers of a random coefficient (reference pcs/quotients.ts embedded Rust,
backend/cpu/quotients.ts).

The whole-domain accumulation of a group of columns of one size is one
launch of csrc/quotients.cu on the card (`accumulate_quotients_cuda`):
it reads the columns in place, makes the domain's points itself and takes
each batch's constants packed on the host (`pack_quotient_constants`, in
numpy).  For CPU tensors the plain version `_accumulate_rows` runs the
same arithmetic in PyTorch.  The verifier's per-query recomputation
(fri_answers) runs the plain version over the queried rows on the host.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Dict, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from .. import kernels
from ..circle import CanonicCoset, CircleDomain, CirclePoint
from ..fields import CM31, M31, QM31
from ..ops import cm31 as cm31_ops
from ..ops import m31 as m31_ops
from ..ops import qm31 as qm31_ops
from ..poly.circle_poly import CircleEvaluation, SecureEvaluation
from ..tracing import count
from ..utils import entry_device, to_numpy_u32, to_torch_u32, upload
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

BATCH_WORDS = 20  # csrc/quotients.cu: kBatchWords
MAX_BATCHES = 64  # csrc/quotients.cu: kMaxBatches
# a batch's words: CM31 values, then QM31 values
_K, _NEG_PIY, _PIX, _C1, _A, _B, _COEFF = 0, 2, 4, 6, 8, 12, 16


class QuotientPack(NamedTuple):
    """A group's sample batches as csrc/quotients.cu reads them, every
    word a canonical M31."""

    batches: np.ndarray  # uint32 [B, BATCH_WORDS]: K, -y.c1, x.c1, c.c1
    #                      (CM31), then A, B, alpha^k (QM31)
    offsets: np.ndarray  # int32 [B + 1]: batch b's entries
    weights: np.ndarray  # uint32 [E, 4]: alpha^j of an entry, j from 1
    columns: np.ndarray  # int32 [E]: the column an entry reads


def _np_cm31_mul(x0, x1, y0, y1):
    return ((x0 * y0 % P + P - x1 * y1 % P) % P, (x0 * y1 + x1 * y0) % P)


def _np_qm31_mul(x, y):
    """Products of canonical QM31 coordinates, uint64 [..., 4] each
    (broadcast): (a + bu)(c + du) = (ac + R bd) + (ad + bc)u, R = 2 + i."""
    a, b = (x[..., 0], x[..., 1]), (x[..., 2], x[..., 3])
    c, d = (y[..., 0], y[..., 1]), (y[..., 2], y[..., 3])
    ac, bd = _np_cm31_mul(*a, *c), _np_cm31_mul(*b, *d)
    ad, bc = _np_cm31_mul(*a, *d), _np_cm31_mul(*b, *c)
    return np.stack([(ac[0] + 2 * bd[0] + P - bd[1]) % P,
                     (ac[1] + bd[0] + 2 * bd[1]) % P,
                     (ad[0] + bc[0]) % P, (ad[1] + bc[1]) % P], axis=-1)


def _np_qm31(v: QM31) -> np.ndarray:
    return np.array(v.to_ints(), dtype=np.uint64)


def _alpha_powers(alpha: QM31, k: int) -> np.ndarray:
    """uint64 [k, 4]: alpha^1 .. alpha^k, doubling the run each step."""
    powers = _np_qm31(alpha)[None, :]
    while len(powers) < k:
        powers = np.concatenate([powers, _np_qm31_mul(powers, powers[-1])])
    return powers[:k]


def pack_quotient_constants(sample_batches: Sequence[ColumnSampleBatch],
                            random_coeff: QM31) -> QuotientPack:
    """The line coefficients of `quotient_constants`, summed over each
    batch in numpy.  The j-th column of a batch (from 1) has c_j = alpha^j
    c, with c = conj(p.y) - p.y the same for the whole batch, so a row's
    numerator sum_j c_j F_j - a_j y - b_j is c S - A y - B with S = sum_j
    alpha^j F_j, A = sum_j a_j and B = sum_j b_j = c V - p.y A, V = sum_j
    alpha^j v_j.  c's CM31 part 0 is zero: its part 1 is the word kept.
    The denominator (p.x.c0 - x) p.y.c1 - (p.y.c0 - y) p.x.c1 of a row
    (x, y) is K - x p.y.c1 + y p.x.c1 with K = p.x.c0 p.y.c1 - p.y.c0
    p.x.c1."""
    sizes = [len(b.columns_and_values) for b in sample_batches]
    powers = _alpha_powers(random_coeff, max(sizes))
    words = np.zeros((len(sizes), BATCH_WORDS), dtype=np.uint64)
    for row, batch, k in zip(words, sample_batches, sizes):
        x, y = _np_qm31(batch.point.x), _np_qm31(batch.point.y)
        k0, k1 = _np_cm31_mul(x[0], x[1], y[2], y[3])
        m0, m1 = _np_cm31_mul(y[0], y[1], x[2], x[3])
        row[_K:_K + 2] = (k0 + P - m0) % P, (k1 + P - m1) % P
        row[_NEG_PIY:_NEG_PIY + 2] = (P - y[2:]) % P
        row[_PIX:_PIX + 2] = x[2:]
        values = np.array([v.to_ints() for _, v in batch.columns_and_values],
                          dtype=np.uint64)
        diff = np.zeros_like(values)  # conj(v) - v = -2 v.c1 u
        diff[:, 2:] = 2 * (P - values[:, 2:]) % P
        c = np.zeros(4, dtype=np.uint64)
        c[2:] = 2 * (P - y[2:]) % P
        a = _np_qm31_mul(powers[:k], diff).sum(axis=0) % P
        v = _np_qm31_mul(powers[:k], values).sum(axis=0) % P
        row[_C1:_C1 + 2] = c[2:]
        row[_A:_A + 4] = a
        row[_B:_B + 4] = (_np_qm31_mul(c, v) + P - _np_qm31_mul(y, a)) % P
        row[_COEFF:_COEFF + 4] = powers[k - 1]
    return QuotientPack(
        words.astype(np.uint32),
        np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32),
        np.concatenate([powers[:k] for k in sizes]).astype(np.uint32),
        np.array([i for b in sample_batches for i, _ in b.columns_and_values],
                 dtype=np.int32))


def domain_points_bitrev(domain: CircleDomain, device=None):
    """The domain's x and y in bit-reversed order, int32 [n] each, on
    `device` (CUDA device 0 unless named): `domain_points_plain`'s rows."""
    device = entry_device(device)
    xs, ys = domain_points_plain(domain, 0, domain.size())
    return to_torch_u32(xs, device), to_torch_u32(ys, device)


@lru_cache(maxsize=None)
def _step_points(initial_index: int, log_size: int) -> np.ndarray:
    """What csrc/quotients.cu makes a domain's points from: uint32
    [max(log_size - 1, 1), 2], the x, y of its half coset's initial point,
    then of step * 2^b for b < log_size - 2 (step: the half coset's)."""
    from ..circle import CirclePointIndex, Coset

    half = Coset(CirclePointIndex(initial_index), log_size - 1)
    points = [half.initial] + [half.step_size.scale(1 << b).to_point()
                               for b in range(log_size - 2)]
    return np.array([(p.x.value, p.y.value) for p in points],
                    dtype=np.uint32)


def domain_points_plain(domain: CircleDomain, row0: int, n_rows: int
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """x, y (uint32 [n_rows]) of rows row0 .. row0 + n_rows of the
    bit-reversed domain, made as csrc/quotients.cu makes them: rows 4m ..
    4m + 3 are (x, y), (x, -y), (-x, -y), (-x, y) for the half-coset point
    initial + rev(m) step, rev over log n - 2 bits ((-1, 0), the coset's
    point of order 2, is step * n / 4), composed from `_step_points`."""
    log = domain.log_size()
    points = _step_points(domain.half_coset.initial_index.value,
                          log).astype(np.uint64)
    if log == 1:  # rows 0, 1: (x, y), (x, -y)
        (x, y), = points
        xs, ys = np.array([x, x]), np.array([y, (P - y) % P])
        return (xs[row0:row0 + n_rows].astype(np.uint32),
                ys[row0:row0 + n_rows].astype(np.uint32))
    if row0 % 4 or n_rows % 4:
        raise ValueError(f"rows {row0} .. {row0 + n_rows}: expected whole "
                         "quads of 4 rows")
    quads = np.arange(row0 // 4, (row0 + n_rows) // 4, dtype=np.uint64)
    bits = log - 2
    k = np.zeros_like(quads)
    for b in range(bits):
        k |= ((quads >> np.uint64(b)) & np.uint64(1)) << np.uint64(bits - 1 - b)
    x = np.full(len(quads), points[0, 0])
    y = np.full(len(quads), points[0, 1])
    for b in range(bits):
        sx, sy = points[1 + b]
        sel = ((k >> np.uint64(b)) & np.uint64(1)).astype(bool)
        nx = (x * sx + P * P - y * sy) % P
        ny = (x * sy + y * sx) % P
        x, y = np.where(sel, nx, x), np.where(sel, ny, y)
    nx, ny = (P - x) % P, (P - y) % P
    return (np.stack([x, x, nx, nx], axis=1).reshape(-1).astype(np.uint32),
            np.stack([y, ny, ny, y], axis=1).reshape(-1).astype(np.uint32))


def _accumulate_rows(columns: torch.Tensor, xs: torch.Tensor,
                     ys: torch.Tensor,
                     sample_batches: Sequence[ColumnSampleBatch],
                     random_coeff: QM31) -> torch.Tensor:
    """Quotient accumulation over rows, the plain version of
    csrc/quotients.cu: columns int32 [K, n] and the rows' domain points
    xs, ys int32 [n]; returns int32 [4, n].

    Per batch (`pack_quotient_constants`): S = sum_j alpha^j F_j(row), the
    numerator c S - A y - B, the denominator K - x p.y.c1 + y p.x.c1 in
    CM31; rows accumulate as row_acc * alpha^k + numerator / denominator.
    Wide int64 values.  It runs for CPU tensors (and the verifier's
    `fri_answers` on its queried rows); on the card only when called
    directly."""
    pack = pack_quotient_constants(sample_batches, random_coeff)
    dev = columns.device
    consts = upload(torch.from_numpy(pack.batches.astype(np.int64)),
                    dev)[:, :, None]
    weights = upload(torch.from_numpy(pack.weights.astype(np.int64)),
                     dev)[:, :, None]
    xw, yw = m31_ops.wide(xs), m31_ops.wide(ys)
    row_acc = torch.zeros((4, columns.shape[-1]), dtype=torch.int64,
                          device=dev)
    for b, bw in enumerate(consts):
        lo, hi = pack.offsets[b], pack.offsets[b + 1]
        s = torch.zeros_like(row_acc)
        for w, j in zip(weights[lo:hi], pack.columns[lo:hi].tolist()):
            s = (s + w * m31_ops.wide(columns[j])) % P
        c = torch.cat([torch.zeros_like(bw[_C1:_C1 + 2]), bw[_C1:_C1 + 2]])
        numerator = m31_ops.sub_w(
            qm31_ops.mul_w(c, s),
            m31_ops.add_w(m31_ops.mul_w(bw[_A:_A + 4], yw), bw[_B:_B + 4]))
        denom = m31_ops.add_w(m31_ops.add_w(
            bw[_K:_K + 2], m31_ops.mul_w(bw[_NEG_PIY:_NEG_PIY + 2], xw)),
            m31_ops.mul_w(bw[_PIX:_PIX + 2], yw))
        denom_inv = cm31_ops.inv_w(denom)
        row_acc = m31_ops.add_w(
            qm31_ops.mul_w(row_acc, bw[_COEFF:_COEFF + 4]),
            torch.cat([cm31_ops.mul_w(numerator[:2], denom_inv),
                       cm31_ops.mul_w(numerator[2:], denom_inv)]))
    return m31_ops.narrow(row_acc)


def _device_table(pack: QuotientPack, pointers: Sequence[int],
                  device) -> torch.Tensor:
    """csrc/quotients.cu's table, one upload from pinned memory, not
    waited for: the columns' pointers, the batches' words, the entry
    offsets (padded to 16 bytes), the weights and the entries' columns."""
    k, b, e = len(pointers), len(pack.batches), len(pack.columns)
    at_offsets = 2 * k + BATCH_WORDS * b
    at_weights = (at_offsets + b + 1 + 3) & ~3
    buf = np.zeros(at_weights + 5 * e, dtype=np.uint32)
    buf[:2 * k] = np.array(pointers, dtype=np.uint64).view(np.uint32)
    buf[2 * k:at_offsets] = pack.batches.reshape(-1)
    buf[at_offsets:at_offsets + b + 1] = pack.offsets.view(np.uint32)
    buf[at_weights:at_weights + 4 * e] = pack.weights.reshape(-1)
    buf[at_weights + 4 * e:] = pack.columns.view(np.uint32)
    return upload(torch.from_numpy(buf.view(np.int32)).pin_memory(), device,
                  non_blocking=True)


def _launch(table: torch.Tensor, n_cols: int, pack: QuotientPack,
            domain: CircleDomain, row0: int, out: torch.Tensor) -> None:
    """One launch of csrc/quotients.cu into `out` [4, m]."""
    log = domain.log_size()
    points = _step_points(domain.half_coset.initial_index.value, log)
    kernels.launch("accumulate_quotients", "accumulate_quotients",
                   out.device, table.data_ptr(), n_cols, len(pack.batches),
                   len(pack.columns), points.ctypes.data, log, row0,
                   out.shape[1], out.data_ptr())


def accumulate_quotients_cuda(domain: CircleDomain,
                              columns: Sequence[torch.Tensor],
                              random_coeff: QM31,
                              sample_batches: Sequence[ColumnSampleBatch],
                              row0: int = 0) -> torch.Tensor:
    """One launch of csrc/quotients.cu: the quotients, int32 [4, m], of
    rows row0 .. row0 + m of the bit-reversed `domain` from the group's
    columns, each int32 [m] (those rows), contiguous, on one CUDA device,
    read where they lie.  One upload (`_device_table`), no
    synchronisation; counts `quotient_columns`."""
    kernels.check_cuda_tensor(columns[0], "column 0")
    device = columns[0].device
    m = columns[0].shape[-1]
    pointers = [c.data_ptr() for c in columns]
    for i, (c, ptr) in enumerate(zip(columns, pointers)):
        if (c.device != device or c.dtype != torch.int32
                or c.shape != (m,) or c.stride() != (1,) or ptr % 16):
            kernels.check_cuda_tensor(c, f"column {i}")
            if c.device != device or tuple(c.shape) != (m,):
                raise ValueError(f"column {i}: expected [{m}] on {device}, "
                                 f"got {tuple(c.shape)} on {c.device}")
            raise ValueError(f"column {i}: expected 16-byte alignment")
    log = domain.log_size()
    if m < 4 or m & (m - 1) or row0 % m or row0 + m > (1 << log):
        raise ValueError(f"rows {row0} .. {row0 + m} of 2^{log}: expected a "
                         "power of two of at least 4 that divides the first")
    if not 1 <= len(sample_batches) <= MAX_BATCHES:
        raise ValueError(f"{len(sample_batches)} sample batches: expected 1 "
                         f"to {MAX_BATCHES}")
    pack = pack_quotient_constants(sample_batches, random_coeff)
    if pack.columns.max() >= len(columns):
        raise ValueError("a sample names a column the group does not have")
    out = torch.empty((4, m), dtype=torch.int32, device=device)
    _launch(_device_table(pack, pointers, device), len(columns), pack,
            domain, row0, out)
    count("quotient_columns", len(columns))
    return out


def quotient_rows(domain: CircleDomain, columns: Sequence[torch.Tensor],
                  random_coeff: QM31,
                  sample_batches: Sequence[ColumnSampleBatch],
                  row0: int = 0) -> torch.Tensor:
    """The quotients, int32 [4, m], of rows row0 .. row0 + m of the
    bit-reversed `domain` (all of it, or a rank's slice) from the group's
    columns, each [m]: csrc/quotients.cu for CUDA columns, the plain
    version for CPU ones."""
    if kernels.on_cuda(columns[0]):
        return accumulate_quotients_cuda(domain, columns, random_coeff,
                                         sample_batches, row0)
    xs, ys = domain_points_plain(domain, row0, columns[0].shape[-1])
    return _accumulate_rows(torch.stack(list(columns)), to_torch_u32(xs),
                            to_torch_u32(ys), sample_batches, random_coeff)


def accumulate_quotients(domain: CircleDomain,
                         columns: Sequence[torch.Tensor],
                         random_coeff: QM31,
                         sample_batches: Sequence[ColumnSampleBatch],
                         log_blowup_factor: int) -> SecureEvaluation:
    """Quotient accumulation over the whole domain
    (reference backend/cpu/quotients.ts:52-75)."""
    return SecureEvaluation(domain, quotient_rows(
        domain, columns, random_coeff, sample_batches))


def compute_fri_quotients(columns: Sequence[CircleEvaluation],
                          samples: Sequence[List[PointSample]],
                          random_coeff: QM31,
                          log_blowup_factor: int) -> List[SecureEvaluation]:
    """Group columns by log size (descending) and accumulate
    (embedded Rust pcs/quotients.rs compute_fri_quotients).  The columns
    of one size are all point-sharded (their `mesh` set) or all whole; a
    sharded group accumulates on each rank's slice of the domain."""
    from ..parallel.ops import sharded_accumulate_quotients

    by_log: Dict[int, List[int]] = {}
    for i, col in enumerate(columns):
        by_log.setdefault(col.domain.log_size(), []).append(i)
    out = []
    for log_size in sorted(by_log, reverse=True):
        idxs = by_log[log_size]
        domain = CanonicCoset.new(log_size).circle_domain()
        sub_samples = [samples[i] for i in idxs]
        sample_batches = ColumnSampleBatch.new_vec(sub_samples)
        values = [columns[i].values for i in idxs]
        mesh = columns[idxs[0]].mesh
        if mesh is not None:
            out.append(sharded_accumulate_quotients(
                mesh, domain, values, random_coeff, sample_batches,
                log_blowup_factor))
        else:
            out.append(accumulate_quotients(
                domain, values, random_coeff, sample_batches,
                log_blowup_factor))
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
    # the domain points -- the prover's whole-domain accumulation.  This
    # is the verifier's arithmetic on a few hundred host values: it runs
    # on the CPU whatever device the prover used.
    cols = to_torch_u32(np.array([[v.value for v in r] for r in rows],
                                 dtype=np.uint32).T, "cpu")
    xs = to_torch_u32(np.array([p.x.value for p in points], np.uint32),
                      "cpu")
    ys = to_torch_u32(np.array([p.y.value for p in points], np.uint32),
                      "cpu")
    vals = to_numpy_u32(_accumulate_rows(cols, xs, ys, sample_batches,
                                         random_coeff))
    return [QM31.from_ints(vals[:, i].tolist())
            for i in range(vals.shape[1])]
