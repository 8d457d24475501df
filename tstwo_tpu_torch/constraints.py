"""Vanishing polynomials and DEEP-quotient line algebra.

reference constraints.ts:34-128 (ports of Rust constraints.rs).
"""
from __future__ import annotations

from functools import lru_cache
from typing import Union

import numpy as np

from .circle import CirclePoint, Coset
from .fields import CM31, M31, QM31

P = (1 << 31) - 1


def coset_vanishing(coset: Coset, p: CirclePoint) -> Union[M31, QM31]:
    """Vanishing polynomial of a coset: iterated x-doubling of the shifted
    point (reference constraints.ts:34-49)."""
    half = coset.step_size.half().to_point()
    x0 = p.x
    if isinstance(x0, QM31):
        conv = QM31.from_base
        one = QM31.one()
    else:
        conv = lambda v: v  # noqa: E731
        one = M31.one()
    shifted = (p - coset.initial.into_ef(conv)) + half.into_ef(conv)
    x = shifted.x
    for _ in range(1, coset.log_size):
        x = CirclePoint.double_x(x, one)
    return x


def point_excluder(excluded: CirclePoint, p: CirclePoint) -> M31:
    """reference constraints.ts:54-62."""
    diff = p - excluded
    return diff.x - M31.one()


def pair_vanishing(excluded0: CirclePoint, excluded1: CirclePoint,
                   p: CirclePoint):
    """reference constraints.ts:67-81."""
    return (excluded0.y - excluded1.y) * p.x + (
        (excluded1.x - excluded0.x) * p.y
        + (excluded0.x * excluded1.y - excluded0.y * excluded1.x))


def point_vanishing(vanish_point: CirclePoint, p: CirclePoint, conv, one):
    """reference constraints.ts:86-95."""
    diff = p - vanish_point.into_ef(conv)
    return diff.y * (one + diff.x).inverse()


def complex_conjugate_line(point: CirclePoint, value: QM31,
                           p: CirclePoint) -> QM31:
    """reference constraints.ts:100-112."""
    if point.y == point.y.complex_conjugate():
        raise ValueError("Cannot evaluate a line with a single point")
    diff = QM31.from_base(p.y) - point.y
    numerator = (value.complex_conjugate() - value) * diff
    denom_inv = (point.complex_conjugate().y - point.y).inverse()
    return value + numerator * denom_inv


@lru_cache(maxsize=None)
def coset_vanishing_denominator_inverses_bitrev(
        trace_log_size: int, eval_log_size: int) -> np.ndarray:
    """1 / coset_vanishing(trace_coset, p) for every eval-domain point p, in
    bit-reversed evaluation order (numpy uint32).

    This is the denominator of the composition polynomial's constraint
    quotients (Rust constraint_framework component.rs).
    """
    from .circle import CanonicCoset
    from .ops.m31 import np_inv
    from .utils import bit_reverse_permutation

    trace_coset = CanonicCoset.new(trace_log_size).coset
    eval_domain = CanonicCoset.new(eval_log_size).circle_domain()
    half = eval_domain.half_coset
    # device-free numpy evaluation: build (x, y) for all domain points
    init = half.initial
    n_half = half.size()
    xs = np.array([init.x.value], dtype=np.uint64)
    ys = np.array([init.y.value], dtype=np.uint64)
    j = 0
    while len(xs) < n_half:
        sp = half.step_size.scale(1 << j).to_point()
        sx, sy = np.uint64(sp.x.value), np.uint64(sp.y.value)
        nx = (xs * sx + np.uint64(P) * P - ys * sy) % P
        ny = (xs * sy + ys * sx) % P
        xs = np.concatenate([xs, nx])
        ys = np.concatenate([ys, ny])
        j += 1
    full_x = np.concatenate([xs, xs])
    full_y = np.concatenate([ys, (P - ys) % P])
    # shifted = p - initial + half_step  (vectorized point ops)
    shift = (-trace_coset.initial) + trace_coset.step_size.half().to_point()
    sx, sy = np.uint64(shift.x.value), np.uint64(shift.y.value)
    x = (full_x * sx + np.uint64(P) * P - full_y * sy) % P
    for _ in range(1, trace_coset.log_size):
        x = (2 * x * x + (P - 1)) % P
    perm = bit_reverse_permutation(eval_log_size)
    return np_inv(x[perm].astype(np.uint32))
