"""Univariate polynomials over line domains (x-coordinates of a coset).

Used by FRI's inner layers and last layer.  LinePoly stores QM31
coefficients bit-reversed in the basis {1, x, pi(x), x*pi(x), ...}.
reference poly/line.ts.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import torch

from ..circle import CirclePoint, Coset
from ..fields import M31, QM31
from ..utils import (bit_reverse_list, entry_device, to_host_list,
                     to_numpy_u32)


@dataclass(frozen=True)
class LineDomain:
    """x-coordinates of a coset (reference poly/line.ts:18-115)."""

    coset: Coset

    @staticmethod
    def new(coset: Coset) -> "LineDomain":
        size = coset.size()
        if size == 2:
            if coset.initial.x.is_zero():
                raise ValueError("coset x-coordinates not unique")
        elif size > 2:
            # Rust stwo poly/line.rs::LineDomain::new asserts
            # ord(initial) >= ord(step) * 4; the reference TS adds an
            # "initial == identity is always valid" escape
            # (poly/line.ts:47-49) which is wrong -- x(kG) == x(-kG), so a
            # size->2 subgroup has duplicate x's.  We follow Rust.
            if not _log_order(coset.initial) >= _log_order_pt(coset.step) + 2:
                raise ValueError("coset x-coordinates not unique")
        return LineDomain(coset)

    def at(self, i: int) -> M31:
        return self.coset.at(i).x

    def size(self) -> int:
        return self.coset.size()

    def log_size(self) -> int:
        return self.coset.log_size

    def double(self) -> "LineDomain":
        return LineDomain(self.coset.double())

    def xs(self) -> List[M31]:
        return [p.x for p in self.coset.iter()]


def _log_order(p) -> int:
    return p.log_order_m31()


def _log_order_pt(p) -> int:
    return p.log_order_m31()


@dataclass(frozen=True)
class LinePoly:
    """QM31 line polynomial; coeffs bit-reversed (reference poly/line.ts:127)."""

    coeffs: tuple  # of QM31, bit-reversed order

    def __post_init__(self):
        n = len(self.coeffs)
        if n & (n - 1):
            raise ValueError("coeffs length must be a power of two")

    @staticmethod
    def new(coeffs: Sequence[QM31]) -> "LinePoly":
        return LinePoly(tuple(coeffs))

    @staticmethod
    def from_ordered_coefficients(coeffs: Sequence[QM31]) -> "LinePoly":
        return LinePoly(tuple(bit_reverse_list(list(coeffs))))

    def into_ordered_coefficients(self) -> List[QM31]:
        return bit_reverse_list(list(self.coeffs))

    def log_size(self) -> int:
        return len(self.coeffs).bit_length() - 1

    def __len__(self) -> int:
        return len(self.coeffs)

    def eval_at_point(self, x: QM31) -> QM31:
        """Fold over doublings of x (reference poly/line.ts:163-171).

        The recursive fold applies doublings[0] at the top half-split, so
        the bottom-up pairwise iteration consumes the factors reversed.
        """
        doublings = []
        cur = x
        for _ in range(self.log_size()):
            doublings.append(cur)
            cur = CirclePoint.double_x(cur, QM31.one())
        vals = list(self.coeffs)
        for f in reversed(doublings):
            vals = [vals[2 * i] + f * vals[2 * i + 1]
                    for i in range(len(vals) // 2)]
        return vals[0]


@dataclass
class LineEvaluation:
    """QM31 evaluations over a LineDomain, bit-reversed order, SoA [4, n].

    reference poly/line.ts:241-329 (values there are natural-order in the
    scalar port; FRI always uses bit-reversed order, which is what we store,
    matching Rust's LineEvaluation<B> with BitReversedOrder semantics in
    fri.rs usage).  With `mesh`, `values` is this rank's slice of the
    points of a point-sharded evaluation (parallel/).
    """

    domain: LineDomain
    values: torch.Tensor  # int32 [4, n], or [4, n / mesh.size] with a mesh
    mesh: Optional[object] = field(default=None, repr=False, compare=False)

    @staticmethod
    def new_zero(domain: LineDomain, device=None) -> "LineEvaluation":
        """Zeros on `device`, CUDA device 0 unless named."""
        return LineEvaluation(
            domain, torch.zeros((4, domain.size()), dtype=torch.int32,
                                device=entry_device(device)))

    def __len__(self) -> int:
        return self.domain.size()

    def at(self, i: int) -> QM31:
        return QM31.from_ints(to_host_list(self.values[:, i]))

    def to_qm31_list(self) -> List[QM31]:
        arr = to_numpy_u32(self.values)
        return [QM31.from_ints(arr[:, i].tolist()) for i in range(arr.shape[1])]

    def interpolate(self) -> LinePoly:
        """Bit-reversed evals -> LinePoly via line IFFT
        (reference poly/line.ts:312-328, 354-390)."""
        vals = bit_reverse_list(self.to_qm31_list())
        _line_ifft(vals, self.domain)
        n_inv = M31.from_int(len(vals)).inverse()
        return LinePoly(tuple(v.mul_m31(n_inv) for v in vals))


def _line_ifft(values: List[QM31], domain: LineDomain) -> None:
    """In-place line IFFT: natural-order evals -> bit-reversed coeffs * N."""
    cur = domain
    while cur.size() > 1:
        size = cur.size()
        half = size // 2
        xinvs = [cur.at(i).inverse() for i in range(half)]
        for start in range(0, len(values), size):
            for i in range(half):
                a = values[start + i]
                b = values[start + i + half]
                values[start + i] = a + b
                values[start + i + half] = (a - b).mul_m31(xinvs[i])
        cur = cur.double()
