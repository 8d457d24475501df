"""Circle polynomials and their evaluations (device columns).

CirclePoly holds coefficients in the CFFT basis
{1,y} x {1,x} x {1,pi(x)} x ... (natural order); CircleEvaluation holds
values on a CircleDomain in bit-reversed order.  Secure variants hold 4
coordinate columns in the SecureColumnByCoords SoA layout.  Columns are
int32 tensors on any device (reference poly/circle/*.ts).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..circle import CircleDomain, CirclePoint
from ..fields import M31, QM31
from ..ops import fft as fft_ops
from ..ops import m31 as m31_ops
from ..ops import qm31 as qm31_ops
from ..utils import to_numpy_u32, to_torch_u32
from .twiddles import TwiddleTree, precompute_twiddles

MAX_CIRCLE_DOMAIN_LOG_SIZE = 30


def _check_tree(domain: CircleDomain, tree: TwiddleTree) -> None:
    if not domain.half_coset.is_doubling_of(tree.root_coset):
        raise ValueError("twiddle tree mismatch for domain")


def _mappings_for_point(point: CirclePoint, log_size: int,
                        one) -> List:
    """[y, x, pi(x), pi^2(x), ...]: innermost-to-outermost fold factors."""
    mappings = [point.y]
    x = point.x
    for _ in range(1, log_size):
        mappings.append(x)
        x = CirclePoint.double_x(x, one)
    return mappings


def evaluate_values(coeffs: torch.Tensor, domain: CircleDomain,
                    tree: Optional[TwiddleTree] = None) -> torch.Tensor:
    """CFFT-evaluate coefficient tensor(s) [..., m] on `domain` (bit-reversed
    output); m <= domain.size(), zero-extended
    (reference backend/cpu/circle.ts:71-82)."""
    n = domain.size()
    log = domain.log_size()
    if coeffs.shape[-1] > n:
        raise ValueError("domain too small for polynomial")
    if coeffs.shape[-1] < n:
        coeffs = F.pad(coeffs, (0, n - coeffs.shape[-1]))
    if log == 1:
        y = domain.half_coset.initial.y.value
        v0, v1 = coeffs[..., 0], coeffs[..., 1]
        prod = m31_ops.mul(v1, y)
        return torch.stack([m31_ops.add(v0, prod), m31_ops.sub(v0, prod)],
                           dim=-1)
    if tree is None:
        tree = precompute_twiddles(domain.half_coset)
    _check_tree(domain, tree)
    if log == 2:
        # twiddles [x] for layer 1 and [y, -y] for layer 0
        # (reference backend/cpu/circle.ts:99-109)
        init = domain.half_coset.initial
        x = to_torch_u32([init.x.value], coeffs.device)
        circle = to_torch_u32([init.y.value, (-init.y).value], coeffs.device)
        return fft_ops.fft_natural_to_bitrev(coeffs, [x], circle)
    line, circle, buf = tree.fft_twiddles(log, False, coeffs.device)
    return fft_ops.fft_natural_to_bitrev(coeffs, line, circle, buf)


def interpolate_values(values: torch.Tensor, domain: CircleDomain,
                       tree: Optional[TwiddleTree] = None) -> torch.Tensor:
    """Inverse CFFT: bit-reversed evaluations -> coefficients (natural)."""
    log = domain.log_size()
    n = domain.size()
    ninv = M31(n % ((1 << 31) - 1)).inverse().value
    if log == 1:
        yinv = domain.half_coset.initial.y.inverse().value
        v0, v1 = values[..., 0], values[..., 1]
        out = torch.stack(
            [m31_ops.add(v0, v1), m31_ops.mul(m31_ops.sub(v0, v1), yinv)],
            dim=-1)
        return m31_ops.mul(out, ninv)
    if tree is None:
        tree = precompute_twiddles(domain.half_coset)
    _check_tree(domain, tree)
    if log == 2:
        init = domain.half_coset.initial
        xinv = to_torch_u32([init.x.inverse().value], values.device)
        yi = init.y.inverse()
        circle_inv = to_torch_u32([yi.value, (-yi).value], values.device)
        out = fft_ops.ifft_bitrev_to_natural(values, [xinv], circle_inv)
        return m31_ops.mul(out, ninv)
    line_i, circle_i, buf = tree.fft_twiddles(log, True, values.device)
    out = fft_ops.ifft_bitrev_to_natural(values, line_i, circle_i, buf)
    return m31_ops.mul(out, ninv)


@dataclass
class CirclePoly:
    """Base-field circle polynomial; coeffs natural order (poly/circle/poly.ts:9)."""

    coeffs: torch.Tensor  # int32 [n]

    def __post_init__(self):
        n = self.coeffs.shape[-1]
        if n & (n - 1):
            raise ValueError("coeffs length must be a power of two")

    def log_size(self) -> int:
        return int(self.coeffs.shape[-1]).bit_length() - 1

    def evaluate(self, domain: CircleDomain,
                 tree: Optional[TwiddleTree] = None) -> "CircleEvaluation":
        return CircleEvaluation(domain, evaluate_values(self.coeffs, domain, tree))

    def eval_at_point(self, point: CirclePoint) -> QM31:
        """Evaluate at a QM31 point via hierarchical fold
        (reference backend/cpu/circle.ts:52-69)."""
        return eval_columns_at_point(self.coeffs[None, :], point,
                                     self.log_size())[0]


@dataclass
class CircleEvaluation:
    """Values over a CircleDomain in bit-reversed order
    (poly/circle/evaluation.ts:17)."""

    domain: CircleDomain
    values: torch.Tensor  # int32 [n]

    def __post_init__(self):
        if int(self.values.shape[-1]) != self.domain.size():
            raise ValueError("domain/values size mismatch")

    def interpolate(self, tree: Optional[TwiddleTree] = None) -> CirclePoly:
        return CirclePoly(interpolate_values(self.values, self.domain, tree))

    def to_numpy(self) -> np.ndarray:
        return to_numpy_u32(self.values)


@dataclass
class SecureCirclePoly:
    """4 coordinate polynomials = one QM31 polynomial (secure_poly.ts:11)."""

    coeffs: torch.Tensor  # int32 [4, n]

    def log_size(self) -> int:
        return int(self.coeffs.shape[-1]).bit_length() - 1

    def coordinate_polys(self) -> List[CirclePoly]:
        return [CirclePoly(self.coeffs[i]) for i in range(4)]

    def evaluate(self, domain: CircleDomain,
                 tree: Optional[TwiddleTree] = None) -> "SecureEvaluation":
        return SecureEvaluation(domain, evaluate_values(self.coeffs, domain, tree))

    def eval_at_point(self, point: CirclePoint) -> QM31:
        evals = [p.eval_at_point(point) for p in self.coordinate_polys()]
        return QM31.from_partial_evals(evals)


@dataclass
class SecureEvaluation:
    """QM31 values (SoA [4, n]) over a CircleDomain, bit-reversed order."""

    domain: CircleDomain
    values: torch.Tensor  # int32 [4, n]

    def __post_init__(self):
        if int(self.values.shape[-1]) != self.domain.size():
            raise ValueError("domain/values size mismatch")

    def __len__(self) -> int:
        return int(self.values.shape[-1])

    def interpolate(self, tree: Optional[TwiddleTree] = None) -> SecureCirclePoly:
        return SecureCirclePoly(interpolate_values(self.values, self.domain, tree))

    def columns(self) -> List[torch.Tensor]:
        return [self.values[i] for i in range(4)]

    def at(self, i: int) -> QM31:
        return QM31.from_ints([int(v) for v in self.values[:, i].tolist()])


def _fold_columns(coeff_stack: torch.Tensor, factors) -> torch.Tensor:
    """One fold of [k, n] base columns by QM31 factors (each an int32 [4])."""
    from ..ops.fri_ops import _deinterleave

    v = qm31_ops.from_m31(coeff_stack)  # [4, k, n]
    for f in factors:
        v0, v1 = _deinterleave(v)
        v = qm31_ops.add(v0, qm31_ops.mul(v1, f[:, None, None]))
    return v[:, :, 0]


def eval_columns_at_point(coeff_stack: torch.Tensor, point: CirclePoint,
                          log_size: int) -> List[QM31]:
    """Evaluate a batch of base-coefficient columns [k, n] at one QM31 point
    (one fold on the columns' device, one transfer of k values)."""
    if log_size == 0:
        return [QM31.from_base(M31(int(v)))
                for v in coeff_stack[:, 0].tolist()]
    mappings = _mappings_for_point(point, log_size, QM31.one())
    factors = [qm31_ops.scalar(f, device=coeff_stack.device) for f in mappings]
    out = to_numpy_u32(_fold_columns(coeff_stack, factors))
    return [QM31.from_ints(out[:, i].tolist()) for i in range(out.shape[1])]
