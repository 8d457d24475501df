"""M31, CM31 and QM31 arithmetic, circle points and domains, the circle FFT.

Scalars are Python ints (an M31), pairs (a CM31: a + b i) and 4-tuples (a
QM31: (a + b i) + (c + d i) u with u^2 = 2 + i).  Vectors are int64
tensors holding canonical M31 values: a QM31 vector is [4, ...].  Every
product of two values below P fits in int64 and is reduced at once.
"""
from __future__ import annotations

from typing import List, Tuple

import torch

P = (1 << 31) - 1
CIRCLE_LOG_ORDER = 31
GEN = (2, 1268011823)  # generator of the order-2^31 circle group over M31
R = (2, 1)  # u^2 = 2 + i

QM31 = Tuple[int, int, int, int]


class Ops:
    """M31 on int64 tensors (or ints): canonical in, canonical out.  An
    AIR's row evaluation written over these operations runs here and, in
    the tests, over a field that counts them (its `constraint_ops`)."""

    @staticmethod
    def add(a, b):
        return (a + b) % P

    @staticmethod
    def sub(a, b):
        return (a - b) % P

    @staticmethod
    def mul(a, b):
        return (a * b) % P


# -- scalars -----------------------------------------------------------------

def cm_mul(x, y):
    return ((x[0] * y[0] - x[1] * y[1]) % P, (x[0] * y[1] + x[1] * y[0]) % P)


def cm_add(x, y):
    return ((x[0] + y[0]) % P, (x[1] + y[1]) % P)


def cm_sub(x, y):
    return ((x[0] - y[0]) % P, (x[1] - y[1]) % P)


def cm_inv(x):
    norm_inv = pow((x[0] * x[0] + x[1] * x[1]) % P, P - 2, P)
    return (x[0] * norm_inv % P, (-x[1]) * norm_inv % P)


def q(a: int, b: int = 0, c: int = 0, d: int = 0) -> QM31:
    return (a % P, b % P, c % P, d % P)


def q_add(x: QM31, y: QM31) -> QM31:
    return tuple((a + b) % P for a, b in zip(x, y))


def q_sub(x: QM31, y: QM31) -> QM31:
    return tuple((a - b) % P for a, b in zip(x, y))


def q_mul(x: QM31, y: QM31) -> QM31:
    x0, x1, y0, y1 = x[:2], x[2:], y[:2], y[2:]
    lo = cm_add(cm_mul(x0, y0), cm_mul(R, cm_mul(x1, y1)))
    hi = cm_add(cm_mul(x0, y1), cm_mul(x1, y0))
    return lo + hi


def q_inv(x: QM31) -> QM31:
    # (x0 + x1 u)(x0 - x1 u) = x0^2 - R x1^2, a CM31
    x0, x1 = x[:2], x[2:]
    den_inv = cm_inv(cm_sub(cm_mul(x0, x0), cm_mul(R, cm_mul(x1, x1))))
    return cm_mul(x0, den_inv) + cm_mul(((-x1[0]) % P, (-x1[1]) % P), den_inv)


def q_pow(x: QM31, e: int) -> QM31:
    out = q(1)
    while e:
        if e & 1:
            out = q_mul(out, x)
        x = q_mul(x, x)
        e >>= 1
    return out


def q_conj(x: QM31) -> QM31:
    """u -> -u."""
    return (x[0], x[1], (-x[2]) % P, (-x[3]) % P)


# -- vectors -----------------------------------------------------------------

def vmul(a: torch.Tensor, b) -> torch.Tensor:
    return (a * b) % P


def vpow(a: torch.Tensor, e: int) -> torch.Tensor:
    out = torch.ones_like(a)
    while e:
        if e & 1:
            out = vmul(out, a)
        a = vmul(a, a)
        e >>= 1
    return out


def vinv(a: torch.Tensor) -> torch.Tensor:
    return vpow(a, P - 2)


def cmv_mul(x, y):
    """CM31 vectors as pairs of tensors (or ints)."""
    return ((x[0] * y[0] - x[1] * y[1]) % P, (x[0] * y[1] + x[1] * y[0]) % P)


def qv_mul_scalar(v: torch.Tensor, s: QM31) -> torch.Tensor:
    """QM31 vector [4, ...] times a QM31 scalar."""
    v0, v1 = (v[0], v[1]), (v[2], v[3])
    s0, s1 = s[:2], s[2:]
    t = cmv_mul(v1, s1)
    lo0, lo1 = cmv_mul(v0, s0)
    r0, r1 = cmv_mul(t, R)
    hi_a, hi_b = cmv_mul(v0, s1)
    hi_c, hi_d = cmv_mul(v1, s0)
    return torch.stack([(lo0 + r0) % P, (lo1 + r1) % P,
                        (hi_a + hi_c) % P, (hi_b + hi_d) % P])


# -- circle points -----------------------------------------------------------

def m31_point_add(p, r):
    return ((p[0] * r[0] - p[1] * r[1]) % P, (p[0] * r[1] + p[1] * r[0]) % P)


def point_of_index(index: int) -> Tuple[int, int]:
    """GEN * index, the point of a circle-group index mod 2^31."""
    index %= 1 << CIRCLE_LOG_ORDER
    out, base = (1, 0), GEN
    while index:
        if index & 1:
            out = m31_point_add(out, base)
        base = m31_point_add(base, base)
        index >>= 1
    return out


def subgroup_gen_index(log_size: int) -> int:
    return 1 << (CIRCLE_LOG_ORDER - log_size)


def coset_points(initial_index: int, step_index: int, log_size: int,
                 device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x, y) of initial + i * step for i < 2^log_size, as int64 tensors."""
    x0, y0 = point_of_index(initial_index)
    xs = torch.tensor([x0], dtype=torch.int64, device=device)
    ys = torch.tensor([y0], dtype=torch.int64, device=device)
    for j in range(log_size):
        sx, sy = point_of_index(step_index << j)
        xs, ys = (torch.cat([xs, (xs * sx - ys * sy) % P]),
                  torch.cat([ys, (xs * sy + ys * sx) % P]))
    return xs, ys


def bit_reverse(log_size: int, device) -> torch.Tensor:
    """The permutation i -> bit-reversal of i over log_size bits."""
    idx = torch.arange(1 << log_size, dtype=torch.int64, device=device)
    out = torch.zeros_like(idx)
    for b in range(log_size):
        out |= ((idx >> b) & 1) << (log_size - 1 - b)
    return out


class CanonicDomain:
    """The circle domain of a canonic coset of 2^log points: the half coset
    H = {G_{log+1} + i G_{log-1}} and its conjugate, in that (natural) order."""

    def __init__(self, log_size: int):
        self.log_size = log_size
        self.half_initial = subgroup_gen_index(log_size + 1)
        self.half_step = subgroup_gen_index(log_size - 1)

    def points(self, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """Natural order."""
        xs, ys = coset_points(self.half_initial, self.half_step,
                              self.log_size - 1, device)
        return torch.cat([xs, xs]), torch.cat([ys, (-ys) % P])

    def points_bitrev(self, device) -> Tuple[torch.Tensor, torch.Tensor]:
        xs, ys = self.points(device)
        perm = bit_reverse(self.log_size, device)
        return xs[perm], ys[perm]


def double_x(x):
    return (2 * (x * x % P) - 1) % P


# -- circle FFT ----------------------------------------------------------------
# Values of a circle evaluation lie in bit-reversed domain order; the
# coefficients of a circle polynomial in the basis whose index bit 0 picks
# y, bit 1 picks x and bit b > 1 picks pi^(b-1)(x), pi(x) = 2x^2 - 1.  Layer
# 0 of the transform joins the pairs (p, conj p) with twiddle y(p); layer
# l >= 1 joins blocks of 2^(l+1) values with twiddle pi^(l-1)(x) of the
# block's first point.

def fft_twiddles(log_size: int, device) -> List[torch.Tensor]:
    """Twiddles of layers 0 .. log_size - 1 of a canonic domain."""
    xs, ys = CanonicDomain(log_size).points_bitrev(device)
    out = [ys[0::2]]
    cur = xs[0::4]
    for layer in range(1, log_size):
        if layer > 1:
            cur = double_x(cur[0::2])
        out.append(cur)
    return out


def evaluate(coeffs: torch.Tensor, log_size: int) -> torch.Tensor:
    """Coefficients [B, m] (m <= 2^log_size, zero-extended) -> values
    [B, 2^log_size] on the canonic domain, bit-reversed order."""
    n = 1 << log_size
    b, m = coeffs.shape
    v = torch.zeros((b, n), dtype=torch.int64, device=coeffs.device)
    v[:, :m] = coeffs
    tw = fft_twiddles(log_size, coeffs.device)
    for layer in range(log_size - 1, -1, -1):
        blocks = v.view(b, n >> (layer + 1), 2, 1 << layer)
        t = tw[layer][None, :, None]
        lo, hi = blocks[:, :, 0, :], blocks[:, :, 1, :]
        prod = (hi * t) % P
        v = torch.stack([(lo + prod) % P, (lo - prod) % P], dim=2).view(b, n)
    return v


def interpolate(values: torch.Tensor, log_size: int) -> torch.Tensor:
    """Values [B, 2^log_size] in bit-reversed domain order -> coefficients."""
    n = 1 << log_size
    b = values.shape[0]
    v = values.to(torch.int64)
    tw = fft_twiddles(log_size, values.device)
    for layer in range(log_size):
        blocks = v.view(b, n >> (layer + 1), 2, 1 << layer)
        it = vinv(tw[layer])[None, :, None]
        lo, hi = blocks[:, :, 0, :], blocks[:, :, 1, :]
        v = torch.stack([(lo + hi) % P, ((lo - hi) * it) % P],
                        dim=2).view(b, n)
    return (v * pow(n, P - 2, P)) % P


def basis_at_point(px: QM31, py: QM31, log_size: int,
                   device) -> torch.Tensor:
    """[4, 2^log_size]: the value of every basis monomial at the QM31 point
    (px, py); a polynomial's value there is sum_i c_i basis_i."""
    mappings = [py]
    x = px
    for _ in range(1, log_size):
        mappings.append(x)
        x = q_sub(q_add(q_mul(x, x), q_mul(x, x)), q(1))
    basis = torch.tensor([[1], [0], [0], [0]], dtype=torch.int64,
                         device=device)
    for f in reversed(mappings):
        scaled = qv_mul_scalar(basis, f)
        basis = torch.stack([basis, scaled], dim=2).reshape(4, -1)
    return basis


def eval_at_point(coeffs: torch.Tensor, px: QM31, py: QM31,
                  log_size: int) -> List[QM31]:
    """Base-field polynomials [B, 2^log_size] at a QM31 point."""
    basis = basis_at_point(px, py, log_size, coeffs.device)
    coords = [((coeffs * basis[k][None, :]) % P).sum(dim=1) % P
              for k in range(4)]
    stacked = torch.stack(coords, dim=1).tolist()
    return [tuple(row) for row in stacked]
