"""Elementwise QM31 = CM31[u]/(u^2 - (2+i)) arithmetic.

A QM31 tensor is stacked on dim 0 as (c0.re, c0.im, c1.re, c1.im): shape
(4, ...), the SecureColumnByCoords SoA layout.  Public functions take and
return int32; products run on wide int64 stacks (see ops/m31.py).
"""
from __future__ import annotations

import numpy as np
import torch

from . import cm31, m31
from .m31 import add_w, narrow, sub_w, wide


def add(x, y):
    return m31.add(x, y)


def sub(x, y):
    return m31.sub(x, y)


def neg(x):
    return m31.neg(x)


def _mul_by_r_w(x2):
    """Multiply a wide CM31 stack by R = 2 + i: (2a - b) + (a + 2b)i."""
    a, b = x2[0], x2[1]
    return torch.stack([sub_w(add_w(a, a), b), add_w(a, add_w(b, b))])


def mul_w(x, y):
    """Karatsuba over CM31: with m1 = ac, m2 = bd, m3 = (a+b)(c+d),
    lo = m1 + R*m2 and hi = m3 - m1 - m2 (exact, value-identical to the
    schoolbook product)."""
    a, b = x[:2], x[2:]
    c, d = y[:2], y[2:]
    m1 = cm31.mul_w(a, c)
    m2 = cm31.mul_w(b, d)
    m3 = cm31.mul_w(add_w(a, b), add_w(c, d))
    lo = add_w(m1, _mul_by_r_w(m2))
    hi = sub_w(m3, add_w(m1, m2))
    return torch.cat([lo, hi], dim=0)


def mul(x, y):
    return narrow(mul_w(wide(x), wide(y)))


def mul_cm31(x, s2):
    xw, sw = wide(x), wide(s2)
    return narrow(torch.cat([cm31.mul_w(xw[:2], sw), cm31.mul_w(xw[2:], sw)],
                            dim=0))


def square(x):
    return mul(x, x)


def inv(x):
    xw = wide(x)
    a, b = xw[:2], xw[2:]
    b2 = cm31.mul_w(b, b)
    ib2 = torch.stack([m31.neg_w(b2[1]), b2[0]])
    denom = sub_w(cm31.mul_w(a, a), add_w(add_w(b2, b2), ib2))
    dinv = cm31.inv_w(denom)
    return narrow(torch.cat([cm31.mul_w(a, dinv),
                             cm31.mul_w(m31.neg_w(b), dinv)], dim=0))


def conj(x):
    """Galois conjugation u -> -u: (c0, -c1)."""
    return torch.stack([x[0], x[1], m31.neg(x[2]), m31.neg(x[3])])


def from_m31(a):
    z = torch.zeros_like(a)
    return torch.stack([a, z, z, z])


def scalar(q, shape=(), device="cpu"):
    """A host QM31 (or its 4 ints) as an int32 [4, 1, ...] tensor that
    broadcasts against [4, *shape] (or [4] when shape is empty)."""
    vals = np.asarray(q.to_ints() if hasattr(q, "to_ints") else q,
                      dtype=np.int64).astype(np.int32)
    out = torch.from_numpy(vals).to(device).reshape(4, *([1] * len(shape)))
    return out.expand(4, *shape) if shape else out


def zeros(shape, device="cpu"):
    return torch.zeros((4, *shape), dtype=torch.int32, device=device)
