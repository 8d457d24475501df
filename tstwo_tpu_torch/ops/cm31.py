"""Elementwise CM31 = M31[i]/(i^2+1) arithmetic.

A CM31 tensor is stacked on dim 0 as (real, imag): shape (2, ...), the
SecureColumnByCoords layout.  Public functions take and return int32;
the `*_w` forms work on wide int64 stacks (see ops/m31.py).
"""
from __future__ import annotations

import torch

from . import m31
from .m31 import add_w, narrow, neg_w, sub_w, wide


def add(x, y):
    return m31.add(x, y)


def sub(x, y):
    return m31.sub(x, y)


def neg(x):
    return m31.neg(x)


def mul_w(x, y):
    """Gauss 3-multiplication product: re = ac - bd,
    im = (a+b)(c+d) - ac - bd (value-identical to schoolbook)."""
    a, b = x[0], x[1]
    c, d = y[0], y[1]
    m1 = m31.mul_w(a, c)
    m2 = m31.mul_w(b, d)
    m3 = m31.mul_w(add_w(a, b), add_w(c, d))
    return torch.stack([sub_w(m1, m2), sub_w(m3, add_w(m1, m2))])


def mul(x, y):
    return narrow(mul_w(wide(x), wide(y)))


def square(x):
    return mul(x, x)


def conj(x):
    return torch.stack([x[0], m31.neg(x[1])])


def inv_w(x):
    # 1/(a+bi) = (a-bi)/(a^2+b^2)
    norm = add_w(m31.mul_w(x[0], x[0]), m31.mul_w(x[1], x[1]))
    ninv = m31.inv_w(norm)
    return torch.stack([m31.mul_w(x[0], ninv), m31.mul_w(neg_w(x[1]), ninv)])


def inv(x):
    return narrow(inv_w(wide(x)))


