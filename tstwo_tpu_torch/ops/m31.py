"""Elementwise M31 (GF(2^31-1)) arithmetic on torch tensors.

Columns are `torch.int32` tensors holding canonical values in [0, P): the
same bits as the JAX package's uint32 arrays.  Arithmetic widens to int64,
where a product of two canonical values (< 2^62) is exact, reduces with
`% P`, and narrows back.  The `*_w` functions work on int64 ("wide")
canonical values and are what the CM31/QM31 ops chain, so a QM31 product
widens and narrows once instead of per M31 step.

Plain PyTorch on purpose: these run on whatever device the tensors live on
(the CUDA kernels in csrc/ have their own `m31_mul` in m31.cuh).
"""
from __future__ import annotations

import numpy as np
import torch

P = (1 << 31) - 1


def wide(x):
    """int32 tensor -> int64 tensor; Python/numpy ints -> int."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64)
    return int(x)


def narrow(x: torch.Tensor) -> torch.Tensor:
    """Canonical int64 values -> int32 tensor (same values)."""
    return x.to(torch.int32)


# -- wide (int64, canonical in and out) -------------------------------------

def add_w(a, b):
    return (a + b) % P


def sub_w(a, b):
    return (a + (P - b)) % P


def neg_w(a):
    return (P - a) % P


def mul_w(a, b):
    return (a * b) % P


# -- int32 in, int32 out ----------------------------------------------------

def add(a, b):
    return narrow(add_w(wide(a), wide(b)))


def sub(a, b):
    return narrow(sub_w(wide(a), wide(b)))


def neg(a):
    return narrow(neg_w(wide(a)))


def mul(a, b):
    return narrow(mul_w(wide(a), wide(b)))


def square(a):
    return mul(a, a)


def double(a):
    return add(a, a)


def pow_w(v, e: int):
    """v**e for a static exponent, on wide values."""
    r = torch.ones_like(v)
    base = v
    while e:
        if e & 1:
            r = mul_w(r, base)
        base = mul_w(base, base)
        e >>= 1
    return r


def pow_const(v, e: int):
    """v**e for a static exponent (int32 in and out)."""
    return narrow(pow_w(wide(v), e))


def inv_w(v):
    """v^(P-2); inv(0) = 0 by convention."""
    return pow_w(v, P - 2)


def inv(v):
    return narrow(inv_w(wide(v)))


# ---------------------------------------------------------------------------
# Host (numpy, uint64) inverse -- used for twiddle precompute.
# ---------------------------------------------------------------------------

def np_inv(a: np.ndarray) -> np.ndarray:
    """Batch inverse via pow chain on u64 (exact)."""
    r = np.ones_like(a, dtype=np.uint64)
    base = a.astype(np.uint64)
    e = P - 2
    while e:
        if e & 1:
            r = (r * base) % P
        base = (base * base) % P
        e >>= 1
    return r.astype(np.uint32)
