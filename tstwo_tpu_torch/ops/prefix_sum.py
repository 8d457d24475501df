"""Inclusive prefix sum over M31/QM31 columns (Rust stwo uses prefix sums
for the LogUp interaction columns).

A prefix sum of canonical values (< 2^31) in int64 stays below 2^63 for
fewer than 2^32 terms, so one `torch.cumsum` followed by `% P` is exact:
one launch where the JAX package runs a log-depth Hillis-Steele scan.
An exclusive variant and a bit-reversed-circle-domain variant serve the
interaction-trace generator.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..utils import upload
from . import m31
from .m31 import P


def inclusive_prefix_sum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive scan along the last axis (values in [0, P))."""
    return m31.narrow(torch.cumsum(x.to(torch.int64), dim=-1) % P)


def exclusive_prefix_sum(x: torch.Tensor) -> torch.Tensor:
    return m31.sub(inclusive_prefix_sum(x), x)


@lru_cache(maxsize=None)
def _coset_order_perms(log_size: int):
    """(committed->coset gather perm, its inverse) as int32 numpy arrays.

    Committed columns are in bit-reversed circle-domain order; the LogUp
    cumulative column telescopes along the *coset* order p, p+step, ...
    (Rust stwo simd prefix_sum.rs operates on the same layout).
    perm[k] = bit_reverse_index(coset_index_to_circle_domain_index(k)),
    computed for all k at once."""
    from ..utils import bit_reverse_permutation

    n = 1 << log_size
    k = np.arange(n, dtype=np.int64)
    circle = np.where(k % 2 == 0, k // 2, (2 * n - k) >> 1)
    perm = bit_reverse_permutation(log_size)[circle].astype(np.int32)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(n, dtype=np.int32)
    return perm, inv


def inclusive_prefix_sum_bit_rev_circle(x: torch.Tensor,
                                        log_size: int) -> torch.Tensor:
    """Inclusive prefix sum *in coset order* of a column stored in
    bit-reversed circle-domain order (any leading dims; last axis = rows)."""
    perm, inv = (upload(torch.from_numpy(p).to(torch.int64), x.device)
                 for p in _coset_order_perms(log_size))
    summed = inclusive_prefix_sum(x.index_select(-1, perm))
    return summed.index_select(-1, inv)
