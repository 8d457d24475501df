"""Host-side polynomial utilities (reference src/poly/utils.ts):
repeat_value, recursive fold, and flat-buffer line-twiddle slicing.

These are the scalar reference recipes; the device path uses
`twiddles.TwiddleTree` layers directly.
"""
from __future__ import annotations

from typing import List, Sequence, TypeVar

T = TypeVar("T")


def repeat_value(values: Sequence[T], duplicity: int) -> List[T]:
    """[a, b] x3 -> [a, a, a, b, b, b] (reference poly/utils.ts:64)."""
    out: List[T] = []
    for v in values:
        out.extend([v] * duplicity)
    return out


def fold(values: Sequence, folding_factors: Sequence):
    """Recursive binary fold: fold(lhs) + fold(rhs) * factors[0]
    (reference poly/utils.ts:36; Rust utils::fold).  len(values) must be
    2^len(folding_factors)."""
    n = len(values)
    if n != 1 << len(folding_factors):
        raise ValueError("fold: invalid input lengths")
    if n == 1:
        return values[0]
    half = n // 2
    lhs = fold(values[:half], folding_factors[1:])
    rhs = fold(values[half:], folding_factors[1:])
    return lhs + rhs * folding_factors[0]


def domain_line_twiddles_from_tree(domain, buffer: Sequence[T]) -> List[List[T]]:
    """Slice a flat twiddle buffer into per-level lists, largest level
    first (reference poly/utils.ts domainLineTwiddlesFromTree): level i
    (from the smallest, size 2^i) is buffer[L-2*2^i : L-2^i] where L is
    the buffer length.  `domain` is a LineDomain (or CircleDomain, whose
    line domain has a coset of half its size)."""
    coset = domain.coset if not hasattr(domain, "half_coset") else None
    if coset is None:  # CircleDomain
        log = domain.log_size() - 1
        size = 1 << log
    else:
        log = coset.log_size
        size = coset.size()
    if size > len(buffer):
        raise ValueError("Not enough twiddles!")
    out: List[List[T]] = []
    total = len(buffer)
    for i in range(log):
        length = 1 << i
        out.insert(0, list(buffer[total - 2 * length:total - length]))
    return out
