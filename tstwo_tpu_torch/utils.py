"""Index permutation helpers shared across the stack (host side).

reference: packages/core/src/utils.ts
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np


def bit_reverse_index(i: int, log_size: int) -> int:
    """Reverse the low `log_size` bits of i (reference utils.ts:15-22)."""
    if log_size == 0:
        return i
    return int(format(i, f"0{log_size}b")[::-1], 2)


def bit_reverse_permutation(log_size: int) -> np.ndarray:
    """perm[j] = bitrev(j); out = in[perm] converts natural <-> bit-reversed."""
    n = 1 << log_size
    idx = np.arange(n, dtype=np.int64)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(log_size):
        rev |= ((idx >> b) & 1) << (log_size - 1 - b)
    return rev


def bit_reverse_list(values: list) -> list:
    """Return values permuted into bit-reversed order."""
    n = len(values)
    if n & (n - 1):
        raise ValueError("length must be a power of two")
    log = n.bit_length() - 1
    perm = bit_reverse_permutation(log)
    return [values[int(p)] for p in perm]


def offset_bit_reversed_circle_domain_index(
    i: int, domain_log_size: int, eval_log_size: int, offset: int
) -> int:
    """reference utils.ts:109-126."""
    prev_index = bit_reverse_index(i, eval_log_size)
    half_size = 1 << (eval_log_size - 1)
    step_size = offset * (1 << (eval_log_size - domain_log_size - 1))
    if prev_index < half_size:
        prev_index = (prev_index + step_size) % half_size
    else:
        prev_index = (prev_index - step_size) % half_size + half_size
    return bit_reverse_index(prev_index, eval_log_size)


def previous_bit_reversed_circle_domain_index(
    i: int, domain_log_size: int, eval_log_size: int
) -> int:
    return offset_bit_reversed_circle_domain_index(i, domain_log_size, eval_log_size, -1)


def coset_index_to_circle_domain_index(coset_index: int, log_domain_size: int) -> int:
    """reference utils.ts:175-183."""
    if coset_index % 2 == 0:
        return coset_index // 2
    return ((2 << log_domain_size) - coset_index) >> 1


def circle_domain_index_to_coset_index(circle_index: int, log_domain_size: int) -> int:
    n = 1 << log_domain_size
    if circle_index < n // 2:
        return circle_index * 2
    return (n - 1 - circle_index) * 2 + 1


def to_torch_u32(arr, device="cpu"):
    """numpy uint32 array -> int32 tensor with the same bits, on `device`.

    M31 values (< 2^31) read the same either way; Blake2s words >= 2^31
    become negative int32 bit-views."""
    import torch

    a = np.ascontiguousarray(np.asarray(arr, dtype=np.uint32))
    return torch.from_numpy(a.view(np.int32).copy()).to(device)


def to_numpy_u32(t) -> np.ndarray:
    """int32 tensor (any device) -> numpy uint32 array with the same bits."""
    return t.detach().cpu().contiguous().numpy().view(np.uint32)
