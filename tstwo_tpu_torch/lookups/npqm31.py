"""QM31 column helpers for the lookups layer: thin wrappers over ops/qm31
in its int32 [4, n] coordinate-major layout, on the columns' device.
The MLE / GKR round structure stays host-driven; every hypercube-sized
operation runs where the columns live.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from ..fields import QM31
from ..ops import m31 as m31_ops
from ..ops import qm31 as qm31_ops
from ..utils import entry_device, to_numpy_u32, to_torch_u32

P = m31_ops.P


def from_qm31_list(vals: Sequence[QM31], device=None) -> torch.Tensor:
    """int32 [4, n] on `device`, CUDA device 0 unless named."""
    arr = np.array([v.to_ints() for v in vals], dtype=np.uint32)
    return to_torch_u32(arr.T.reshape(4, -1), entry_device(device))


def to_qm31_list(arr: torch.Tensor) -> List[QM31]:
    a = to_numpy_u32(arr)
    return [QM31.from_ints([int(a[c, i]) for c in range(4)])
            for i in range(a.shape[1])]


def scalar(v: QM31, n: int = 1, device=None) -> torch.Tensor:
    """v repeated n times as int32 [4, n] on `device` (as qm31.scalar)."""
    return qm31_ops.scalar(v, (n,), device).contiguous()


def add(x, y):
    return qm31_ops.add(x, y)


def sub(x, y):
    return qm31_ops.sub(x, y)


def neg(x):
    return m31_ops.neg(x)


def mul(x, y):
    return qm31_ops.mul(x, y)


def mul_scalar(x, v: QM31):
    return qm31_ops.mul(x, scalar(v, 1, x.device))


def double(x):
    return m31_ops.add(x, x)


def sum_all_arr(x: torch.Tensor) -> torch.Tensor:
    """Modular sum over the point axis -> int32 [4]: an int64 sum of fewer
    than 2^32 canonical values cannot overflow, then one `% P`."""
    return m31_ops.narrow(x.to(torch.int64).sum(dim=1) % P)


def sum_all(x: torch.Tensor) -> QM31:
    return QM31.from_ints(sum_all_arr(x).tolist())
