"""Multilinear extensions, stored bit-reversed over the boolean hypercube.

A secure-field MLE holds an int32 [4, n] QM31 tensor; a base-field MLE an
int32 [n] tensor.  Tensors stay on the device they were given unless a
`device` is named; numpy arrays and host values go to `device`, CUDA
device 0 unless named (`utils.entry_device`).  Fixing a variable folds
through `gkr_kernels.fold`, one `mle_fold` launch for a CUDA tensor.
reference lookups/mle.ts.
"""
from __future__ import annotations

from typing import List, Sequence, Union

import numpy as np
import torch

from ..fields import M31, QM31
from ..utils import entry_device, to_torch_u32
from . import npqm31
from .gkr_kernels import fold
from .utils import UnivariatePoly

Evals = Union[torch.Tensor, np.ndarray]


def _as_int32(arr: Evals, device=None) -> torch.Tensor:
    if isinstance(arr, torch.Tensor):
        if arr.dtype != torch.int32:
            raise TypeError(f"expected an int32 tensor, got {arr.dtype}")
        return arr if device is None else arr.to(device)
    return to_torch_u32(np.asarray(arr).astype(np.uint32),
                        entry_device(device))


class Mle:
    """Secure-field MLE: evals int32 [4, 2^n]."""

    def __init__(self, evals: Union[Evals, Sequence[QM31]], device=None):
        if isinstance(evals, (torch.Tensor, np.ndarray)):
            self.evals = _as_int32(evals, device)
        else:
            self.evals = npqm31.from_qm31_list(list(evals), device)
        n = self.evals.shape[1]
        if n == 0 or (n & (n - 1)):
            raise ValueError("number of evaluations must be a power of two")

    def n_variables(self) -> int:
        return int(self.evals.shape[1]).bit_length() - 1

    def __len__(self) -> int:
        return int(self.evals.shape[1])

    def at(self, i: int) -> QM31:
        if not 0 <= i < len(self):
            raise IndexError(f"index {i} out of bounds for {len(self)} evals")
        return QM31.from_ints(self.evals[:, i].tolist())

    def into_evals(self) -> List[QM31]:
        return npqm31.to_qm31_list(self.evals)

    def eval_at_point(self, point: Sequence[QM31]) -> QM31:
        """Fold halves by eq(0,p)/eq(1,p) weights (reference mle.ts:81-113).

        point[0] corresponds to the most significant hypercube variable.
        """
        if len(point) != self.n_variables():
            raise ValueError(
                f"point has {len(point)} coordinates, MLE has "
                f"{self.n_variables()} variables")
        arr = self.evals
        for p in point:
            arr = fold(arr, p)
        return QM31.from_ints(arr[:, 0].tolist())

    def fix_first_variable(self, assignment: QM31) -> "Mle":
        return Mle(fold(self.evals, assignment))


class BaseMle:
    """Base-field MLE: evals int32 [2^n]."""

    def __init__(self, evals: Union[Evals, Sequence[M31]], device=None):
        if isinstance(evals, (torch.Tensor, np.ndarray)):
            self.evals = _as_int32(evals, device)
        else:
            self.evals = to_torch_u32(
                np.array([e.value for e in evals], dtype=np.uint32),
                entry_device(device))
        n = len(self.evals)
        if n == 0 or (n & (n - 1)):
            raise ValueError("number of evaluations must be a power of two")

    def n_variables(self) -> int:
        return int(len(self.evals)).bit_length() - 1

    def __len__(self) -> int:
        return len(self.evals)

    def at(self, i: int) -> M31:
        return M31(int(self.evals[i]))

    def to_secure(self) -> Mle:
        z = torch.zeros_like(self.evals)
        return Mle(torch.stack([self.evals, z, z, z]))

    def fix_first_variable(self, assignment: QM31) -> Mle:
        return Mle(fold(self.evals, assignment))


class SecureMle(Mle):
    """Mle that is also a MultivariatePolyOracle (reference mle.ts:149-200)."""

    def sum_as_poly_in_first_variable(self, claim: QM31) -> UnivariatePoly:
        half = self.evals.shape[1] // 2
        y0 = npqm31.sum_all(self.evals[:, :half])
        y1 = claim - y0
        return UnivariatePoly.interpolate_lagrange(
            [QM31.zero(), QM31.one()], [y0, y1])

    def fix_first_variable(self, assignment: QM31) -> "SecureMle":
        return SecureMle(super().fix_first_variable(assignment).evals)
