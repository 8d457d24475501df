"""Field-expression wrappers for domain evaluation.

User constraint code (FrameworkEval.evaluate) is written once against the
EvalAtRow interface; on the domain path its `F` values are whole device
columns.  These wrappers give int32 tensors field-arithmetic operator
overloading (the analog of the reference's packed SIMD row types,
backend/simd/m31.ts) so the same Python constraint expression runs over
all rows at once.
"""
from __future__ import annotations

from typing import Union

import torch

from ..fields import M31, QM31
from ..ops import m31 as m31_ops
from ..ops import qm31 as qm31_ops


class BaseExpr:
    """A base-field column expression (int32 [n])."""

    __slots__ = ("arr",)

    def __init__(self, arr: torch.Tensor):
        self.arr = arr

    def _coerce(self, other):
        if isinstance(other, BaseExpr):
            return other.arr, False
        if isinstance(other, SecureExpr):
            return other.arr, True
        if isinstance(other, M31):
            return other.value, False
        if isinstance(other, int):
            return other % ((1 << 31) - 1), False
        if isinstance(other, QM31):
            return qm31_ops.scalar(other, device=self.arr.device)[:, None], True
        return NotImplemented, None

    def __add__(self, other):
        arr, secure = self._coerce(other)
        if arr is NotImplemented:
            return NotImplemented
        if secure:
            return SecureExpr(qm31_ops.add(qm31_ops.from_m31(self.arr), arr))
        return BaseExpr(m31_ops.add(self.arr, arr))

    __radd__ = __add__

    def __sub__(self, other):
        arr, secure = self._coerce(other)
        if arr is NotImplemented:
            return NotImplemented
        if secure:
            return SecureExpr(qm31_ops.sub(qm31_ops.from_m31(self.arr), arr))
        return BaseExpr(m31_ops.sub(self.arr, arr))

    def __rsub__(self, other):
        return (-self) + other

    def __mul__(self, other):
        arr, secure = self._coerce(other)
        if arr is NotImplemented:
            return NotImplemented
        if secure:
            return SecureExpr(qm31_ops.mul(qm31_ops.from_m31(self.arr), arr))
        return BaseExpr(m31_ops.mul(self.arr, arr))

    __rmul__ = __mul__

    def __neg__(self):
        return BaseExpr(m31_ops.neg(self.arr))

    def square(self):
        return self * self


class SecureExpr:
    """A secure-field column expression (int32 [4, n])."""

    __slots__ = ("arr",)

    def __init__(self, arr: torch.Tensor):
        self.arr = arr

    def _coerce(self, other):
        if isinstance(other, SecureExpr):
            return other.arr
        if isinstance(other, BaseExpr):
            return qm31_ops.from_m31(other.arr)
        dev = self.arr.device
        if isinstance(other, QM31):
            return qm31_ops.scalar(other, device=dev)[:, None]
        if isinstance(other, M31):
            return qm31_ops.scalar(QM31.from_base(other), device=dev)[:, None]
        if isinstance(other, int):
            return qm31_ops.scalar(QM31.from_base(M31.from_int(other)),
                                   device=dev)[:, None]
        return NotImplemented

    def __add__(self, other):
        arr = self._coerce(other)
        if arr is NotImplemented:
            return NotImplemented
        return SecureExpr(qm31_ops.add(self.arr, arr))

    __radd__ = __add__

    def __sub__(self, other):
        arr = self._coerce(other)
        if arr is NotImplemented:
            return NotImplemented
        return SecureExpr(qm31_ops.sub(self.arr, arr))

    def __rsub__(self, other):
        return (-self) + other

    def __mul__(self, other):
        arr = self._coerce(other)
        if arr is NotImplemented:
            return NotImplemented
        return SecureExpr(qm31_ops.mul(self.arr, arr))

    __rmul__ = __mul__

    def __neg__(self):
        return SecureExpr(qm31_ops.neg(self.arr))
