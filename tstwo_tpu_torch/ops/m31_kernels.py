"""M31 probe kernels: the elementwise product and the dependent product
chain that measure the card's M31 multiply rate.

`mul` and `mul_chain` launch csrc/m31_kernels.cu for a CUDA tensor and
take their plain PyTorch versions (`ops/m31.mul`, applied `reps` times for
the chain) for a CPU tensor.  They replace the Pallas kernels
tstwo_tpu/ops/pallas/m31_kernels.py::mul and ::mul_chain, which took only
N % 1024 == 0; these take any int32 [N] with N >= 1.
"""
from __future__ import annotations

import torch

from .. import kernels
from . import m31


def _check_pair(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.dim() != 1 or a.shape != b.shape or a.numel() == 0:
        raise ValueError(f"expected two int32 [N] tensors with N >= 1, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if a.device != b.device:
        raise ValueError(f"a is on {a.device}, b on {b.device}")


def _check_reps(reps: int) -> None:
    if reps < 0:
        raise ValueError(f"reps must be >= 0, got {reps}")


def mul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b mod P in plain PyTorch, on any device."""
    return m31.mul(a, b)


def mul_chain_plain(a: torch.Tensor, b: torch.Tensor,
                    reps: int = 8) -> torch.Tensor:
    """a * b^reps as `reps` dependent products, in plain PyTorch."""
    x = a
    for _ in range(reps):
        x = m31.mul(x, b)
    return x


def _launch(entry: str, a: torch.Tensor, b: torch.Tensor, *extra):
    kernels.check_cuda_tensor(a, "a")
    kernels.check_cuda_tensor(b, "b")
    out = torch.empty_like(a)
    kernels.launch(entry, entry, a.device, a.data_ptr(), b.data_ptr(),
                   out.data_ptr(), a.numel(), *extra)
    return out


def mul_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch csrc/m31_kernels.cu `m31_mul` on contiguous CUDA int32 [N]."""
    _check_pair(a, b)
    return _launch("m31_mul", a, b)


def mul_chain_cuda(a: torch.Tensor, b: torch.Tensor,
                   reps: int = 8) -> torch.Tensor:
    """Launch csrc/m31_kernels.cu `m31_mul_chain` on contiguous CUDA int32
    [N]: one read of a and b, `reps` dependent products, one write."""
    _check_pair(a, b)
    _check_reps(reps)
    return _launch("m31_mul_chain", a, b, reps)


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise M31 product of int32 [N] tensors."""
    _check_pair(a, b)
    if kernels.on_cuda(a):
        return mul_cuda(a.contiguous(), b.contiguous())
    return mul_plain(a, b)


def mul_chain(a: torch.Tensor, b: torch.Tensor, reps: int = 8) -> torch.Tensor:
    """`reps` dependent M31 products per element: a * b^reps."""
    _check_pair(a, b)
    _check_reps(reps)
    if kernels.on_cuda(a):
        return mul_chain_cuda(a.contiguous(), b.contiguous(), reps)
    return mul_chain_plain(a, b, reps)
