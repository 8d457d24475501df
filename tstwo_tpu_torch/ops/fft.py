"""Circle FFT (CFFT) on int32 tensors.

The transform maps circle-polynomial coefficients (natural order, in the
basis {1,y} x {1,x} x {1,pi(x)} x ...) to evaluations on a CircleDomain in
bit-reversed order, via log2(N)-1 line-twiddle butterfly layers plus one
circle-twiddle layer (reference backend/cpu/circle.ts:84-207).

Values are int32 tensors whose LAST axis is the point axis; leading axes
(a batch of columns, the 4 QM31 coordinates) run as a batch.  A CUDA
tensor goes through the hand-written kernel csrc/cfft.cu; a CPU tensor
through `fft_plain`, the layered PyTorch version of the same transform.
"""
from __future__ import annotations

from typing import Sequence

import torch

from .. import kernels
from ..utils import bit_reverse_permutation
from . import m31


def bit_reverse(values: torch.Tensor, log_size: int) -> torch.Tensor:
    """Permute the last axis into bit-reversed order."""
    if values.shape[-1] != 1 << log_size:
        raise ValueError("size mismatch")
    if log_size <= 1:
        return values
    perm = torch.from_numpy(bit_reverse_permutation(log_size)).to(values.device)
    return values.index_select(-1, perm)


def _butterfly_layer(values: torch.Tensor, layer: int, twiddles: torch.Tensor,
                     inverse: bool) -> torch.Tensor:
    """Stride-2^layer (i)butterflies; element h*2^(layer+1) + j*2^layer + l
    pairs j=0 with j=1 under twiddle h (reference backend/cpu/circle.ts:243)."""
    lead = values.shape[:-1]
    n = values.shape[-1]
    stride = 1 << layer
    v = values.reshape(*lead, n // (2 * stride), 2, stride)
    t = twiddles[:, None]
    v0 = v[..., 0, :]
    v1 = v[..., 1, :]
    if not inverse:
        prod = m31.mul(v1, t)
        out = torch.stack([m31.add(v0, prod), m31.sub(v0, prod)], dim=-2)
    else:
        out = torch.stack([m31.add(v0, v1), m31.mul(m31.sub(v0, v1), t)],
                          dim=-2)
    return out.reshape(*lead, n)


def fft_plain(values: torch.Tensor, line_twiddles: Sequence[torch.Tensor],
              circle_twiddles: torch.Tensor, inverse: bool) -> torch.Tensor:
    """The layered CFFT in plain PyTorch, on any device: the CPU path, and
    the version the CUDA kernel is held against.  The inverse leaves out
    the 1/N scaling."""
    n_log = len(line_twiddles) + 1
    if not inverse:
        for l in range(n_log - 1, 0, -1):
            values = _butterfly_layer(values, l, line_twiddles[l - 1], False)
        return _butterfly_layer(values, 0, circle_twiddles, False)
    values = _butterfly_layer(values, 0, circle_twiddles, True)
    for l in range(1, n_log):
        values = _butterfly_layer(values, l, line_twiddles[l - 1], True)
    return values


def twiddle_buffer(line_twiddles: Sequence[torch.Tensor],
                   circle_twiddles: torch.Tensor) -> torch.Tensor:
    """The kernel's twiddle layout: the circle layer, then line layers
    1..n_log-1, concatenated (layer l starts at n - (n >> l))."""
    return torch.cat([circle_twiddles, *line_twiddles]).contiguous()


def cfft_cuda(values: torch.Tensor, twiddles: torch.Tensor, n_log: int,
              inverse: bool) -> torch.Tensor:
    """Launch csrc/cfft.cu on a contiguous CUDA [..., 2^n_log] int32 tensor;
    `twiddles` is a `twiddle_buffer` on the same device."""
    kernels.check_cuda_tensor(values, "values")
    kernels.check_cuda_tensor(twiddles, "twiddles")
    n = 1 << n_log
    if n_log < 1 or values.shape[-1] != n:
        raise ValueError(f"values must end in 2^{n_log} points")
    if twiddles.numel() != n - 1 or twiddles.device != values.device:
        raise ValueError("twiddle buffer does not match the transform")
    batch = values.numel() // n
    if batch > 65535:
        raise ValueError("batch exceeds the grid's y dimension")
    out = torch.empty_like(values)
    if batch:
        kernels.launch("cfft", "cfft_inverse" if inverse else "cfft_forward",
                       values.device, values.data_ptr(),
                       out.data_ptr(), twiddles.data_ptr(), batch, n_log,
                       int(inverse))
    return out


def _transform(values, line, circle, buffer, inverse):
    if kernels.on_cuda(values):
        if buffer is None:
            buffer = twiddle_buffer(line, circle)
        return cfft_cuda(values.contiguous(), buffer, len(line) + 1, inverse)
    return fft_plain(values, line, circle, inverse)


def fft_natural_to_bitrev(values: torch.Tensor,
                          line_twiddles: Sequence[torch.Tensor],
                          circle_twiddles: torch.Tensor,
                          buffer: torch.Tensor = None) -> torch.Tensor:
    """Forward CFFT: coefficients (natural) -> evaluations (bit-reversed).
    `buffer` is the cached `twiddle_buffer` of the same twiddles, if any."""
    return _transform(values, line_twiddles, circle_twiddles, buffer, False)


def ifft_bitrev_to_natural(values: torch.Tensor,
                           line_itwiddles: Sequence[torch.Tensor],
                           circle_itwiddles: torch.Tensor,
                           buffer: torch.Tensor = None) -> torch.Tensor:
    """Inverse CFFT without the final 1/N scaling
    (reference backend/cpu/circle.ts:186-199)."""
    return _transform(values, line_itwiddles, circle_itwiddles, buffer, True)

