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

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from .. import kernels
from ..utils import bit_reverse_permutation, upload
from . import m31


def bit_reverse(values: torch.Tensor, log_size: int) -> torch.Tensor:
    """Permute the last axis into bit-reversed order."""
    if values.shape[-1] != 1 << log_size:
        raise ValueError("size mismatch")
    if log_size <= 1:
        return values
    perm = upload(torch.from_numpy(bit_reverse_permutation(log_size)),
                  values.device)
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
              circle_twiddles: torch.Tensor, inverse: bool,
              scale: Optional[int] = None) -> torch.Tensor:
    """The layered CFFT in plain PyTorch, on any device: the CPU path, and
    the version the CUDA kernel is held against.  `scale` (an M31 value,
    the inverse's 1/N) multiplies the result after the last layer; None or
    1 leaves it as it is."""
    n_log = len(line_twiddles) + 1
    if not inverse:
        for l in range(n_log - 1, 0, -1):
            values = _butterfly_layer(values, l, line_twiddles[l - 1], False)
        values = _butterfly_layer(values, 0, circle_twiddles, False)
    else:
        values = _butterfly_layer(values, 0, circle_twiddles, True)
        for l in range(1, n_log):
            values = _butterfly_layer(values, l, line_twiddles[l - 1], True)
    if scale is not None and scale != 1:
        values = m31.mul(values, scale)
    return values


def twiddle_buffer(line_twiddles: Sequence[torch.Tensor],
                   circle_twiddles: torch.Tensor) -> torch.Tensor:
    """The kernel's twiddle layout: the circle layer, then line layers
    1..n_log-1, concatenated (layer l starts at n - (n >> l))."""
    return torch.cat([circle_twiddles, *line_twiddles]).contiguous()


# The kernel's schedule (csrc/cfft.cu computes the same one).  A contiguous
# pass gives a block 2^CHUNK_LOG consecutive words (2^SMALL_CHUNK_LOG for a
# transform of at most that many points); a strided pass over k layers
# gives it 2^k rows by max(MIN_WIDTH, 2^CHUNK_LOG / 2^k) words.
CHUNK_LOG = 12
SMALL_CHUNK_LOG = 10
MAX_STRIDED_LOG = 10
MIN_STRIDED_LOG = 4
MIN_WIDTH = 8
SHARED_BYTES = 32 << 10   # the shared memory the source declares for a tile
MAX_LOG_N = 30


def cfft_plan(log_n: int, inverse: bool) -> List[Tuple[str, int, int,
                                                       Tuple[int, int]]]:
    """The passes of one transform of 2^log_n points, in launch order:
    (kind, first layer, number of layers, (rows, words) of a block's tile).

    Each pass reads its tile from device memory once, does its layers on
    chip and writes once.  The inverse does layers 0 .. log_n-1, so its
    contiguous pass comes first; the forward runs the same passes in the
    reverse order."""
    if not 1 <= log_n <= MAX_LOG_N:
        raise ValueError(f"log_n must be in 1..{MAX_LOG_N}")

    def contiguous(layers):
        small = log_n <= SMALL_CHUNK_LOG
        return ("contiguous", 0, layers,
                (1, 1 << (SMALL_CHUNK_LOG if small else CHUNK_LOG)))

    def strided(first, k):
        return ("strided", first, k,
                (1 << k, max(MIN_WIDTH, 1 << (CHUNK_LOG - k))))

    if log_n <= CHUNK_LOG:
        plan = [contiguous(log_n)]
    elif log_n <= CHUNK_LOG + MAX_STRIDED_LOG:
        k = max(MIN_STRIDED_LOG, log_n - CHUNK_LOG)
        plan = [contiguous(log_n - k), strided(log_n - k, k)]
    else:
        ka = (log_n - CHUNK_LOG) // 2
        plan = [contiguous(CHUNK_LOG), strided(CHUNK_LOG, ka),
                strided(CHUNK_LOG + ka, log_n - CHUNK_LOG - ka)]
    return plan if inverse else plan[::-1]


def cfft_kernel_plan(batch: int, log_n: int, inverse: bool) -> List[tuple]:
    """What the built library will launch for one transform: `cfft_plan`'s
    tuples with the columns a block walks over appended.  Needs the
    kernels (a CUDA machine)."""
    out = (ctypes.c_int * 18)()
    count = kernels.entry("cfft_describe")(batch, log_n, int(inverse), out)
    return [("contiguous" if out[6 * i] else "strided", out[6 * i + 1],
             out[6 * i + 2], (out[6 * i + 3], out[6 * i + 4]), out[6 * i + 5])
            for i in range(count)]


def cfft_kernel_launches() -> int:
    """Kernel launches the library's CFFT entry has made so far."""
    return kernels.entry("cfft_kernel_launches")()


def cfft_cuda(values: torch.Tensor, twiddles: torch.Tensor, n_log: int,
              inverse: bool, scale: Optional[int] = None,
              coeff_len: Optional[int] = None) -> torch.Tensor:
    """Launch csrc/cfft.cu on a contiguous CUDA [..., m] int32 tensor and
    return a new [..., 2^n_log] one; `twiddles` is a `twiddle_buffer` on the
    same device.  m is 2^n_log, or for the forward transform the
    coefficient length `coeff_len`, a power of two up to 2^n_log: the
    kernel reads the coefficients past it as zero.  The inverse multiplies
    its result by `scale` (an M31 value) in its last pass."""
    kernels.check_cuda_tensor(values, "values")
    kernels.check_cuda_tensor(twiddles, "twiddles")
    n = 1 << n_log
    m = n if coeff_len is None else coeff_len
    if not 1 <= n_log <= MAX_LOG_N:
        raise ValueError(f"n_log must be in 1..{MAX_LOG_N}")
    if m < 1 or m & (m - 1) or m > n or (inverse and m != n):
        raise ValueError(f"coefficient length {m} must be a power of two up "
                         f"to 2^{n_log} (and 2^{n_log} for the inverse)")
    if values.dim() < 1 or values.shape[-1] != m:
        raise ValueError(f"values must end in {m} points")
    if twiddles.numel() != n - 1 or twiddles.device != values.device:
        raise ValueError("twiddle buffer does not match the transform")
    scale = 1 if scale is None else int(scale)
    if not 0 <= scale < m31.P or (scale != 1 and not inverse):
        raise ValueError("scale must be an M31 value, and 1 for the forward "
                         "transform")
    batch = values.numel() // m
    if batch > 65535:
        raise ValueError("batch exceeds the grid's y dimension")
    out = torch.empty(values.shape[:-1] + (n,), dtype=torch.int32,
                      device=values.device)
    if batch:
        kernels.launch("cfft", "cfft_inverse" if inverse else "cfft_forward",
                       values.device, values.data_ptr(),
                       out.data_ptr(), twiddles.data_ptr(), batch, n_log,
                       m.bit_length() - 1, int(inverse), scale)
    return out


def _transform(values, line, circle, buffer, inverse, scale=None):
    n = 2 * circle.shape[-1]
    if kernels.on_cuda(values):
        if buffer is None:
            buffer = twiddle_buffer(line, circle)
        if not values.is_contiguous():
            values = values.contiguous()
        return cfft_cuda(values, buffer, len(line) + 1, inverse, scale,
                         values.shape[-1])
    if values.shape[-1] < n and not inverse:
        values = F.pad(values, (0, n - values.shape[-1]))
    return fft_plain(values, line, circle, inverse, scale)


def fft_natural_to_bitrev(values: torch.Tensor,
                          line_twiddles: Sequence[torch.Tensor],
                          circle_twiddles: torch.Tensor,
                          buffer: torch.Tensor = None) -> torch.Tensor:
    """Forward CFFT: coefficients (natural) -> evaluations (bit-reversed).
    `values` may end in fewer coefficients than the domain has points (a
    power of two): they are zero-extended, inside the kernel on a CUDA
    device.  `buffer` is the cached `twiddle_buffer` of the same twiddles,
    if any."""
    return _transform(values, line_twiddles, circle_twiddles, buffer, False)


def ifft_bitrev_to_natural(values: torch.Tensor,
                           line_itwiddles: Sequence[torch.Tensor],
                           circle_itwiddles: torch.Tensor,
                           buffer: torch.Tensor = None,
                           scale: Optional[int] = None) -> torch.Tensor:
    """Inverse CFFT (reference backend/cpu/circle.ts:186-199), multiplied
    by `scale` (the caller's 1/N as an M31 value) if given: inside the
    kernel on a CUDA device, after the last layer on the CPU."""
    return _transform(values, line_itwiddles, circle_itwiddles, buffer, True,
                      scale)


def fold(values: torch.Tensor, factors, mul_fn, add_fn) -> torch.Tensor:
    """Horner-like hierarchical fold (reference poly/utils.ts:36-59): the
    last axis has length 2^len(factors), and the factors apply from the
    innermost (adjacent pairs) to the outermost.  Each step splits the
    pairs with `fri_ops._deinterleave`, the hand kernel on a CUDA tensor."""
    from .fri_ops import _deinterleave

    for f in factors:
        v0, v1 = _deinterleave(values)
        values = add_fn(v0, mul_fn(v1, f))
    return values[..., 0]
