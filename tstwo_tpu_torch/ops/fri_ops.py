"""FRI folding and decomposition on int32 tensors, and the deinterleave.

fold_line / fold_circle_into_line are inverse butterflies with precomputed
inverse twiddles plus an alpha-linear combination (reference fri.ts:120-192,
backend/cpu/fri.ts:23-92).  Values are QM31 SoA tensors [4, n] in
bit-reversed order; adjacent pairs are (p, -p) cosets.

`_deinterleave` -- the even/odd split every fold and Merkle level uses --
launches the hand-written kernel csrc/deinterleave.cu for a CUDA tensor
and takes `deinterleave_plain` for a CPU one.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .. import kernels
from . import m31, qm31


def deinterleave_plain(x: torch.Tensor):
    """(x[..., 0::2], x[..., 1::2]) in plain PyTorch, on any device."""
    return x[..., 0::2], x[..., 1::2]


def deinterleave_cuda(x: torch.Tensor):
    """Launch csrc/deinterleave.cu on a contiguous CUDA int32 tensor whose
    last axis is even; returns contiguous (even, odd)."""
    kernels.check_cuda_tensor(x, "x")
    n = x.shape[-1]
    if n % 2:
        raise ValueError("the last axis must have even length")
    if x.data_ptr() % 8:
        x = x.clone()  # the kernel loads 8-byte pairs
    lead = x.shape[:-1]
    even = torch.empty((*lead, n // 2), dtype=x.dtype, device=x.device)
    odd = torch.empty_like(even)
    pairs = x.numel() // 2
    if pairs:
        kernels.launch("deinterleave", "deinterleave", x.device, x.data_ptr(),
                       even.data_ptr(), odd.data_ptr(), pairs)
    return even, odd


def _deinterleave(x: torch.Tensor):
    if kernels.on_cuda(x):
        return deinterleave_cuda(x.contiguous())
    return deinterleave_plain(x)


def fold_line(values: torch.Tensor, itwiddles: torch.Tensor,
              alpha: torch.Tensor) -> torch.Tensor:
    """[4, n] -> [4, n/2]: f' = f0 + alpha*f1 with (f0, f1) = ibutterfly pairs."""
    v0, v1 = _deinterleave(values)
    f0 = qm31.add(v0, v1)
    f1 = m31.mul(m31.sub(v0, v1), itwiddles[None, :])
    return qm31.add(f0, qm31.mul(f1, alpha[:, None]))


def fold_circle_into_line(dst: torch.Tensor, src: torch.Tensor,
                          y_itwiddles: torch.Tensor,
                          alpha: torch.Tensor) -> torch.Tensor:
    """dst * alpha^2 + (alpha*f1 + f0) (reference fri.ts:162-192)."""
    v0, v1 = _deinterleave(src)
    f0 = qm31.add(v0, v1)
    f1 = m31.mul(m31.sub(v0, v1), y_itwiddles[None, :])
    f_prime = qm31.add(qm31.mul(f1, alpha[:, None]), f0)
    alpha_sq = qm31.mul(alpha, alpha)
    return qm31.add(qm31.mul(dst, alpha_sq[:, None]), f_prime)


def decompose(values: torch.Tensor):
    """Split a FRI-space secure eval into fft-space part + lambda.

    lambda = (sum(first half) - sum(second half)) / N; g = v -/+ lambda
    (reference backend/cpu/fri.ts:96-163).
    """
    n = values.shape[-1]
    half = n // 2

    def tree_sum(x):
        while x.shape[-1] > 1:
            x0, x1 = _deinterleave(x)
            x = m31.add(x0, x1)
        return x[..., 0]

    a_sum = tree_sum(values[:, :half])
    b_sum = tree_sum(values[:, half:])
    n_inv = pow(n % m31.P, m31.P - 2, m31.P)
    lam = m31.mul(m31.sub(a_sum, b_sum), n_inv)  # [4]
    g_first = qm31.sub(values[:, :half], lam[:, None])
    g_second = qm31.add(values[:, half:], lam[:, None])
    return torch.cat([g_first, g_second], dim=1), lam


def domain_y_itwiddles(domain, device="cpu") -> torch.Tensor:
    """1/y over the half coset in bit-reversed order (for circle->line fold)."""
    from ..utils import to_torch_u32

    return to_torch_u32(_domain_y_itwiddles_np(
        domain.half_coset.initial_index.value, domain.half_coset.log_size),
        device)


@lru_cache(maxsize=None)
def _domain_y_itwiddles_np(initial_index: int, log_size: int) -> np.ndarray:
    from ..circle import CirclePointIndex, Coset
    from ..utils import bit_reverse_permutation

    coset = Coset(CirclePointIndex(initial_index), log_size)
    half = coset.size()
    init = coset.initial
    P = m31.P
    xs = np.array([init.x.value], dtype=np.uint64)
    ys = np.array([init.y.value], dtype=np.uint64)
    j = 0
    while len(xs) < half:
        sp = coset.step_size.scale(1 << j).to_point()
        sx, sy = np.uint64(sp.x.value), np.uint64(sp.y.value)
        nx = (xs * sx + np.uint64(P) * P - ys * sy) % P
        ny = (xs * sy + ys * sx) % P
        xs = np.concatenate([xs, nx])
        ys = np.concatenate([ys, ny])
        j += 1
    perm = bit_reverse_permutation(log_size)
    return m31.np_inv(ys[perm].astype(np.uint32))
