"""Sharded circle FFT over a mesh of ranks.

Factorization (the distributed form of the reference's cached-FFT split,
backend/simd/fft/rfft.ts:47-66 / transposeVecs at simd/fft/index.ts:39-66),
the JAX package's tstwo_tpu/parallel/fft.py written out explicitly:

  natural-order coefficients [N] as [D, M] (D ranks, M = N/D local):
    all_to_all transpose  ->  the high k = log2(D) line layers on the
    shard axis  ->  all_to_all back  ->  the low line layers and the
    circle layer, local.

Rank r holds points [r*M, (r+1)*M) of a column: natural-order
coefficients in, bit-reversed evaluations out (for a bit-reversed
evaluation that slice is one complete Merkle subtree).  The local layers
are one call of the port's CFFT -- `ops.fft.cfft_cuda`, the hand kernel,
on a CUDA rank and `fft_plain` on the CPU -- with a twiddle buffer built
from the rank's slice of each layer: rank r's part of line layer l has
M >> (l + 1) entries and its part of the circle twiddles M/2, exactly the
buffer of a 2^log2(M) transform.  The k high layers (k <= 2 on four ranks)
are PyTorch elementwise code, as the JAX package computes them with jnp
outside any Pallas kernel.  The inverse runs the kernel with scale 1 and
multiplies by 1/N after the high layers.

Columns may carry leading batch axes ([..., M]); the transform runs on
the last axis of every row.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F

from ..ops import fft as fft_ops
from ..ops import m31
from .mesh import Mesh


def sharded_fft_applicable(mesh: Mesh, log_n: int) -> bool:
    """Whether 2^log_n points split over the mesh for the transpose: the
    local size 2^(log_n - k) must be at least max(2, D)."""
    k = mesh.log_size
    return (1 << k) == mesh.size and log_n - k >= max(1, k)


def _axis_butterfly(x: torch.Tensor, layer: int, twiddles: torch.Tensor,
                    inverse: bool) -> torch.Tensor:
    """Butterflies along the second-to-last axis of a [..., D, M/D] block
    (the shard axis the transpose brought local)."""
    *lead, d, m_loc = x.shape
    stride = 1 << layer
    v = x.reshape(*lead, d // (2 * stride), 2, stride, m_loc)
    t = twiddles[:, None, None]
    v0 = v[..., 0, :, :]
    v1 = v[..., 1, :, :]
    if not inverse:
        prod = m31.mul(v1, t)
        out = torch.stack([m31.add(v0, prod), m31.sub(v0, prod)], dim=-3)
    else:
        out = torch.stack([m31.add(v0, v1), m31.mul(m31.sub(v0, v1), t)],
                          dim=-3)
    return out.reshape(*lead, d, m_loc)


def _transpose(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """[..., D, M/D]: block j goes to rank j, and block j of the result
    came from rank j (the tiled all-to-all of the JAX package)."""
    y = mesh.all_to_all(x.movedim(-2, 0))
    return y.movedim(0, -2)


class ShardedFft:
    """A sharded (i)CFFT of 2^log_n points for one rank of `mesh`."""

    def __init__(self, mesh: Mesh, log_n: int,
                 line_twiddles: Sequence[torch.Tensor],
                 circle_twiddles: torch.Tensor, inverse: bool = False):
        d, k = mesh.size, mesh.log_size
        if not sharded_fft_applicable(mesh, log_n):
            raise ValueError(
                f"local size 2^{log_n - k} must be >= mesh size {d} for the "
                f"all-to-all transpose (need log_n >= 2*log2(ranks))")
        self.mesh = mesh
        self.log_n = log_n
        self.inverse = inverse
        n = 1 << log_n
        self.m = n // d
        self.m_log = log_n - k
        dev = mesh.device
        # line layer l has n >> (l + 1) twiddles: the high layers (l >=
        # m_log, at most D/2 each) whole, the low layers as this rank's
        # slice of m >> (l + 1)
        self.high = [line_twiddles[l - 1].to(dev)
                     for l in range(log_n - 1, self.m_log - 1, -1)]
        self.low = [line_twiddles[l - 1][
            mesh.rank * (self.m >> (l + 1)):
            (mesh.rank + 1) * (self.m >> (l + 1))].to(dev)
            for l in range(1, self.m_log)]
        half = self.m // 2
        self.circle = circle_twiddles[mesh.rank * half:
                                      (mesh.rank + 1) * half].to(dev)
        self.buffer = (fft_ops.twiddle_buffer(self.low, self.circle)
                       if dev.type == "cuda" else None)
        self.n_inv = pow(n % m31.P, m31.P - 2, m31.P)

    def _local(self, x: torch.Tensor) -> torch.Tensor:
        if self.buffer is not None:
            return fft_ops.cfft_cuda(x.contiguous(), self.buffer, self.m_log,
                                     self.inverse)
        return fft_ops.fft_plain(x, self.low, self.circle, self.inverse)

    def _high(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[:-1]
        d = self.mesh.size
        x = _transpose(self.mesh, x.reshape(*lead, d, self.m // d))
        k = self.mesh.log_size
        if not self.inverse:
            for i, t in enumerate(self.high):
                x = _axis_butterfly(x, k - 1 - i, t, False)
        else:
            for i, t in enumerate(reversed(self.high)):
                x = _axis_butterfly(x, i, t, True)
        return _transpose(self.mesh, x).reshape(*lead, self.m)

    def __call__(self, values: torch.Tensor) -> torch.Tensor:
        """This rank's [..., M] slice in, its [..., M] slice out."""
        if values.shape[-1] != self.m:
            raise ValueError(f"a rank's slice has {self.m} points, got "
                             f"{values.shape[-1]}")
        if not self.inverse:
            return self._local(self._high(values))
        return m31.mul(self._high(self._local(values)), self.n_inv)


def make_sharded_fft(mesh: Mesh, log_n: int,
                     line_twiddles: Sequence[torch.Tensor],
                     circle_twiddles: torch.Tensor,
                     inverse: bool = False) -> ShardedFft:
    """The sharded (i)CFFT of 2^log_n points on `mesh`: fn(slice) ->
    slice.  Forward maps natural coefficients to bit-reversed evaluations;
    inverse maps back, the 1/N scale included."""
    return ShardedFft(mesh, log_n, line_twiddles, circle_twiddles, inverse)


def shard_column(values: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's slice of the last (point) axis of a whole column, on
    the mesh's device."""
    start, stop = mesh.local_range(values.shape[-1])
    return values[..., start:stop].to(mesh.device)


# ---------------------------------------------------------------------------
# The sharded poly ops of CommitmentSchemeProver(mesh=...)
# ---------------------------------------------------------------------------

_SHARDED_FFT_CACHE: Dict[tuple, ShardedFft] = {}


def _get_sharded_fft(mesh: Mesh, log_n: int, tree, inverse: bool
                     ) -> ShardedFft:
    from ..poly.twiddles import circle_layer_twiddles, domain_line_twiddles

    key = (mesh.rank, mesh.size, str(mesh.device), log_n, inverse,
           tree.root_coset.initial_index.value, tree.root_coset.log_size)
    fn = _SHARDED_FFT_CACHE.get(key)
    if fn is None or fn.mesh is not mesh:
        line = domain_line_twiddles(log_n, tree, inverse, mesh.device)
        circle = circle_layer_twiddles(line[0])
        fn = _SHARDED_FFT_CACHE[key] = ShardedFft(mesh, log_n, line, circle,
                                                  inverse)
    return fn


def evaluate_values_sharded(coeffs: torch.Tensor, domain, tree,
                            mesh: Mesh) -> torch.Tensor:
    """CFFT-evaluate whole (replicated) coefficient tensor(s) [..., m] on
    `domain`, m <= domain.size(): this rank's slice of the bit-reversed
    evaluations where `mesh.shards(domain.log_size())`, else the whole
    evaluations from the single-device transform.  Bit-identical to
    poly.circle_poly.evaluate_values."""
    from ..poly.circle_poly import evaluate_values

    log = domain.log_size()
    if not mesh.shards(log):
        return evaluate_values(coeffs.to(mesh.device), domain, tree)
    fn = _get_sharded_fft(mesh, log, tree, False)
    start, _ = mesh.local_range(domain.size())
    part = coeffs[..., start:start + fn.m].to(mesh.device)
    if part.shape[-1] < fn.m:
        part = F.pad(part, (0, fn.m - part.shape[-1]))
    return fn(part)


def interpolate_values_sharded(values: torch.Tensor, domain, tree,
                               mesh: Mesh) -> torch.Tensor:
    """Inverse CFFT (1/N included) of bit-reversed evaluations on
    `domain`, given whole or as this rank's slice: this rank's slice of
    the natural-order coefficients where `mesh.shards(domain.log_size())`,
    else the whole coefficients from the single-device transform."""
    from ..poly.circle_poly import interpolate_values

    log, n = domain.log_size(), domain.size()
    if not mesh.shards(log):
        return interpolate_values(values.to(mesh.device), domain, tree)
    if values.shape[-1] == n:
        values = shard_column(values, mesh)
    return _get_sharded_fft(mesh, log, tree, True)(values)
