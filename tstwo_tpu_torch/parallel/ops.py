"""Sharded column operations: the port's single-device functions on the
rank's slice of the point axis.

The quotient accumulation, the FRI folds and the Merkle leaf hashing are
row-elementwise over the point axis (a fold pairs adjacent bit-reversed
entries, which lie in one slice), so each rank runs them on its own
slice with no traffic: the quotients through csrc/quotients.cu on a CUDA
slice, the folds through `ops.fri_ops`, whose deinterleave is
csrc/deinterleave.cu on a CUDA slice, and the leaf hashing through the
Blake2s layer kernel.  Only the FFT (parallel/fft.py) and the
top of a Merkle tree (parallel/merkle.py) talk across ranks.

A column argument here is either whole (it is sliced) or already the
rank's slice; `gather_points` puts a sharded column back together.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from .fft import shard_column
from .mesh import Mesh


def shard_points(mesh: Mesh, arr: torch.Tensor) -> torch.Tensor:
    """This rank's slice of the last (point) axis of a whole array."""
    return shard_column(arr, mesh)


def gather_points(mesh: Mesh, local: torch.Tensor) -> torch.Tensor:
    """The whole column from every rank's slice of its last axis, on every
    rank (one all_gather)."""
    parts = mesh.all_gather(local)  # [D, ..., m]
    return torch.cat(list(parts.unbind(0)), dim=-1)


def _local(mesh: Mesh, arr: torch.Tensor, n: int) -> torch.Tensor:
    """`arr` as this rank's slice of an axis of n points."""
    if arr.shape[-1] == n:
        return shard_points(mesh, arr)
    if arr.shape[-1] * mesh.size != n:
        raise ValueError(f"{arr.shape[-1]} points are neither the whole "
                         f"{n} nor a rank's slice of them")
    return arr.to(mesh.device)


def sharded_accumulate_quotients(mesh: Mesh, domain,
                                 columns: Sequence[torch.Tensor],
                                 random_coeff, sample_batches,
                                 log_blowup_factor: int):
    """Quotient accumulation on this rank's slice of `domain`: a
    SecureEvaluation of the rank's [4, n/D] values (its `mesh` set).  The
    single-device function on the slice, told its first row, from which
    the kernel makes the slice's points."""
    from ..pcs.quotients import quotient_rows
    from ..poly.circle_poly import SecureEvaluation

    n = domain.size()
    values = quotient_rows(domain, [_local(mesh, c, n) for c in columns],
                           random_coeff, sample_batches,
                           row0=mesh.local_range(n)[0])
    return SecureEvaluation(domain, values, mesh=mesh)


def sharded_fold_line(mesh: Mesh, values: torch.Tensor,
                      itwiddles: torch.Tensor,
                      alpha: torch.Tensor) -> torch.Tensor:
    """FRI line fold of a [4, n] evaluation (whole or this rank's slice)
    with the layer's n/2 inverse twiddles: the rank's [4, n/(2D)] slice of
    the folded evaluation."""
    from ..ops import fri_ops

    n = 2 * itwiddles.shape[-1]
    return fri_ops.fold_line(_local(mesh, values, n),
                             _local(mesh, itwiddles, n // 2), alpha)


def sharded_fold_circle_into_line(mesh: Mesh, dst: torch.Tensor,
                                  src: torch.Tensor,
                                  y_itwiddles: torch.Tensor,
                                  alpha: torch.Tensor) -> torch.Tensor:
    """fold_circle_into_line on this rank's slices: `dst` [4, n/(2D)],
    `src` [4, n/D]; `y_itwiddles` whole (n/2) or the rank's slice."""
    from ..ops import fri_ops

    n = src.shape[-1] * mesh.size
    return fri_ops.fold_circle_into_line(
        dst, src, _local(mesh, y_itwiddles, n // 2), alpha)


def sharded_merkle_leaf_layer(mesh: Mesh, columns: Sequence[torch.Tensor],
                              log_size: int) -> torch.Tensor:
    """Blake2s leaf hashes of this rank's rows of 2^log_size-point
    columns (whole or sliced): int32 [8, 2^log_size / D]."""
    from ..vcs.blake2s_merkle import commit_on_layer

    n = 1 << log_size
    cols: List[torch.Tensor] = [_local(mesh, c, n) for c in columns]
    return commit_on_layer(log_size - mesh.log_size, None, cols, mesh.device)


def gather_at(mesh: Mesh, requests) -> List[torch.Tensor]:
    """Rows of columns at given points, the same on every rank.

    Each request is (entries, idxs, log_n, sharded): entries are [n] or
    [C, n] tensors of 2^log_n-point columns, whole on every rank or, where
    `sharded`, this rank's slices.  The result for a request is the device
    tensor [total C, len(idxs)] of their values at the points `idxs`.  A
    sharded point is answered by the rank that holds it; one all_gather
    carries the answers of every sharded request, and a replicated one is
    read where it is."""
    k = mesh.log_size
    out: List[torch.Tensor] = [None] * len(requests)
    answers, owners, spots = [], [], []
    for i, (entries, idxs, log_n, sharded) in enumerate(requests):
        cols = [e if e.ndim == 2 else e[None, :] for e in entries]
        idx = torch.from_numpy(np.asarray(idxs, dtype=np.int64))
        if not sharded:
            idx = idx.to(cols[0].device)
            out[i] = torch.cat([c.index_select(-1, idx) for c in cols])
            continue
        span = log_n - k
        owner, local = idx >> span, idx & ((1 << span) - 1)
        mine = owner == mesh.rank
        rows = sum(c.shape[0] for c in cols)
        vals = torch.zeros((rows, len(idxs)), dtype=torch.int32,
                           device=mesh.device)
        if bool(mine.any()):
            sel = local[mine].to(mesh.device)
            vals[:, mine.to(mesh.device)] = torch.cat(
                [c.index_select(-1, sel) for c in cols])
        answers.append(vals.reshape(-1))
        owners.append(owner.expand(rows, len(idxs)).reshape(-1))
        spots.append((i, vals.shape))
    if answers:
        every = mesh.all_gather(torch.cat(answers))  # [D, total]
        own = torch.cat(owners).to(mesh.device)
        picked = every.gather(0, own[None, :])[0]
        at = 0
        for i, shape in spots:
            size = shape[0] * shape[1]
            out[i] = picked[at:at + size].reshape(shape)
            at += size
    return out
