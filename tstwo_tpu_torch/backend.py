"""Backend trait surface (parity with reference backend/index.ts:12-108).

The reference splits compute into CpuBackend / SimdBackend objects.  Here
one implementation on torch tensors serves both devices: the plain PyTorch
versions on the CPU, the hand-written CUDA kernels on a GPU, chosen by
where the tensors lie.  The Backend protocol is a thin dispatch façade over
the port's modules, with the JAX package's table (tstwo_tpu/backend.py):

  ColumnOps.bit_reverse_column  -> ops.fft.bit_reverse
  PolyOps (interpolate/evaluate/precompute_twiddles)
                                -> poly.circle_poly / poly.twiddles
  FriOps (fold_line/fold_circle_into_line/decompose)
                                -> ops.fri_ops
  QuotientOps.accumulate_quotients -> pcs.quotients.accumulate_quotients
  AccumulationOps.accumulate    -> ops.qm31.add
  GrindOps.grind                -> proof_of_work.grind
  MerkleOps.commit_on_layer     -> vcs.blake2s_merkle.commit_on_layer
  GkrOps / MleOps               -> lookups.gkr / lookups.mle
"""
from __future__ import annotations

from typing import Protocol

from .ops import fft as _fft
from .ops import fri_ops as _fri_ops
from .ops import qm31 as _qm31
from .ops.prefix_sum import exclusive_prefix_sum, inclusive_prefix_sum
from .pcs.quotients import accumulate_quotients
from .poly.circle_poly import evaluate_values, interpolate_values
from .poly.twiddles import precompute_twiddles
from .proof_of_work import grind
from .vcs.blake2s_merkle import commit_on_layer


class Backend(Protocol):
    """Marker protocol mirroring the reference Backend trait."""


class TorchBackend:
    """The PyTorch implementation (CPU plain versions, CUDA kernels)."""

    bit_reverse_column = staticmethod(_fft.bit_reverse)
    evaluate = staticmethod(evaluate_values)
    interpolate = staticmethod(interpolate_values)
    precompute_twiddles = staticmethod(precompute_twiddles)
    fold_line = staticmethod(_fri_ops.fold_line)
    fold_circle_into_line = staticmethod(_fri_ops.fold_circle_into_line)
    decompose = staticmethod(_fri_ops.decompose)
    accumulate_quotients = staticmethod(accumulate_quotients)
    accumulate = staticmethod(_qm31.add)
    grind = staticmethod(grind)
    commit_on_layer = staticmethod(commit_on_layer)
    inclusive_prefix_sum = staticmethod(inclusive_prefix_sum)
    exclusive_prefix_sum = staticmethod(exclusive_prefix_sum)
