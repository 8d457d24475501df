"""Preprocessed (phase-0) trace columns (Rust stwo
constraint_framework/preprocessed_columns.rs): columns known to both prover
and verifier, committed in tree PREPROCESSED_TRACE_IDX and referenced by
components through stable string ids.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..circle import CanonicCoset
from ..poly.circle_poly import CircleEvaluation
from ..utils import entry_device


@dataclass(frozen=True)
class PreProcessedColumnId:
    id: str


class IsFirst:
    """1 at the first trace row (coset order), 0 elsewhere.  The first coset
    row lands at committed index 0 (bit_reverse(domain_index(0)) == 0)."""

    def __init__(self, log_size: int):
        self.log_size = log_size

    def id(self) -> PreProcessedColumnId:
        return PreProcessedColumnId(f"preprocessed_is_first_{self.log_size}")

    def gen_column(self, device=None) -> CircleEvaluation:
        """The column on `device`, CUDA device 0 unless named."""
        vals = torch.zeros(1 << self.log_size, dtype=torch.int32,
                           device=entry_device(device))
        vals[0] = 1
        domain = CanonicCoset.new(self.log_size).circle_domain()
        return CircleEvaluation(domain, vals)


class Seq:
    """Committed row r holds the value r (stwo preprocessed_columns.rs Seq:
    Col::from_iter(0..n) over the bit-reversed circle domain)."""

    def __init__(self, log_size: int):
        self.log_size = log_size

    def id(self) -> PreProcessedColumnId:
        return PreProcessedColumnId(f"preprocessed_seq_{self.log_size}")

    def gen_column(self, device=None) -> CircleEvaluation:
        """The column on `device`, CUDA device 0 unless named."""
        domain = CanonicCoset.new(self.log_size).circle_domain()
        return CircleEvaluation(domain, torch.arange(
            1 << self.log_size, dtype=torch.int32,
            device=entry_device(device)))
