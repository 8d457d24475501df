"""Preprocessed (phase-0) trace column ids (Rust stwo
constraint_framework/preprocessed_columns.rs): columns known to both prover
and verifier, committed in tree PREPROCESSED_TRACE_IDX and referenced by
components through stable string ids.  The column generators are not
ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class PreProcessedColumnId:
    id: str
