"""LogUp lookup AIR: a value column looked up against a preprocessed Seq
table with a multiplicity column.

The canonical LogUp shape (stwo-book lookups example; Rust stwo
constraint_framework/logup.rs): every trace row contributes +1/(val - z)
for its looked-up value, and the table side contributes -mult_r/(r - z)
per table row.  When the multiset matches, the grand total is zero; the
interaction trace carries the cumulative sum and the framework's
finalize constraints tie it together.

Exercises the full three-tree flow: preprocessed (Seq), original trace
(val, mult), interaction (one secure cumulative column per batch), with
channel-drawn LookupElements between the trace and interaction commits.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..channel.blake2s import Blake2sChannel
from ..circle import CanonicCoset
from ..constraint_framework import (FrameworkComponent, FrameworkEval,
                                    TraceLocationAllocator)
from ..constraint_framework.logup import (LogupTraceGenerator, LookupElements,
                                          RelationEntry)
from ..constraint_framework.preprocessed import Seq
from ..fields import QM31
from ..ops import m31 as m31_ops
from ..pcs import PcsConfig
from ..pcs.prover import CommitmentSchemeProver
from ..pcs.utils import TreeVec
from ..pcs.verifier import CommitmentSchemeVerifier
from ..poly.circle_poly import CircleEvaluation
from ..poly.twiddles import twiddles_for
from ..prover import StarkProof, prove, verify
from ..utils import entry_device, to_torch_u32

RELATION_SIZE = 1


class LookupEval(FrameworkEval):
    """val is in the Seq table; mult counts how often each table row is
    used.  The drawn (z, alpha) randomness flows through the evaluators'
    `secure_param` hook."""

    def __init__(self, log_n_rows: int, lookup_elements: LookupElements,
                 pairs: bool = True):
        self.log_n_rows = log_n_rows
        self.lookup_elements = lookup_elements
        self.pairs = pairs  # one batched column vs one column per entry

    def log_size(self) -> int:
        return self.log_n_rows

    def max_constraint_log_degree_bound(self) -> int:
        return self.log_n_rows + 1

    def kernel_cache_key(self):
        return (self.log_n_rows, self.pairs,
                len(self.lookup_elements.alpha_powers))

    def evaluate(self, ev):
        seq = ev.get_preprocessed_column(Seq(self.log_n_rows).id())
        val = ev.next_trace_mask()
        mult = ev.next_trace_mask()
        ev.add_to_relation(
            RelationEntry(self.lookup_elements, QM31.one(), [val]))
        ev.add_to_relation(
            RelationEntry(self.lookup_elements, -mult, [seq]))
        if self.pairs:
            ev.finalize_logup_in_pairs()
        else:
            ev.finalize_logup()
        return ev


def generate_trace(log_size: int, seed: int = 0, device=None):
    """val: random table indices; mult[r]: multiplicity of table row r
    (np.random.default_rng(seed), the JAX package's stream), on `device`
    (CUDA device 0 unless given; "cpu" for the CPU)."""
    device = entry_device(device)
    n = 1 << log_size
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, n, size=n).astype(np.uint32)
    mult = np.bincount(vals, minlength=n).astype(np.uint32)
    return to_torch_u32(vals, device), to_torch_u32(mult, device)


def generate_interaction_trace(log_size: int, val_col: torch.Tensor,
                               mult_col: torch.Tensor,
                               lookup_elements: LookupElements,
                               pairs: bool = True):
    """The interaction columns (4 base coordinates per batch) and the
    claimed sum, on the device of `val_col`."""
    device = val_col.device
    seq_vals = Seq(log_size).gen_column(device).values
    gen = LogupTraceGenerator(log_size, device)
    if pairs:
        col = gen.new_col()
        col.write_frac(QM31.one(), lookup_elements.combine_cols([val_col]))
        col.write_frac(m31_ops.neg(mult_col),
                       lookup_elements.combine_cols([seq_vals]))
        col.finalize_col()
    else:
        col = gen.new_col()
        col.write_frac(QM31.one(), lookup_elements.combine_cols([val_col]))
        col.finalize_col()
        col = gen.new_col()
        col.write_frac(m31_ops.neg(mult_col),
                       lookup_elements.combine_cols([seq_vals]))
        col.finalize_col()
    return gen.finalize_last()


def prove_logup_lookup(log_size: int = 8, config: PcsConfig = None,
                       seed: int = 0, pairs: bool = True, trace=None,
                       device=None) -> Tuple[StarkProof, PcsConfig, QM31]:
    """Prove the lookup AIR at 2^log_size rows on `device`: CUDA device 0
    unless given (it raises where there is none); `device="cpu"` runs the
    plain PyTorch versions on the CPU.  `trace` is an optional (val, mult)
    pair of int32 columns to prove instead of generate_trace's."""
    from ..tracing import span

    device = entry_device(device)
    config = config or PcsConfig()
    with span("trace_gen"):
        val_col, mult_col = ((t.to(device) for t in trace) if trace is not None
                             else generate_trace(log_size, seed, device))
        domain = CanonicCoset.new(log_size).circle_domain()
    with span("twiddle_precompute"):
        twiddles = twiddles_for(
            [LookupEval(log_size, LookupElements.dummy(RELATION_SIZE),
                        pairs)], config.fri_config.log_blowup_factor)
    channel = Blake2sChannel()
    scheme = CommitmentSchemeProver(config, twiddles, device)

    tb = scheme.tree_builder()
    tb.extend_evals([Seq(log_size).gen_column(device)])
    tb.commit(channel)
    channel.mix_u64(log_size)

    tb = scheme.tree_builder()
    tb.extend_evals([CircleEvaluation(domain, val_col),
                     CircleEvaluation(domain, mult_col)])
    tb.commit(channel)

    lookup_elements = LookupElements.draw(channel, RELATION_SIZE)
    # LogupTraceGenerator opens the `interaction_trace` span
    interaction_cols, claimed_sum = generate_interaction_trace(
        log_size, val_col, mult_col, lookup_elements, pairs)
    tb = scheme.tree_builder()
    tb.extend_evals(interaction_cols)
    tb.commit(channel)

    with span("component_setup"):
        allocator = TraceLocationAllocator.new_with_preprocessed_columns(
            [Seq(log_size).id()])
        component = FrameworkComponent(
            allocator, LookupEval(log_size, lookup_elements, pairs),
            claimed_sum)
    proof = prove([component], channel, scheme)
    return proof, config, claimed_sum


def verify_logup_lookup(proof: StarkProof, config: PcsConfig, log_size: int,
                        claimed_sum: QM31, pairs: bool = True) -> None:
    """Rebuilds the component from the proof transcript (the verifier draws
    its own lookup elements at the same transcript position)."""
    if not claimed_sum.is_zero():
        raise ValueError("lookup claimed_sum must be zero")
    sizes = TreeVec([[log_size],
                     [log_size, log_size],
                     [log_size] * (4 if pairs else 8)])
    channel = Blake2sChannel()
    scheme = CommitmentSchemeVerifier(config)
    scheme.commit(proof.commitments[0], sizes[0], channel)
    channel.mix_u64(log_size)
    scheme.commit(proof.commitments[1], sizes[1], channel)
    lookup_elements = LookupElements.draw(channel, RELATION_SIZE)
    scheme.commit(proof.commitments[2], sizes[2], channel)
    allocator = TraceLocationAllocator.new_with_preprocessed_columns(
        [Seq(log_size).id()])
    component = FrameworkComponent(
        allocator, LookupEval(log_size, lookup_elements, pairs), claimed_sum)
    verify([component], channel, scheme, proof)
