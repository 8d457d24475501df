"""Wide Fibonacci AIR: each row holds a length-N sequence with c = a^2 + b^2.

The framework's throughput workload: N-2 constraints over N columns of
2^log_n_rows rows (reference examples/fibonacci.ts:37-93, porting Rust
stwo's wide_fibonacci example).
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ..channel.blake2s import Blake2sChannel
from ..circle import CanonicCoset
from ..constraint_framework import (FrameworkComponent, FrameworkEval,
                                    TraceLocationAllocator)
from ..fields import QM31
from ..ops import m31
from ..pcs import PcsConfig
from ..pcs.prover import CommitmentSchemeProver
from ..pcs.verifier import CommitmentSchemeVerifier
from ..poly.circle_poly import CircleEvaluation
from ..poly.twiddles import twiddles_for
from ..prover import StarkProof, prove, verify
from ..utils import entry_device, mesh_device, to_torch_u32

FIB_SEQUENCE_LENGTH = 100
P = (1 << 31) - 1


class WideFibonacciEval(FrameworkEval):
    def __init__(self, log_n_rows: int,
                 sequence_length: int = FIB_SEQUENCE_LENGTH):
        if sequence_length < 2:
            raise ValueError("sequence_length must be at least 2")
        self.log_n_rows = log_n_rows
        self.sequence_length = sequence_length

    def log_size(self) -> int:
        return self.log_n_rows

    def max_constraint_log_degree_bound(self) -> int:
        return self.log_n_rows + 1

    def kernel_cache_key(self):
        return (self.log_n_rows, self.sequence_length)

    def evaluate(self, ev):
        a = ev.next_trace_mask()
        b = ev.next_trace_mask()
        for _ in range(2, self.sequence_length):
            c = ev.next_trace_mask()
            ev.add_constraint(c - (a.square() + b.square()))
            a, b = b, c
        return ev


def generate_trace(log_n_rows: int, sequence_length: int = FIB_SEQUENCE_LENGTH,
                   seed: int = 0, device=None) -> List[torch.Tensor]:
    """Row r holds the sequence a, b, a^2+b^2, ... with random (a, b) drawn
    from np.random.default_rng(seed), the JAX package's stream; the
    recurrence runs on `device` (CUDA device 0 unless given; "cpu" for the
    CPU)."""
    device = entry_device(device)
    rng = np.random.default_rng(seed)
    n = 1 << log_n_rows
    a = to_torch_u32(rng.integers(0, P, size=n).astype(np.uint32), device)
    b = to_torch_u32(rng.integers(0, P, size=n).astype(np.uint32), device)
    cols = [a, b]
    for _ in range(2, sequence_length):
        a, b = b, m31.add(m31.square(a), m31.square(b))
        cols.append(b)
    return cols


def prove_wide_fibonacci(log_n_rows: int = 6,
                         sequence_length: int = FIB_SEQUENCE_LENGTH,
                         config: PcsConfig = None, seed: int = 0,
                         device=None, mesh=None,
                         ) -> Tuple[StarkProof, FrameworkComponent, PcsConfig]:
    """Prove 2^log_n_rows rows of `sequence_length` columns on `device`:
    CUDA device 0 unless given (it raises where there is none);
    `device="cpu"` runs the plain PyTorch versions on the CPU.  With
    `mesh` (parallel/), the prove runs point-sharded over its ranks on the
    mesh's device, and every rank returns the same proof, byte-identical
    to the single-device one."""
    from ..tracing import span

    device = mesh_device(mesh, device)
    config = config or PcsConfig()
    with span("trace_gen"):
        columns = generate_trace(log_n_rows, sequence_length, seed=seed,
                                 device=device)
        domain = CanonicCoset.new(log_n_rows).circle_domain()
        trace = [CircleEvaluation(domain, col) for col in columns]
    with span("twiddle_precompute"):
        twiddles = twiddles_for(
            [WideFibonacciEval(log_n_rows, sequence_length)],
            config.fri_config.log_blowup_factor)
    channel = Blake2sChannel()
    scheme = CommitmentSchemeProver(config, twiddles, device, mesh=mesh)
    tb = scheme.tree_builder()
    tb.extend_evals([])
    tb.commit(channel)
    channel.mix_u64(log_n_rows)
    tb = scheme.tree_builder()
    tb.extend_evals(trace)
    tb.commit(channel)
    with span("component_setup"):
        component = FrameworkComponent(
            TraceLocationAllocator(),
            WideFibonacciEval(log_n_rows, sequence_length), QM31.zero())
    proof = prove([component], channel, scheme)
    return proof, component, config


def verify_wide_fibonacci(proof: StarkProof, component: FrameworkComponent,
                          config: PcsConfig, log_n_rows: int) -> None:
    channel = Blake2sChannel()
    scheme = CommitmentSchemeVerifier(config)
    sizes = component.trace_log_degree_bounds()
    scheme.commit(proof.commitments[0], sizes[0], channel)
    channel.mix_u64(log_n_rows)
    scheme.commit(proof.commitments[1], sizes[1], channel)
    verify([component], channel, scheme, proof)
