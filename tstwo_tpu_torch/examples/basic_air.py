"""The canonical end-to-end AIR: 3 columns with col1*col2 + col1 - col3 == 0.

Mirrors rust-examples/05_proving_an_air.rs (the reference's definitive
prove+verify spec).
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ..circle import CanonicCoset
from ..constraint_framework import (FrameworkComponent, FrameworkEval,
                                    TraceLocationAllocator)
from ..fields import QM31
from ..pcs import PcsConfig
from ..pcs.prover import CommitmentSchemeProver
from ..pcs.verifier import CommitmentSchemeVerifier
from ..poly.circle_poly import CircleEvaluation
from ..poly.twiddles import twiddles_for
from ..prover import StarkProof, prove, verify
from ..utils import entry_device, mesh_device, to_torch_u32

CONSTRAINT_EVAL_BLOWUP_FACTOR = 1


class TestEval(FrameworkEval):
    """rust-examples/05_proving_an_air.rs:28-48."""

    def __init__(self, log_size: int):
        self._log_size = log_size

    def log_size(self) -> int:
        return self._log_size

    def max_constraint_log_degree_bound(self) -> int:
        return self._log_size + CONSTRAINT_EVAL_BLOWUP_FACTOR

    def kernel_cache_key(self):
        return (self._log_size,)

    def evaluate(self, ev):
        col_1 = ev.next_trace_mask()
        col_2 = ev.next_trace_mask()
        col_3 = ev.next_trace_mask()
        ev.add_constraint(col_1 * col_2 + col_1 - col_3)
        return ev


def generate_trace(log_num_rows: int, col1_vals=(1, 7), col2_vals=(5, 11),
                   device=None) -> List[torch.Tensor]:
    """3 zero-padded columns with col3 = col1*col2 + col1
    (rust-examples/05_proving_an_air.rs:56-68), on `device` (CUDA device 0
    unless given; "cpu" for the CPU)."""
    device = entry_device(device)
    n = 1 << log_num_rows
    P = (1 << 31) - 1
    col1 = np.zeros(n, dtype=np.uint32)
    col2 = np.zeros(n, dtype=np.uint32)
    col1[: len(col1_vals)] = col1_vals
    col2[: len(col2_vals)] = col2_vals
    col3 = ((col1.astype(np.uint64) * col2 + col1) % P).astype(np.uint32)
    return [to_torch_u32(c, device) for c in (col1, col2, col3)]


def prove_basic_air(log_num_rows: int = 4, config: PcsConfig = None,
                    device=None, flavor: str = "blake2s", mesh=None,
                    ) -> Tuple[StarkProof, FrameworkComponent, PcsConfig]:
    """Full prove flow of rust-examples/05_proving_an_air.rs:52-121, on
    `device`: CUDA device 0 unless given (it raises where there is none);
    `device="cpu"` runs the plain PyTorch versions on the CPU.  `flavor`
    selects the MerkleChannel: "blake2s" or "poseidon252" (Hades Merkle
    trees, felt252 roots, the Poseidon252 channel).  With `mesh`
    (parallel/, either flavour), the prove runs point-sharded over its
    ranks on the mesh's device, each rank hashing its Merkle subtrees with
    the flavour's kernels, and every rank returns the same proof as the
    single-device one, field by field."""
    from ..tracing import span
    from ..vcs.ops import MERKLE_OPS

    merkle_ops = MERKLE_OPS[flavor]
    device = mesh_device(mesh, device)
    config = config or PcsConfig()
    with span("trace_gen"):
        columns = generate_trace(log_num_rows, device=device)
        domain = CanonicCoset.new(log_num_rows).circle_domain()
        trace = [CircleEvaluation(domain, col) for col in columns]

    with span("twiddle_precompute"):
        twiddles = twiddles_for([TestEval(log_num_rows)],
                                config.fri_config.log_blowup_factor)

    channel = merkle_ops.default_channel()
    commitment_scheme = CommitmentSchemeProver(
        config, twiddles, device, merkle_ops=merkle_ops, mesh=mesh)

    # preprocessed trace (empty)
    tree_builder = commitment_scheme.tree_builder()
    tree_builder.extend_evals([])
    tree_builder.commit(channel)

    channel.mix_u64(log_num_rows)

    tree_builder = commitment_scheme.tree_builder()
    tree_builder.extend_evals(trace)
    tree_builder.commit(channel)

    with span("component_setup"):
        component = FrameworkComponent(
            TraceLocationAllocator(), TestEval(log_num_rows), QM31.zero())

    proof = prove([component], channel, commitment_scheme)
    return proof, component, config


def verify_basic_air(proof: StarkProof, component: FrameworkComponent,
                     config: PcsConfig, log_num_rows: int = 4,
                     flavor: str = "blake2s") -> None:
    """Verify flow (rust-examples/05_proving_an_air.rs:123-133)."""
    from ..vcs.ops import MERKLE_OPS

    merkle_ops = MERKLE_OPS[flavor]
    channel = merkle_ops.default_channel()
    commitment_scheme = CommitmentSchemeVerifier(
        config, merkle_ops=merkle_ops)
    sizes = component.trace_log_degree_bounds()
    commitment_scheme.commit(proof.commitments[0], sizes[0], channel)
    channel.mix_u64(log_num_rows)
    commitment_scheme.commit(proof.commitments[1], sizes[1], channel)
    verify([component], channel, commitment_scheme, proof)
