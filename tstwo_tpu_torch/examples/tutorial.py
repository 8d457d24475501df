"""Tutorial walkthrough mirroring the reference's stwo-book examples 01-05
(test-equivalence/stwo-examples-equivalence/rust-examples/).

Each step returns the intermediate objects so tests can check them (trace
contents, domain sizes, configs, the proof) against the JAX package's
tutorial (tstwo_tpu/examples/tutorial.py).  Every step runs on `device`:
CUDA device 0 unless given (it raises where there is none); `device="cpu"`
runs the plain PyTorch versions on the CPU.
"""
from __future__ import annotations

import numpy as np

from ..channel.blake2s import Blake2sChannel
from ..circle import CanonicCoset
from ..pcs import PcsConfig
from ..pcs.prover import CommitmentSchemeProver
from ..poly.circle_poly import CircleEvaluation
from ..poly.twiddles import twiddles_for
from ..utils import entry_device, to_torch_u32


def example_01_writing_a_spreadsheet(log_num_rows: int = 4,
                                     col1_vals=(3, 9), col2_vals=(7, 13),
                                     device=None):
    """Two zero-padded columns of 2^log rows."""
    device = entry_device(device)
    n = 1 << log_num_rows
    col1 = np.zeros(n, dtype=np.uint32)
    col2 = np.zeros(n, dtype=np.uint32)
    col1[: len(col1_vals)] = col1_vals
    col2[: len(col2_vals)] = col2_vals
    return to_torch_u32(col1, device), to_torch_u32(col2, device)


def example_02_from_spreadsheet_to_trace_polynomials(log_num_rows: int = 4,
                                                     device=None):
    """Columns -> CircleEvaluations on the canonic domain -> polynomials."""
    col1, col2 = example_01_writing_a_spreadsheet(log_num_rows,
                                                  device=device)
    domain = CanonicCoset.new(log_num_rows).circle_domain()
    trace = [CircleEvaluation(domain, col1), CircleEvaluation(domain, col2)]
    polys = [ev.interpolate() for ev in trace]
    return domain, trace, polys


def example_03_committing_to_the_trace_polynomials(log_num_rows: int = 4,
                                                   device=None):
    """Channel + commitment scheme: commit preprocessed (empty), mix size,
    commit trace."""
    device = entry_device(device)
    domain, trace, _ = example_02_from_spreadsheet_to_trace_polynomials(
        log_num_rows, device)
    config = PcsConfig()
    from .basic_air import TestEval

    twiddles = twiddles_for([TestEval(log_num_rows)],
                            config.fri_config.log_blowup_factor)
    channel = Blake2sChannel()
    scheme = CommitmentSchemeProver(config, twiddles, device)
    tb = scheme.tree_builder()
    tb.extend_evals([])
    tb.commit(channel)
    channel.mix_u64(log_num_rows)
    tb = scheme.tree_builder()
    tb.extend_evals(trace)
    tb.commit(channel)
    return channel, scheme


def example_04_constraints_over_trace_polynomial(log_num_rows: int = 4,
                                                 device=None):
    """Add col3 = col1*col2 + col1 and assert the constraint vanishes."""
    from ..constraint_framework import assert_constraints
    from ..pcs.utils import TreeVec
    from .basic_air import TestEval, generate_trace

    cols = generate_trace(log_num_rows, col1_vals=(3, 9), col2_vals=(7, 13),
                          device=device)
    assert_constraints(TreeVec([[], cols]), log_num_rows,
                       TestEval(log_num_rows))
    return cols


def example_05_proving_an_air(log_num_rows: int = 4, device=None):
    """Full prove + verify (see examples/basic_air.py)."""
    from .basic_air import prove_basic_air, verify_basic_air

    proof, component, config = prove_basic_air(log_num_rows, device=device)
    verify_basic_air(proof, component, config, log_num_rows)
    return proof
