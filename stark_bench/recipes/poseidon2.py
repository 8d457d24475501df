"""The Poseidon2 prove with LogUp, built from the port's public API.

`prove` is the recipe of `tstwo_tpu_torch.examples.poseidon2`'s
`prove_poseidon2` with the Merkle flavour and the security settings of the
configuration: the trace made on the device from its seed, the preprocessed
(empty) and trace commits, the lookup elements drawn, the interaction trace
made and committed, then `prover.prove`.  Each step runs under a profiler
range of the benchmark's own (`bench.*`), which label the device's idle
gaps in a traced run.  `proof_fields` is the wide Fibonacci recipe's: the
port's proof as the plain data the reference makes.
"""
from __future__ import annotations

from torch.profiler import record_function

from stark_bench.recipes.wide_fibonacci import pcs_config, proof_fields
from tstwo_tpu_torch.circle import CanonicCoset
from tstwo_tpu_torch.constraint_framework import (FrameworkComponent,
                                                  TraceLocationAllocator)
from tstwo_tpu_torch.constraint_framework.logup import LookupElements
from tstwo_tpu_torch.examples.poseidon2 import (N_STATE, Poseidon2Eval,
                                                generate_interaction_trace,
                                                generate_trace)
from tstwo_tpu_torch.pcs.prover import CommitmentSchemeProver
from tstwo_tpu_torch.poly.circle_poly import CircleEvaluation
from tstwo_tpu_torch.poly.twiddles import twiddles_for
from tstwo_tpu_torch.prover import prove as stark_prove
from tstwo_tpu_torch.vcs.ops import MERKLE_OPS

__all__ = ["prove", "proof_fields"]


def prove(config: dict, log_n: int, trace_seed: int, device):
    """One proof of 2^log_n rows of 8 permutations, whose input states are
    drawn from `trace_seed`."""
    pcs = pcs_config(config["security"])
    merkle_ops = MERKLE_OPS[config["merkle_channel"]]
    with record_function("bench.trace_gen"):
        columns = generate_trace(log_n, seed=trace_seed, device=device)
        domain = CanonicCoset.new(log_n).circle_domain()
        trace = [CircleEvaluation(domain, col) for col in columns]
        twiddles = twiddles_for(
            [Poseidon2Eval(log_n, LookupElements.dummy(N_STATE))],
            pcs.fri_config.log_blowup_factor)
    with record_function("bench.commit_preprocessed"):
        channel = merkle_ops.default_channel()
        scheme = CommitmentSchemeProver(pcs, twiddles, device,
                                        merkle_ops=merkle_ops)
        tree = scheme.tree_builder()
        tree.extend_evals([])
        tree.commit(channel)
        channel.mix_u64(log_n)
    with record_function("bench.commit_trace"):
        tree = scheme.tree_builder()
        tree.extend_evals(trace)
        tree.commit(channel)
        del trace
    with record_function("bench.interaction"):
        lookup_elements = LookupElements.draw(channel, N_STATE)
        interaction, claimed_sum = generate_interaction_trace(
            log_n, columns, lookup_elements)
        del columns
        tree = scheme.tree_builder()
        tree.extend_evals(interaction)
        tree.commit(channel)
    with record_function("bench.prove"):
        component = FrameworkComponent(
            TraceLocationAllocator(), Poseidon2Eval(log_n, lookup_elements),
            claimed_sum)
        return stark_prove([component], channel, scheme)
