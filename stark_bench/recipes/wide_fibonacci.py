"""The wide Fibonacci prove, built from the port's public API.

`prove` is the recipe of `tstwo_tpu_torch.examples.wide_fibonacci`'s
`prove_wide_fibonacci` with the Merkle flavour and the security settings of
the configuration: the trace made on the device from its seed, the
commitment scheme with the flavour's Merkle ops and channel, the
preprocessed (empty) and trace commits, then `prover.prove`.  Each step
runs under a profiler range of the benchmark's own (`bench.*`), which label
the device's idle gaps in a traced run.  `proof_fields` writes the port's
proof as the plain data the reference makes.
"""
from __future__ import annotations

from torch.profiler import record_function

from tstwo_tpu_torch.circle import CanonicCoset
from tstwo_tpu_torch.constraint_framework import (FrameworkComponent,
                                                  TraceLocationAllocator)
from tstwo_tpu_torch.examples.wide_fibonacci import (WideFibonacciEval,
                                                     generate_trace)
from tstwo_tpu_torch.fields import QM31
from tstwo_tpu_torch.fri import FriConfig
from tstwo_tpu_torch.pcs import PcsConfig
from tstwo_tpu_torch.pcs.prover import CommitmentSchemeProver
from tstwo_tpu_torch.poly.circle_poly import CircleEvaluation
from tstwo_tpu_torch.poly.twiddles import precompute_twiddles
from tstwo_tpu_torch.prover import prove as stark_prove
from tstwo_tpu_torch.vcs.ops import MERKLE_OPS


def pcs_config(security: dict) -> PcsConfig:
    return PcsConfig(security["pow_bits"], FriConfig(
        security["log_last_layer_degree_bound"],
        security["log_blowup_factor"], security["n_queries"]))


def prove(config: dict, log_n: int, trace_seed: int, device):
    """One proof of 2^log_n rows of the configuration's columns, whose
    initial values are drawn from `trace_seed`."""
    n_columns = config["air"]["n_columns"]
    pcs = pcs_config(config["security"])
    merkle_ops = MERKLE_OPS[config["merkle_channel"]]
    with record_function("bench.trace_gen"):
        columns = generate_trace(log_n, n_columns, seed=trace_seed,
                                 device=device)
        domain = CanonicCoset.new(log_n).circle_domain()
        trace = [CircleEvaluation(domain, col) for col in columns]
        twiddles = precompute_twiddles(CanonicCoset.new(
            log_n + 1 + pcs.fri_config.log_blowup_factor
        ).circle_domain().half_coset)
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
    with record_function("bench.prove"):
        component = FrameworkComponent(
            TraceLocationAllocator(), WideFibonacciEval(log_n, n_columns),
            QM31.zero())
        return stark_prove([component], channel, scheme)


def _root(root):
    return root.hex() if isinstance(root, bytes) else root.value


def _qm31(v) -> list:
    return list(v.to_ints())


def _decommitment(d) -> dict:
    return {"hash_witness": [_root(h) for h in d.hash_witness],
            "column_witness": [m.value for m in d.column_witness]}


def _fri_layer(layer) -> dict:
    return {"commitment": _root(layer.commitment),
            "fri_witness": [_qm31(v) for v in layer.fri_witness],
            "decommitment": _decommitment(layer.decommitment)}


def proof_fields(proof) -> dict:
    p = proof.commitment_scheme_proof
    return {
        "commitments": [_root(c) for c in p.commitments],
        "sampled_values": [[[_qm31(v) for v in col] for col in tree]
                           for tree in p.sampled_values],
        "decommitments": [_decommitment(d) for d in p.decommitments],
        "queried_values": [[m.value for m in tree]
                           for tree in p.queried_values],
        "proof_of_work": p.proof_of_work,
        "fri": {"first_layer": _fri_layer(p.fri_proof.first_layer),
                "inner_layers": [_fri_layer(x)
                                 for x in p.fri_proof.inner_layers],
                "last_layer_poly": [_qm31(c) for c in
                                    p.fri_proof.last_layer_poly.coeffs]},
    }
