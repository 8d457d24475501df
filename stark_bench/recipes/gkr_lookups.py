"""The GKR batch prove of a GrandProduct and a LogUpGeneric instance, built
from the port's public API.

`prove` makes the two input layers on the device from the seed (`inputs`),
then proves them in one batch with `tstwo_tpu_torch.lookups.gkr.
prove_batch` over the configuration's channel.  The input generation runs
under the benchmark's profiler range `bench.trace_gen`, the batch under
`bench.prove`, which label the device's idle gaps in a traced run.
`proof_fields` writes the port's `GkrBatchProof` as the plain data the
reference makes: each round polynomial's coefficients, each mask's column
pairs and each output claim, a QM31 as its 4 ints.
"""
from __future__ import annotations

import torch
from torch.profiler import record_function

from tstwo_tpu_torch.channel.blake2s import Blake2sChannel
from tstwo_tpu_torch.lookups.gkr import (GRAND_PRODUCT, LOGUP_GENERIC, Layer,
                                         prove_batch)
from tstwo_tpu_torch.lookups.mle import Mle

__all__ = ["inputs", "prove", "proof_fields"]

P = (1 << 31) - 1
CHANNELS = {"blake2s": Blake2sChannel}


def inputs(log_n: int, trace_seed: int, device) -> torch.Tensor:
    """int32 [3, 4, 2^log_n] on `device`: the QM31 coordinates of the
    GrandProduct values, the LogUp numerators and the LogUp denominators.
    With a = seed mod P, b = 1 + (seed div P) mod (P - 1) and
    c = (seed div (P (P - 1))) mod P, element i of the row-major order is
    1 + (y_3 mod (P - 1)), where y_0 = i b + a and y_(k+1) = (y_k + c + k)^5,
    all mod P: every coordinate is nonzero."""
    a, rest = trace_seed % P, trace_seed // P
    b, c = 1 + rest % (P - 1), rest // (P - 1) % P
    y = (torch.arange(12 << log_n, dtype=torch.int64, device=device) * b
         + a) % P
    for k in range(3):
        t = (y + (c + k) % P) % P
        t2 = t * t % P
        y = t2 * t2 % P * t % P
    return (1 + y % (P - 1)).to(torch.int32).reshape(3, 4, 1 << log_n)


def prove(config: dict, log_n: int, trace_seed: int, device):
    """One batch proof of the configuration's two instances over 2^log_n
    points each, whose inputs are drawn from `trace_seed`."""
    channel = CHANNELS[config["channel"]]()
    with record_function("bench.trace_gen"):
        values, numerators, denominators = inputs(log_n, trace_seed, device)
        layers = [Layer(GRAND_PRODUCT, data=Mle(values)),
                  Layer(LOGUP_GENERIC, numerators=Mle(numerators),
                        denominators=Mle(denominators))]
    with record_function("bench.prove"):
        proof, _ = prove_batch(channel, layers)
    return proof


def _ints(v) -> list:
    return [int(x) for x in v.to_ints()]


def proof_fields(proof) -> dict:
    """The port's GkrBatchProof as plain data, keyed by its three fields."""
    return {
        "sumcheck_proofs": [[[_ints(c) for c in rp.coeffs]
                             for rp in sc.round_polys]
                            for sc in proof.sumcheck_proofs],
        "layer_masks_by_instance": [[[[_ints(a), _ints(b)]
                                      for a, b in mask.columns()]
                                     for mask in masks]
                                    for masks in
                                    proof.layer_masks_by_instance],
        "output_claims_by_instance": [[_ints(c) for c in claims]
                                      for claims in
                                      proof.output_claims_by_instance],
    }
