"""The wide Fibonacci prove under the Poseidon252 flavour, built from the
port's public API: `prove` and `proof_fields` of `wide_fibonacci.py` beside
this file, which take the configuration's `merkle_channel` through
`MERKLE_OPS` and write a felt252 root as its int.

Before a proof, `prove` asks the port whether it grinds this channel's
proof of work on the device at the configuration's pow_bits
(`proof_of_work.grinds_on_device`), and raises at once if it does not: a
port that would grind a Poseidon252 channel on the host, one nonce at a
time, would take hours a proof at pow_bits 26.
"""
from __future__ import annotations

import importlib.util
from pathlib import Path

from tstwo_tpu_torch import proof_of_work
from tstwo_tpu_torch.vcs.ops import MERKLE_OPS


def _load_wide_fibonacci():
    path = Path(__file__).resolve().with_name("wide_fibonacci.py")
    spec = importlib.util.spec_from_file_location(
        "stark_bench_recipe_wide_fibonacci_of_p252", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


_wide_fibonacci = _load_wide_fibonacci()
proof_fields = _wide_fibonacci.proof_fields


def require_device_grind(config: dict) -> None:
    """Raise unless the port grinds the configuration's channel on the
    device at its pow_bits."""
    ask = getattr(proof_of_work, "grinds_on_device", None)
    channel = MERKLE_OPS[config["merkle_channel"]].default_channel()
    pow_bits = config["security"]["pow_bits"]
    if ask is None or not ask(channel, pow_bits):
        raise RuntimeError(
            f"the port grinds a {type(channel).__name__} on the host at "
            f"pow_bits {pow_bits}: a proof would take hours")


def prove(config: dict, log_n: int, trace_seed: int, device):
    """One proof of 2^log_n rows of the configuration's columns, whose
    initial values are drawn from `trace_seed`."""
    require_device_grind(config)
    return _wide_fibonacci.prove(config, log_n, trace_seed, device)
