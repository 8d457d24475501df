"""The reference against the port on the CPU, at small sizes: every piece,
then whole proofs field for field under both Merkle flavours; and the
control, the reference at one query fewer (95 bits), which the comparison
refuses."""
from __future__ import annotations

import hashlib
import json

import numpy as np
import pytest
import torch

from stark_bench.compare import compare
from stark_bench.recipes import wide_fibonacci as recipe
from stark_bench.reference import algebra, merkle, wide_fibonacci as air
from stark_bench.reference.hashes import blake2s_words, words_to_bytes

P = (1 << 31) - 1


def _config(flavor="blake2s", n_columns=8, pow_bits=5, n_queries=6,
            log_blowup=1, log_last=0):
    return {"air": {"name": "wide_fibonacci", "recipe": "wide_fibonacci",
                    "n_columns": n_columns},
            "merkle_channel": flavor,
            "security": {"pow_bits": pow_bits, "n_queries": n_queries,
                         "log_blowup_factor": log_blowup,
                         "log_last_layer_degree_bound": log_last}}


@pytest.mark.parametrize("n_words", [0, 1, 15, 16, 17, 40, 100])
def test_blake2s_words_matches_hashlib(n_words):
    g = torch.Generator().manual_seed(n_words)
    words = torch.randint(0, 1 << 32, (n_words, 3), generator=g,
                          dtype=torch.int64)
    digests = blake2s_words(list(words), 3, "cpu")
    for j in range(3):
        want = hashlib.blake2s(words_to_bytes(words[:, j].tolist()),
                               digest_size=32).digest()
        assert words_to_bytes(digests[:, j].tolist()) == want


@pytest.mark.parametrize("log_size", [1, 2, 3, 6])
def test_cfft_matches_the_port(log_size):
    from tstwo_tpu_torch.circle import CanonicCoset
    from tstwo_tpu_torch.poly.circle_poly import (evaluate_values,
                                                  interpolate_values)

    g = torch.Generator().manual_seed(log_size)
    values = torch.randint(0, P, (3, 1 << log_size), generator=g,
                           dtype=torch.int64)
    coeffs = algebra.interpolate(values, log_size)
    port = interpolate_values(values.to(torch.int32),
                              CanonicCoset.new(log_size).circle_domain())
    assert torch.equal(coeffs, port.to(torch.int64))
    ext = algebra.evaluate(coeffs, log_size + 1)
    port_ext = evaluate_values(
        port, CanonicCoset.new(log_size + 1).circle_domain())
    assert torch.equal(ext, port_ext.to(torch.int64))


def _both(config, log_n, trace_seed):
    port = recipe.proof_fields(recipe.prove(config, log_n, trace_seed, "cpu"))
    ref = air.prove(air.trace_inputs(trace_seed, log_n), config, log_n, "cpu")
    return port, ref


@pytest.mark.parametrize("log_n,kwargs", [
    (5, {}),
    (6, {"n_columns": 100, "pow_bits": 8, "n_queries": 20}),
    (5, {"log_blowup": 2, "log_last": 1}),
    (7, {"n_columns": 3, "n_queries": 70, "log_last": 2}),
])
@pytest.mark.parametrize("host_layer_nodes", [0, 256])
def test_reference_proof_equals_the_port_blake2s(log_n, kwargs,
                                                 host_layer_nodes,
                                                 monkeypatch):
    """Every Merkle layer vectorised (0), and the small ones on the host."""
    monkeypatch.setattr(merkle, "HOST_LAYER_NODES", host_layer_nodes)
    port, ref = _both(_config(**kwargs), log_n, 2 ** 40 + log_n)
    assert port == ref
    assert all(n == 0 for n in compare(port, ref).values())


def test_reference_proof_equals_the_port_poseidon252():
    port, ref = _both(_config("poseidon252", n_columns=4, pow_bits=3,
                              n_queries=3), 3, 99)
    assert port == ref


def test_recipe_proof_equals_prove_wide_fibonacci():
    from tstwo_tpu_torch.examples.wide_fibonacci import prove_wide_fibonacci
    from tstwo_tpu_torch.serialize import proof_to_dict

    config = _config(n_columns=10, pow_bits=4, n_queries=7)
    mine = recipe.prove(config, 5, 1234, "cpu")
    example, _, _ = prove_wide_fibonacci(
        5, 10, recipe.pcs_config(config["security"]), seed=1234,
        device="cpu")
    assert (json.dumps(proof_to_dict(mine), sort_keys=True)
            == json.dumps(proof_to_dict(example), sort_keys=True))


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_the_control_one_query_fewer_is_refused(seed):
    """The control breaks the configuration's guarantee (96 -> 95 bits):
    the reference with n_queries - 1 in the program's place."""
    config = _config(n_columns=6, pow_bits=4, n_queries=8)
    weaker = _config(n_columns=6, pow_bits=4, n_queries=7)
    inputs = air.trace_inputs(seed, 5)
    sound = air.prove(inputs, config, 5, "cpu")
    control = air.prove(inputs, weaker, 5, "cpu")
    diffs = compare(control, sound)
    assert diffs["decommitment"] > 0 or diffs["fri"] > 0
    assert all(n == 0 for n in compare(sound, sound).values())


def test_trace_inputs_are_the_example_stream():
    a, b = air.trace_inputs(5, 4)
    rng = np.random.default_rng(5)
    assert np.array_equal(a, rng.integers(0, P, size=16))
    assert np.array_equal(b, rng.integers(0, P, size=16))
