"""Whole-proof parity of the PyTorch port on wide Fibonacci (tolerance 0).

Wide Fibonacci at 2^8 rows x 8 columns, seed 0, default PcsConfig: the
port's proof must serialize to the same JSON as the JAX package's, each
package's verifier must accept the other's proof, the port's verifier must
reject mutated proofs, and the committed golden fixture (which the GPU
smoke run compares against) must still be the JAX package's proof.
"""
import copy
import json
import os

import numpy as np
import pytest

from tstwo_tpu.examples import wide_fibonacci as jax_wf
from tstwo_tpu.serialize import proof_from_dict as jax_from_dict
from tstwo_tpu.serialize import proof_to_dict as jax_to_dict
from tstwo_tpu_torch.examples import wide_fibonacci as wf
from tstwo_tpu_torch.fri import FriVerificationError
from tstwo_tpu_torch.pcs.verifier import VerificationError
from tstwo_tpu_torch.serialize import proof_from_dict, proof_to_dict
from tstwo_tpu_torch.utils import to_numpy_u32

LOG_N, SEQ, SEED = 8, 8, 0
FIXTURE = os.path.join(os.path.dirname(__file__), "data",
                       "torch_port_wide_fib_log8x8_seed0.json")


@pytest.fixture(scope="module")
def jax_run():
    proof, component, config = jax_wf.prove_wide_fibonacci(LOG_N, SEQ,
                                                           seed=SEED)
    return proof, component, config, jax_to_dict(proof)


@pytest.fixture(scope="module")
def port_run():
    proof, component, config = wf.prove_wide_fibonacci(LOG_N, SEQ, seed=SEED)
    return proof, component, config, proof_to_dict(proof)


def _json(d):
    return json.dumps(d, sort_keys=True)


def test_trace_matches_jax():
    ours = wf.generate_trace(LOG_N, SEQ, seed=SEED)
    theirs = jax_wf.generate_trace(LOG_N, SEQ, seed=SEED)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(to_numpy_u32(a), np.asarray(b))


def test_golden_fixture_is_the_jax_proof(jax_run):
    with open(FIXTURE) as f:
        assert f.read().strip() == _json(jax_run[3])


def test_port_proof_equals_jax_proof(port_run, jax_run):
    assert _json(port_run[3]) == _json(jax_run[3])


def test_port_verifier_accepts_jax_proof(port_run, jax_run):
    _, component, config, _ = port_run
    wf.verify_wide_fibonacci(proof_from_dict(jax_run[3]), component, config,
                             LOG_N)


def test_jax_verifier_accepts_port_proof(port_run, jax_run):
    _, component, config, _ = jax_run
    jax_wf.verify_wide_fibonacci(jax_from_dict(port_run[3]), component,
                                 config, LOG_N)


def _bump(x):
    """Change a field element (int) or a QM31 (4 ints) by one."""
    if isinstance(x, list):
        return [(x[0] + 1) % ((1 << 31) - 1)] + x[1:]
    return (x + 1) % ((1 << 31) - 1)


def _flip_hex(h):
    return ("0" if h[0] != "0" else "1") + h[1:]


MUTATIONS = {
    "removed_inner_layer": lambda d: d["fri_proof"]["inner_layers"].pop(),
    "added_inner_layer": lambda d: d["fri_proof"]["inner_layers"].append(
        copy.deepcopy(d["fri_proof"]["inner_layers"][-1])),
    "invalid_inner_layer_evaluation": lambda d: d["fri_proof"][
        "inner_layers"][0]["fri_witness"].__setitem__(0, _bump(
            d["fri_proof"]["inner_layers"][0]["fri_witness"][0])),
    "invalid_inner_layer_decommitment": lambda d: d["fri_proof"][
        "inner_layers"][0]["decommitment"]["hash_witness"].__setitem__(
            0, _flip_hex(d["fri_proof"]["inner_layers"][0]["decommitment"][
                "hash_witness"][0])),
    "invalid_first_layer_evaluation": lambda d: d["fri_proof"][
        "first_layer"]["fri_witness"].__setitem__(0, _bump(
            d["fri_proof"]["first_layer"]["fri_witness"][0])),
    "extra_first_layer_evaluation": lambda d: d["fri_proof"]["first_layer"][
        "fri_witness"].append([1, 0, 0, 0]),
    "tampered_first_layer_commitment": lambda d: d["fri_proof"][
        "first_layer"].__setitem__("commitment", _flip_hex(
            d["fri_proof"]["first_layer"]["commitment"])),
    "tampered_inner_layer_commitment": lambda d: d["fri_proof"][
        "inner_layers"][1].__setitem__("commitment", _flip_hex(
            d["fri_proof"]["inner_layers"][1]["commitment"])),
    "invalid_last_layer": lambda d: d["fri_proof"]["last_layer_poly"]
    .__setitem__(0, _bump(d["fri_proof"]["last_layer_poly"][0])),
    "invalid_last_layer_degree": lambda d: d["fri_proof"][
        "last_layer_poly"].append([1, 0, 0, 0]),
    "tampered_queried_value": lambda d: d["queried_values"][1].__setitem__(
        0, _bump(d["queried_values"][1][0])),
    "tampered_sampled_value": lambda d: d["sampled_values"][1][0]
    .__setitem__(0, _bump(d["sampled_values"][1][0][0])),
    "tampered_trace_commitment": lambda d: d["commitments"].__setitem__(
        1, _flip_hex(d["commitments"][1])),
}


@pytest.mark.parametrize("name", sorted(MUTATIONS))
def test_port_verifier_rejects_mutated_proof(port_run, name):
    _, component, config, d = port_run
    bad = copy.deepcopy(d)
    MUTATIONS[name](bad)
    assert bad != d
    with pytest.raises((VerificationError, FriVerificationError)):
        wf.verify_wide_fibonacci(proof_from_dict(bad), component, config,
                                 LOG_N)
