"""Whole-proof parity of the PyTorch port on the basic AIR (tolerance 0).

rust-example-05's three-column AIR at log 4, default PcsConfig: the
port's proof must serialize to the same JSON as the JAX package's, and
each package's verifier must accept the other's proof.
"""
import json

import pytest

from tstwo_tpu.examples import basic_air as jax_basic_air
from tstwo_tpu.serialize import proof_from_dict as jax_from_dict
from tstwo_tpu.serialize import proof_to_dict as jax_to_dict
from tstwo_tpu_torch.examples import basic_air
from tstwo_tpu_torch.serialize import proof_from_dict, proof_to_dict

LOG_N = 4


@pytest.fixture(scope="module")
def proofs():
    ours = basic_air.prove_basic_air(LOG_N)
    theirs = jax_basic_air.prove_basic_air(LOG_N)
    return ours, theirs


def test_port_proof_equals_jax_proof(proofs):
    ours, theirs = proofs
    assert json.dumps(proof_to_dict(ours[0]), sort_keys=True) == \
        json.dumps(jax_to_dict(theirs[0]), sort_keys=True)


def test_port_verifier_accepts_jax_proof(proofs):
    (_, component, config), theirs = proofs
    basic_air.verify_basic_air(proof_from_dict(jax_to_dict(theirs[0])),
                               component, config, LOG_N)


def test_jax_verifier_accepts_port_proof(proofs):
    ours, (_, component, config) = proofs
    jax_basic_air.verify_basic_air(jax_from_dict(proof_to_dict(ours[0])),
                                   component, config, LOG_N)


def test_proof_dict_roundtrip(proofs):
    d = proof_to_dict(proofs[0][0])
    assert proof_to_dict(proof_from_dict(d)) == d
