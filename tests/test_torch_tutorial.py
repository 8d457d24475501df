"""The tutorial of the PyTorch port against the JAX package's (tolerance
0): steps 01-05 of the stwo-book walkthrough on the same inputs give the
same columns, domains, polynomial coefficients, channel states, Merkle
roots and proof bytes.  Mirrors tests/test_tutorial.py, whose reference
vectors are replaced by the JAX package's results.
"""
import json

import numpy as np
import pytest

from tstwo_tpu.examples import tutorial as jax_tutorial
from tstwo_tpu.serialize import proof_to_dict as jax_to_dict
from tstwo_tpu_torch.examples import tutorial
from tstwo_tpu_torch.serialize import proof_to_dict
from tstwo_tpu_torch.utils import to_numpy_u32


def _equal(ours, theirs):
    np.testing.assert_array_equal(to_numpy_u32(ours), np.asarray(theirs))


@pytest.mark.parametrize("log_n", [3, 5])
def test_01_spreadsheet(log_n):
    for a, b in zip(tutorial.example_01_writing_a_spreadsheet(
                        log_n, device="cpu"),
                    jax_tutorial.example_01_writing_a_spreadsheet(log_n)):
        _equal(a, b)


@pytest.mark.parametrize("log_n", [3, 5])
def test_02_trace_and_polynomials(log_n):
    domain, trace, polys = \
        tutorial.example_02_from_spreadsheet_to_trace_polynomials(
            log_n, device="cpu")
    j_domain, j_trace, j_polys = \
        jax_tutorial.example_02_from_spreadsheet_to_trace_polynomials(log_n)
    assert (domain.log_size(), domain.size()) == (j_domain.log_size(),
                                                   j_domain.size())
    for a, b in zip(trace, j_trace):
        _equal(a.values, b.values)
    assert len(polys) == len(j_polys) == 2
    for a, b in zip(polys, j_polys):
        _equal(a.coeffs, b.coeffs)


def test_03_commitment():
    channel, scheme = tutorial.example_03_committing_to_the_trace_polynomials(
        4, device="cpu")
    j_channel, j_scheme = \
        jax_tutorial.example_03_committing_to_the_trace_polynomials(4)
    assert len(scheme.trees) == len(j_scheme.trees) == 2
    assert channel.digest == j_channel.digest
    assert channel.channel_time.n_challenges == \
        j_channel.channel_time.n_challenges == 3
    assert list(scheme.roots()) == list(j_scheme.roots())
    assert scheme.config.pow_bits == j_scheme.config.pow_bits


def test_04_constraints_and_col3():
    cols = tutorial.example_04_constraints_over_trace_polynomial(
        4, device="cpu")
    j_cols = jax_tutorial.example_04_constraints_over_trace_polynomial(4)
    assert len(cols) == len(j_cols) == 3
    for a, b in zip(cols, j_cols):
        _equal(a, b)


def test_05_proof_equals_the_jax_proof():
    proof = tutorial.example_05_proving_an_air(4, device="cpu")
    j_proof = jax_tutorial.example_05_proving_an_air(4)
    assert proof.size_estimate() == j_proof.size_estimate() > 0
    assert json.dumps(proof_to_dict(proof), sort_keys=True) == \
        json.dumps(jax_to_dict(j_proof), sort_keys=True)
