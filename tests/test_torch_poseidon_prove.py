"""Whole-proof parity of the Poseidon252 flavour (tolerance 0), on the CPU.

`prove_basic_air(4, flavor="poseidon252")`, default PcsConfig: the port's
proof must equal the JAX package's field by field, each package's verifier
must accept the other's proof, mutated proofs must be refused, and the
committed golden fixture (which the GPU smoke run compares against) must
still be the JAX package's proof.  Neither package's `proof_to_dict`
serialises a proof whose digests are felts, so the encoding is here:
`proof_fields` gives the layout of `proof_to_dict` with every felt252 as 64
hex digits, and `proof_from_fields` loads it through a package's
`proof_from_dict` and turns the digests back into that package's
FieldElement252.

The fixture is written once from the JAX proof:

    JAX_PLATFORMS=cpu python tests/test_torch_poseidon_prove.py
"""
import copy
import json
import os

import pytest

from tstwo_tpu.channel.poseidon import FieldElement252 as JaxFelt
from tstwo_tpu.examples import basic_air as jax_basic_air
from tstwo_tpu.serialize import proof_from_dict as jax_from_dict
from tstwo_tpu_torch.channel.poseidon import FieldElement252
from tstwo_tpu_torch.examples import basic_air
from tstwo_tpu_torch.fri import FriVerificationError
from tstwo_tpu_torch.pcs import PcsConfig
from tstwo_tpu_torch.pcs.prover import CommitmentSchemeProver
from tstwo_tpu_torch.pcs.verifier import VerificationError
from tstwo_tpu_torch.serialize import proof_from_dict, proof_to_dict
from tstwo_tpu_torch.vcs.ops import MERKLE_OPS, Blake2sMerkleOps

LOG_N = 4
FLAVOR = "poseidon252"
FIXTURE = os.path.join(os.path.dirname(__file__), "data",
                       "torch_port_basic_air_poseidon_log4.json")


def proof_fields(proof) -> dict:
    """A proof of either package and either flavour in the layout of
    `proof_to_dict`; a felt252 digest as 64 hex digits, big-endian."""
    def digest(x):
        return x.hex() if isinstance(x, bytes) else f"{x.value:064x}"

    def decommitment(d):
        return {"hash_witness": [digest(h) for h in d.hash_witness],
                "column_witness": [m.value for m in d.column_witness]}

    def layer(l):
        return {"fri_witness": [list(v.to_ints()) for v in l.fri_witness],
                "decommitment": decommitment(l.decommitment),
                "commitment": digest(l.commitment)}

    p = proof.commitment_scheme_proof
    fri = p.config.fri_config
    return {
        "config": {"pow_bits": p.config.pow_bits, "fri_config": {
            "log_last_layer_degree_bound": fri.log_last_layer_degree_bound,
            "log_blowup_factor": fri.log_blowup_factor,
            "n_queries": fri.n_queries}},
        "commitments": [digest(c) for c in p.commitments],
        "sampled_values": [[[list(v.to_ints()) for v in col] for col in tree]
                           for tree in p.sampled_values],
        "decommitments": [decommitment(d) for d in p.decommitments],
        "queried_values": [[m.value for m in tree]
                           for tree in p.queried_values],
        "proof_of_work": p.proof_of_work,
        "fri_proof": {
            "first_layer": layer(p.fri_proof.first_layer),
            "inner_layers": [layer(l) for l in p.fri_proof.inner_layers],
            "last_layer_poly": [list(c.to_ints())
                                for c in p.fri_proof.last_layer_poly.coeffs]},
    }


def proof_from_fields(d: dict, from_dict, felt_cls):
    """The Poseidon252 proof of `proof_fields` as a proof object of the
    package whose `proof_from_dict` and FieldElement252 are given."""
    proof = from_dict(d)
    p = proof.commitment_scheme_proof

    def felt(b):
        return felt_cls(int.from_bytes(b, "big"))

    p.commitments = type(p.commitments)(felt(c) for c in p.commitments)
    layers = [p.fri_proof.first_layer] + list(p.fri_proof.inner_layers)
    for l in layers:
        l.commitment = felt(l.commitment)
    for dec in list(p.decommitments) + [l.decommitment for l in layers]:
        dec.hash_witness = [felt(h) for h in dec.hash_witness]
    return proof


def _json(d):
    return json.dumps(d, sort_keys=True)


@pytest.fixture(scope="module")
def jax_run():
    proof, component, config = jax_basic_air.prove_basic_air(LOG_N,
                                                             flavor=FLAVOR)
    return proof, component, config, proof_fields(proof)


@pytest.fixture(scope="module")
def port_run():
    proof, component, config = basic_air.prove_basic_air(
        LOG_N, device="cpu", flavor=FLAVOR)
    return proof, component, config, proof_fields(proof)


def test_golden_fixture_is_the_jax_proof(jax_run):
    with open(FIXTURE) as f:
        assert f.read().strip() == _json(jax_run[3])


@pytest.mark.parametrize("field", [
    "config", "commitments", "sampled_values", "queried_values",
    "decommitments", "proof_of_work", "fri_proof.first_layer",
    "fri_proof.inner_layers", "fri_proof.last_layer_poly"])
def test_port_proof_equals_jax_proof_field_by_field(port_run, jax_run, field):
    ours, theirs = port_run[3], jax_run[3]
    for key in field.split("."):
        ours, theirs = ours[key], theirs[key]
    assert ours == theirs
    assert ours not in ([], {})


def test_port_proof_holds_felt252_digests(port_run):
    p = port_run[0].commitment_scheme_proof
    digests = list(p.commitments) + [p.fri_proof.first_layer.commitment] + \
        [h for d in p.decommitments for h in d.hash_witness]
    assert len(digests) > 4
    assert all(isinstance(x, FieldElement252) for x in digests)
    assert len(p.commitments) == 3 and len(p.fri_proof.inner_layers) >= 3


def test_port_verifier_accepts_its_own_and_the_jax_proof(port_run, jax_run):
    proof, component, config, _ = port_run
    basic_air.verify_basic_air(proof, component, config, LOG_N, flavor=FLAVOR)
    basic_air.verify_basic_air(
        proof_from_fields(jax_run[3], proof_from_dict, FieldElement252),
        component, config, LOG_N, flavor=FLAVOR)


def test_jax_verifier_accepts_port_proof(port_run, jax_run):
    _, component, config, _ = jax_run
    jax_basic_air.verify_basic_air(
        proof_from_fields(port_run[3], jax_from_dict, JaxFelt),
        component, config, LOG_N, flavor=FLAVOR)


def _bump(x):
    if isinstance(x, list):
        return [(x[0] + 1) % ((1 << 31) - 1)] + x[1:]
    return (x + 1) % ((1 << 31) - 1)


def _flip_hex(h):
    return h[:-1] + ("0" if h[-1] != "0" else "1")


MUTATIONS = {
    "tampered_queried_value": lambda d: d["queried_values"][1].__setitem__(
        0, _bump(d["queried_values"][1][0])),
    "tampered_sampled_value": lambda d: d["sampled_values"][1][0]
    .__setitem__(0, _bump(d["sampled_values"][1][0][0])),
    "tampered_trace_commitment": lambda d: d["commitments"].__setitem__(
        1, _flip_hex(d["commitments"][1])),
    "tampered_hash_witness": lambda d: d["decommitments"][1]["hash_witness"]
    .__setitem__(0, _flip_hex(d["decommitments"][1]["hash_witness"][0])),
    "tampered_first_layer_commitment": lambda d: d["fri_proof"][
        "first_layer"].__setitem__("commitment", _flip_hex(
            d["fri_proof"]["first_layer"]["commitment"])),
    "invalid_inner_layer_decommitment": lambda d: d["fri_proof"][
        "inner_layers"][0]["decommitment"]["hash_witness"].__setitem__(
            0, _flip_hex(d["fri_proof"]["inner_layers"][0]["decommitment"][
                "hash_witness"][0])),
    "invalid_inner_layer_evaluation": lambda d: d["fri_proof"][
        "inner_layers"][0]["fri_witness"].__setitem__(0, _bump(
            d["fri_proof"]["inner_layers"][0]["fri_witness"][0])),
    "invalid_last_layer": lambda d: d["fri_proof"]["last_layer_poly"]
    .__setitem__(0, _bump(d["fri_proof"]["last_layer_poly"][0])),
    "wrong_proof_of_work": lambda d: d.__setitem__(
        "proof_of_work", d["proof_of_work"] + 1),
}


@pytest.mark.parametrize("name", sorted(MUTATIONS))
def test_port_verifier_rejects_mutated_proof(port_run, name):
    _, component, config, d = port_run
    bad = copy.deepcopy(d)
    MUTATIONS[name](bad)
    assert bad != d
    with pytest.raises((VerificationError, FriVerificationError)):
        basic_air.verify_basic_air(
            proof_from_fields(bad, proof_from_dict, FieldElement252),
            component, config, LOG_N, flavor=FLAVOR)


def test_blake2s_verifier_refuses_the_poseidon_proof(port_run):
    proof, component, config, _ = port_run
    with pytest.raises((VerificationError, FriVerificationError, TypeError,
                        AttributeError)):
        basic_air.verify_basic_air(proof, component, config, LOG_N)


def test_port_proof_to_dict_refuses_felt_digests_as_the_jax_one(port_run,
                                                               jax_run):
    """Both packages' `proof_to_dict` call `.hex()` on a digest."""
    from tstwo_tpu.serialize import proof_to_dict as jax_to_dict

    with pytest.raises(AttributeError, match="hex"):
        proof_to_dict(port_run[0])
    with pytest.raises(AttributeError, match="hex"):
        jax_to_dict(jax_run[0])


def test_blake2s_proof_is_unchanged_by_the_flavour_argument():
    """No flavour given and the Blake2s flavour by name give the same
    bytes, and a scheme without `merkle_ops` holds the Blake2s ops."""
    default = proof_to_dict(basic_air.prove_basic_air(LOG_N, device="cpu")[0])
    named = proof_to_dict(basic_air.prove_basic_air(
        LOG_N, device="cpu", flavor="blake2s")[0])
    assert _json(default) == _json(named)
    assert proof_fields(proof_from_dict(default)) == default
    scheme = CommitmentSchemeProver(PcsConfig(), None, "cpu")
    assert scheme.merkle_ops is MERKLE_OPS["blake2s"] is Blake2sMerkleOps
    assert sorted(MERKLE_OPS) == ["blake2s", "poseidon252"]
    with pytest.raises(KeyError):
        basic_air.prove_basic_air(LOG_N, device="cpu", flavor="keccak")


def test_poseidon_prove_defaults_to_the_card_and_raises_without_one():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        basic_air.prove_basic_air(LOG_N, flavor=FLAVOR)


if __name__ == "__main__":
    run = jax_basic_air.prove_basic_air(LOG_N, flavor=FLAVOR)
    with open(FIXTURE, "w") as out:
        out.write(_json(proof_fields(run[0])) + "\n")
    print(f"wrote {FIXTURE}")
