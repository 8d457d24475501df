"""The comparison's parts: read from each configuration, a STARK proof's
five without `proof_parts`, and a proof that is not a STARK proof compared
over its own parts."""
from __future__ import annotations

import copy
import json

import pytest

from bench_fixtures import GKR_PARTS, REPO
from stark_bench import registry
from stark_bench.compare import PARTS, compare, parts_of

BENCH = registry.load(REPO)


def _gkr_proof() -> dict:
    """A GKR batch proof's shape, as plain data: two instances."""
    def q():
        return [1, 2, 3, 4]

    return {
        "sumcheck_proofs": [{"round_polys": [[q(), q(), q()], [q(), q()]]}
                            for _ in range(3)],
        "layer_masks_by_instance": [[[[q(), q()], [q(), q()]], [[q(), q()]]],
                                    [[[q(), q()]]]],
        "output_claims_by_instance": [[q(), q()], [q()]],
    }


def _first_leaf(x, path=()):
    if isinstance(x, dict):
        key = sorted(x)[0]
        return _first_leaf(x[key], path + (key,))
    if isinstance(x, list):
        return _first_leaf(x[0], path + (0,))
    return path


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_the_accepted_configurations_compare_a_stark_proofs_five_parts(
        config):
    parts = parts_of(registry.config(REPO, BENCH, config))
    assert list(parts) == ["commitments", "oods_values", "fri",
                           "proof_of_work", "decommitment"]
    assert parts == PARTS


def test_equal_gkr_proofs_read_0_in_every_part():
    parts = parts_of({"proof_parts": GKR_PARTS})
    assert list(parts) == ["sumcheck", "layer_masks", "output_claims"]
    assert compare(_gkr_proof(), _gkr_proof(), parts) == dict.fromkeys(
        parts, 0)


@pytest.mark.parametrize("part", list(GKR_PARTS))
def test_one_changed_leaf_reads_in_its_part_alone(part):
    parts = parts_of({"proof_parts": GKR_PARTS})
    changed = _gkr_proof()
    key = GKR_PARTS[part][0]
    node = changed[key]
    *path, last = _first_leaf(node)
    for step in path:
        node = node[step]
    node[last] += 1
    readings = compare(changed, _gkr_proof(), parts)
    assert readings[part] >= 1
    assert all(n == 0 for name, n in readings.items() if name != part)


@pytest.mark.parametrize("missing", ["one side", "both sides"])
def test_a_part_missing_from_a_proof_differs(missing):
    parts = parts_of({"proof_parts": GKR_PARTS})
    program = _gkr_proof()
    reference = _gkr_proof()
    del program["output_claims_by_instance"]
    if missing == "both sides":
        del reference["output_claims_by_instance"]
    readings = compare(program, reference, parts)
    assert readings == {"sumcheck": 0, "layer_masks": 0,
                        "output_claims": readings["output_claims"]}
    assert readings["output_claims"] >= 1
    assert all(n >= 1 for n in compare({}, {}, parts).values())
    assert all(n >= 1 for n in compare({}, {}).values())


@pytest.mark.parametrize("declared", [{}, {"sumcheck": []},
                                      {"failed_proofs": ["x"]},
                                      {"proofs_compared": ["x"]}])
def test_parts_that_compare_nothing_or_take_a_checks_name_are_refused(
        declared):
    with pytest.raises(ValueError):
        parts_of({"proof_parts": declared})


def test_a_stark_proof_compares_as_before_without_parts():
    """Two arguments: the STARK parts, over every key of the proof."""
    config = json.loads((REPO / "stark_bench" / "configs" /
                         "wide_fib100_blake2s.json").read_text())
    proof = {"commitments": ["ab"], "sampled_values": [[[q]] for q in
                                                       ([1, 2, 3, 4],)],
             "fri": {"first_layer": {"commitment": "cd"}},
             "proof_of_work": 7,
             "queried_values": [[1, 2]], "decommitments": [{"x": [3]}]}
    other = copy.deepcopy(proof)
    other["queried_values"][0][1] = 5
    other["proof_of_work"] = 8
    assert compare(proof, other) == compare(proof, other, parts_of(config))
    assert compare(proof, other) == {"commitments": 0, "oods_values": 0,
                                     "fri": 0, "proof_of_work": 1,
                                     "decommitment": 1}
