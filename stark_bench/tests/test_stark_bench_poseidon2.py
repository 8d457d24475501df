"""The Poseidon2 cell's reference: the yardstick of its constraint kernel's
roofline against a brute count of its own evaluation, its transforms and
trees against those it makes, and the registry finding each of the cell's
files by name."""
from __future__ import annotations

import json
from collections import Counter

import pytest

from bench_fixtures import CountingField
from stark_bench import registry, roofline
from stark_bench.reference import merkle
from stark_bench.reference import poseidon2 as air
from stark_bench.reference.hashes import n_blocks

CELL = "p2_b2s.2e17"
CONFIG = {"air": {"name": "poseidon2"}, "merkle_channel": "blake2s",
          "security": {"pow_bits": 2, "n_queries": 3, "log_blowup_factor": 1,
                       "log_last_layer_degree_bound": 0}}


@pytest.mark.parametrize("log_n", [3, 17])
def test_constraint_ops_equal_a_brute_count_of_the_evaluation(log_n):
    CountingField.ops = 0
    q = (1, 2, 3, 4)
    air.row_composition(CountingField, [0] * air.N_COLUMNS,
                        [0] * air.INTERACTION_COLUMNS, [0] * 4,
                        [q] * air.N_STATE, q, [q] * air.N_CONSTRAINTS, q, 5)
    assert air.constraint_ops(CONFIG, log_n) == \
        CountingField.ops << (log_n + air.LOG_EXPAND)
    assert CountingField.ops == 151428


def test_cfft_transforms_are_those_the_reference_makes(monkeypatch):
    made = Counter()
    real_eval, real_interp = air.evaluate, air.interpolate

    def evaluate(coeffs, log_size):
        made[(coeffs.shape[0], log_size,
              coeffs.shape[1].bit_length() - 1)] += 1
        return real_eval(coeffs, log_size)

    def interpolate(values, log_size):
        made[(values.shape[0], log_size, log_size)] += 1
        return real_interp(values, log_size)

    monkeypatch.setattr(air, "evaluate", evaluate)
    monkeypatch.setattr(air, "interpolate", interpolate)
    air.prove(air.trace_inputs(4, 3), CONFIG, 3, "cpu")
    assert made == Counter(air.cfft_transforms(CONFIG, 3))


def test_merkle_blocks_equal_the_blocks_the_reference_hashes(monkeypatch):
    counted = []
    real = merkle.blake2s_words

    def counting(words, n, device):
        counted.append(n * n_blocks(4 * len(words)))
        return real(words, n, device)

    monkeypatch.setattr(merkle, "blake2s_words", counting)
    monkeypatch.setattr(merkle, "HOST_LAYER_NODES", 0)
    air.prove(air.trace_inputs(3, 3), CONFIG, 3, "cpu")
    trees = air.merkle_trees(CONFIG, 3)
    assert sum(counted) == sum(roofline.merkle_blocks(t)[0] for t in trees)


def test_registry_finds_every_file_of_the_cell():
    bench = registry.load()
    entry = registry.workload(bench, CELL)
    assert (entry["config"], entry["traffic"], entry["chips"]) == (
        "poseidon2_logup_blake2s", "closed.2e17", 1)
    cfg = registry.config(registry.ROOT, bench, entry["config"])
    assert {k: cfg["air"][k] for k in (
        "name", "recipe", "n_instances_per_row", "n_columns",
        "n_constraints", "constraint_degree", "log_expand",
        "relation_width")} == {
        "name": "poseidon2", "recipe": "poseidon2", "n_instances_per_row": 8,
        "n_columns": 1264, "n_constraints": 1136, "constraint_degree": 5,
        "log_expand": 2, "relation_width": 16}
    with open(registry.ROOT / "stark_bench" / "configs" /
              "wide_fib100_blake2s.json") as f:
        wide_fib = json.load(f)
    assert cfg["security"] == wide_fib["security"]
    assert cfg["guarantees"] == wide_fib["guarantees"]
    assert cfg["reduced"] == [] and cfg["merkle_channel"] == "blake2s"
    mix = registry.traffic(registry.ROOT, entry["traffic"])
    assert mix["log_n_rows"] == 17
    recipe = registry.recipe(registry.ROOT, cfg)
    assert callable(recipe.prove) and callable(recipe.proof_fields)
    reference = registry.reference(registry.ROOT, cfg)
    assert reference is air
    metrics = [m["name"] for m in registry.metrics_of(bench, "per_layer",
                                                      CELL)]
    assert {"constraint_framework.interaction_ms",
            "csrc.constraint_eval_roofline"} <= set(metrics)
    for name in metrics:
        assert callable(registry.metric_reader(registry.ROOT, name))
