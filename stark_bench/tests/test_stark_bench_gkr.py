"""The GKR lookups cell `gkr_b2s.2e20`: the registry finds its files by
name, its proof is compared over the three parts of a GKR batch proof, the
reference's control differs in all three, each of its four readers reads
its number from a context and nothing where the program has no span or
counter, and a whole traced run of the cell at 2^4 on the CPU is correct."""
from __future__ import annotations

import json
from types import SimpleNamespace

import pytest
import torch

from bench_fixtures import GKR_PARTS, REPO, _add_cell, _copy
from stark_bench import registry, run
from stark_bench.compare import compare, parts_of
from stark_bench.reference import gkr_lookups

CELL = "gkr_b2s.2e20"
METRICS = ["lookups.gkr_sumcheck_ms", "lookups.gkr_layers_ms",
           "lookups.gkr_sumcheck_idle_ms", "lookups.launches_per_round"]
BENCH = registry.load(REPO)


def _config():
    return registry.config(REPO, BENCH, registry.workload(BENCH, CELL)[
        "config"])


def test_registry_finds_every_file_of_the_cell():
    entry = registry.workload(BENCH, CELL)
    assert (entry["config"], entry["traffic"], entry["chips"]) == (
        "gkr_gp_logup_blake2s", "closed.2e20", 1)
    cfg = _config()
    assert cfg["air"]["name"] == cfg["air"]["recipe"] == "gkr_lookups"
    assert cfg["air"]["instances"] == ["GrandProduct", "LogUpGeneric"]
    assert cfg["channel"] == "blake2s" and cfg["reduced"] == []
    assert registry.traffic(REPO, entry["traffic"])["log_n_rows"] == 20
    recipe = registry.recipe(REPO, cfg)
    assert callable(recipe.prove) and callable(recipe.proof_fields)
    assert registry.reference(REPO, cfg) is gkr_lookups
    names = [m["name"] for m in registry.metrics_of(BENCH, "per_layer", CELL)]
    assert names == METRICS
    for m in BENCH["per_layer"]:
        if m["name"] in METRICS:
            assert m["workloads"] == [CELL] and m["moves"] == "prove_s"
            assert m["layer"] == "lookups (lookups/gkr.py, sumcheck.py, " \
                                 "mle.py)"


def test_the_parts_are_a_gkr_batch_proofs_three():
    assert parts_of(_config()) == {k: tuple(v) for k, v in GKR_PARTS.items()}


def test_the_control_differs_in_all_three_parts():
    cfg = _config()
    inputs = gkr_lookups.trace_inputs(2 ** 40 + 3, 4)
    sound = gkr_lookups.prove(inputs, cfg, 4, "cpu")
    label, control = gkr_lookups.control(inputs, cfg, 4, "cpu")
    assert label == "one GrandProduct value changed"
    readings = compare(control, sound, parts_of(cfg))
    assert list(readings) == list(GKR_PARTS)
    assert all(n > 0 for n in readings.values())
    assert not any(compare(sound, sound, parts_of(cfg)).values())


def _reader(name):
    return registry.metric_reader(REPO, name)


def _ctx(span_ms=None, launches=None, span_tree=None):
    ctx = SimpleNamespace(span_ms=span_ms or {}, launches=launches,
                          n_profiled=2)
    if span_tree is not None:  # measure(ctx) finds it and proves nothing
        ctx.span_tree = span_tree
    return ctx


def test_each_reader_reads_its_number():
    tree = {"records": [], "counts": {None: {"sumcheck_rounds": 7},
                                      4: {"sumcheck_rounds": 190},
                                      5: {"sumcheck_rounds": 190}},
            "n": 2, "profile": {"idle_inside": {"gkr_sumcheck": 3.0}},
            "n_profiled": 2}
    ctx = _ctx({"gkr_sumcheck": 2500.0, "gkr_layers": 12.5}, 627_000, tree)
    assert _reader("lookups.gkr_sumcheck_ms")(ctx) == 2500.0
    assert _reader("lookups.gkr_layers_ms")(ctx) == 12.5
    assert _reader("lookups.gkr_sumcheck_idle_ms")(ctx) == 1500.0
    assert _reader("lookups.launches_per_round")(ctx) == 627_000 / 2 / 190


@pytest.mark.parametrize("ctx", [
    _ctx(span_tree={}),
    _ctx(launches=627_000, span_tree={"records": [], "counts": {0: {}},
                                      "n": 2, "profile": {},
                                      "n_profiled": 2}),
    _ctx(span_tree={"records": [], "counts": {0: {"sumcheck_rounds": 190}},
                    "n": 1, "profile": {"idle_inside": {}},
                    "n_profiled": 2}),
], ids=["no_tree", "no_counter", "no_launches"])
def test_each_reader_finds_nothing_without_its_span_or_counter(ctx):
    for name in METRICS:
        assert _reader(name)(ctx) is None, name


def test_a_traced_run_of_the_cell_at_2e4_is_correct(tmp_path):
    """The cell's configuration, recipe and reference under a traffic mix
    of 2^4 points, run whole on the CPU: correct, the three parts compared,
    and the span metrics read (the device metrics find no device)."""
    root = _copy(tmp_path)
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    cfg = dict(_config(), name="gkr_small")
    mix = {"loop": "closed", "provers": 1, "log_n_rows": 4,
           "warm_proofs": 1, "check_proofs": 2, "profiled_proofs": 2,
           "span_proofs": 2}
    _add_cell(root, bench, "gkr_small", cfg, mix,
              bench["end_to_end"] + [m for m in bench["per_layer"]
                                     if m["name"] in METRICS])
    result = run.run_cell(root, registry.load(root), "gkr_small.cell",
                          2 ** 35 + 1, 0.5, True, torch.device("cpu"),
                          t0=0.0)
    assert result["correct"] is True
    assert list(result["checks"]) == list(GKR_PARTS) + [
        "failed_proofs", "proofs_compared"]
    assert all(result["checks"][p]["value"] == 0 for p in GKR_PARTS)
    assert result["checks"]["proofs_compared"]["value"] == 2
    assert set(result["metrics"]) == {"lookups.gkr_sumcheck_ms",
                                      "lookups.gkr_layers_ms"}
