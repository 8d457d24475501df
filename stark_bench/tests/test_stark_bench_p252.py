"""The Poseidon252 cell `wf100_p252.2e20`: the registry finds its files by
name, its proof is compared over a STARK proof's five parts, each of its
four readers reads its number from a context and nothing where the
program has no span, counter or kernel, and a whole run of the cell's
files at 2^4 rows (pow_bits 12, 3 queries) on the CPU is correct."""
from __future__ import annotations

import copy
import json
from types import SimpleNamespace

import pytest
import torch

from bench_fixtures import REPO, _add_cell, _copy
from stark_bench import registry, run, span_trace
from stark_bench.compare import PARTS, parts_of
from stark_bench.reference import wide_fibonacci_p252
from stark_bench.traffic import ClosedLoop

CELL = "wf100_p252.2e20"
METRICS = ["proof_of_work.grind_ms", "csrc.poseidon_grind_roofline",
           "csrc.poseidon_merkle_roofline", "channel.host_hades"]
BENCH = registry.load(REPO)


def _config():
    return registry.config(REPO, BENCH, registry.workload(BENCH, CELL)[
        "config"])


def _small(cfg):
    cfg = copy.deepcopy(cfg)
    cfg["air"]["n_columns"] = 8
    cfg["security"].update(pow_bits=12, n_queries=3)
    return cfg


def test_registry_finds_every_file_of_the_cell():
    entry = registry.workload(BENCH, CELL)
    assert (entry["config"], entry["traffic"], entry["chips"]) == (
        "wide_fib100_poseidon252", "closed.2e20.check1", 1)
    cfg = _config()
    assert cfg["air"]["name"] == cfg["air"]["recipe"] == \
        "wide_fibonacci_p252"
    assert cfg["merkle_channel"] == "poseidon252" and cfg["reduced"] == []
    blake = registry.config(REPO, BENCH, "wide_fib100_blake2s")
    assert cfg["security"] == blake["security"]
    assert cfg["guarantees"] == blake["guarantees"]
    assert {k: v for k, v in cfg["air"].items() if k not in (
        "name", "recipe")} == {k: v for k, v in blake["air"].items()
                               if k not in ("name", "recipe")}
    mix = registry.traffic(REPO, entry["traffic"])
    assert mix["log_n_rows"] == 20 and mix["check_proofs"] == 1
    assert {k: v for k, v in mix.items() if k not in (
        "check_proofs", "about")} == {
        k: v for k, v in registry.traffic(REPO, "closed.2e20").items()
        if k not in ("check_proofs", "about")}
    recipe = registry.recipe(REPO, cfg)
    assert callable(recipe.prove) and callable(recipe.proof_fields)
    assert registry.reference(REPO, cfg) is wide_fibonacci_p252
    names = [m["name"] for m in registry.metrics_of(BENCH, "per_layer", CELL)]
    assert names == METRICS
    for m in BENCH["per_layer"]:
        if m["name"] in METRICS:
            assert m["workloads"] == [CELL] and m["moves"] == "prove_s"


def test_the_parts_are_a_stark_proofs_five():
    assert parts_of(_config()) == dict(PARTS)


def _reader(name):
    return registry.metric_reader(REPO, name)


def _ctx(span_ms=None, kernels=(), span_tree=None, config=None):
    cfg = config or _config()
    ctx = SimpleNamespace(
        span_ms=span_ms or {}, kernels=list(kernels), n_profiled=1,
        config=cfg, log_n=4, reference=wide_fibonacci_p252,
        traffic={"loop": "closed", "provers": 1, "log_n_rows": 4,
                 "warm_proofs": 1, "check_proofs": 1, "profiled_proofs": 1,
                 "span_proofs": 2})
    if span_tree is not None:  # measure(ctx) finds it and proves nothing
        ctx.span_tree = span_tree
    return ctx


def test_each_reader_reads_its_number():
    cfg = _small(_config())
    perms = wide_fibonacci_p252.poseidon_permutations(cfg, 4)
    tree = {"records": [{}], "counts": {None: {"host_hades": 7},
                                        4: {"host_hades": 110},
                                        5: {"host_hades": 130}},
            "n": 2}
    kernels = [("(anonymous namespace)::poseidon_merkle_layer_kernel(x)",
                perms * 33_308 / 1.675e13 * 4),
               ("(anonymous namespace)::poseidon_grind_kernel(x)", 1.0),
               ("other_kernel", 5.0)]
    ctx = _ctx({"grind": 25.5}, kernels, tree, cfg)
    assert _reader("proof_of_work.grind_ms")(ctx) == 25.5
    assert _reader("channel.host_hades")(ctx) == 120.0
    assert _reader("csrc.poseidon_merkle_roofline")(ctx) == \
        pytest.approx(25.0)
    # the profiled proof, the run's first, proved again for its nonce: 2
    # (nonce + 1) permutations of 33,308 operations over a second of kernel
    recipe = registry.recipe(REPO, cfg)
    trace_seed = ClosedLoop(ctx.traffic, span_trace._run_seed()).trace_seed(0)
    nonce = recipe.proof_fields(recipe.prove(cfg, 4, trace_seed, "cpu"))[
        "proof_of_work"]
    assert _reader("csrc.poseidon_grind_roofline")(ctx) == pytest.approx(
        100 * 2 * (nonce + 1) * 33_308 / 1.675e13)


@pytest.mark.parametrize("ctx", [
    _ctx(span_tree={}),
    _ctx(span_tree={"records": [{}], "counts": {0: {"upload_bytes": 3}},
                    "n": 2}),
    _ctx(config=registry.config(REPO, BENCH, "wide_fib100_blake2s"),
         kernels=[("poseidon_merkle_layer_kernel", 1.0),
                  ("poseidon_grind_kernel", 1.0)], span_tree={}),
], ids=["no_tree", "no_counter", "blake2s"])
def test_each_reader_finds_nothing_without_its_span_counter_or_kernel(ctx):
    for name in METRICS:
        assert _reader(name)(ctx) is None, name


def test_a_run_of_the_cell_at_2e4_is_correct(tmp_path):
    """The cell's configuration, recipe and reference under a traffic mix
    of 2^4 rows, pow_bits 12 and 3 queries, run whole on the CPU: correct,
    the five parts compared, one proof checked.  Untraced: the profiler
    records a plain CPU permutation's ~25,000 operations one by one (a
    traced run takes ~8 minutes here); the readers are held above."""
    root = _copy(tmp_path)
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    cfg = dict(_small(_config()), name="p252_small")
    mix = dict(registry.traffic(REPO, "closed.2e20.check1"), log_n_rows=4,
               warm_proofs=1)
    _add_cell(root, bench, "p252_small", cfg, mix,
              bench["end_to_end"] + [m for m in bench["per_layer"]
                                     if m["name"] in METRICS])
    result = run.run_cell(root, registry.load(root), "p252_small.cell",
                          2 ** 35 + 1, 0.5, False, torch.device("cpu"),
                          t0=0.0)
    assert result["correct"] is True
    assert list(result["checks"]) == list(PARTS) + [
        "failed_proofs", "proofs_compared"]
    assert all(result["checks"][p]["value"] == 0 for p in PARTS)
    assert result["checks"]["proofs_compared"]["value"] == 1
    assert {"setup_s", "prove_s"} <= set(result["metrics"])
