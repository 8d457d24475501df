"""The DEEP quotient metrics: the byte count of `csrc.quotients_roofline`
against a brute count of what each reference commits while it proves at
small shapes, its value at the two cells, and both metrics listed for
both cells."""
from __future__ import annotations

import pytest

from bench_fixtures import REPO
from stark_bench import registry
from stark_bench.reference import merkle, prover
from stark_bench.reference import poseidon2 as p2_air
from stark_bench.reference import wide_fibonacci as wf_air

METRIC = registry._from_file(
    REPO / "stark_bench" / "metrics" / "csrc.quotients_roofline.py",
    "stark_bench_metric_quotients_roofline")
CELLS = ["wf100_b2s.2e20", "p2_b2s.2e17"]


def _config(air, n_columns=None):
    cfg = {"air": {"name": air}, "merkle_channel": "blake2s",
           "security": {"pow_bits": 2, "n_queries": 3,
                        "log_blowup_factor": 1,
                        "log_last_layer_degree_bound": 0}}
    if n_columns:
        cfg["air"]["n_columns"] = n_columns
    return cfg


def _brute_bytes(monkeypatch, air, owner, cfg, log_n):
    """4 bytes a value of every tree the reference commits up to the one
    it commits from the quotients, whose values it counts too."""
    events = []
    real_tree, real_quotient = merkle.MerkleTree.__init__, owner.deep_quotient

    def tree(self, hasher, columns, device):
        events.append(("tree", sum(int(c.numel()) for c in columns)))
        real_tree(self, hasher, columns, device)

    def quotient(*args, **kwargs):
        events.append(("quotient", 0))
        return real_quotient(*args, **kwargs)

    monkeypatch.setattr(merkle.MerkleTree, "__init__", tree)
    monkeypatch.setattr(owner, "deep_quotient", quotient)
    air.prove(air.trace_inputs(3, log_n), cfg, log_n, "cpu")
    last = max(i for i, (kind, _) in enumerate(events) if kind == "quotient")
    first = next(i for i in range(last, len(events))
                 if events[i][0] == "tree")
    return 4 * sum(n for kind, n in events[:first + 1] if kind == "tree")


@pytest.mark.parametrize("air,owner,n_columns,log_n", [
    (wf_air, prover, 6, 4), (wf_air, prover, 20, 5), (p2_air, p2_air, None, 3)])
def test_quotient_bytes_equal_a_brute_count_of_the_trees(
        monkeypatch, air, owner, n_columns, log_n):
    cfg = _config(air.__name__.rsplit(".", 1)[-1], n_columns)
    want = _brute_bytes(monkeypatch, air, owner, cfg, log_n)
    assert METRIC.quotient_bytes(air.merkle_trees(cfg, log_n)) == want


@pytest.mark.parametrize("cell,n_bytes", [
    ("wf100_b2s.2e20", 1_006_632_960), ("p2_b2s.2e17", 1_396_703_232)])
def test_quotient_bytes_of_the_cells(cell, n_bytes):
    bench = registry.load(REPO)
    entry = registry.workload(bench, cell)
    cfg = registry.config(REPO, bench, entry["config"])
    log_n = registry.traffic(REPO, entry["traffic"])["log_n_rows"]
    trees = registry.reference(registry.ROOT, cfg).merkle_trees(cfg, log_n)
    assert METRIC.quotient_bytes(trees) == n_bytes


def test_both_metrics_list_both_cells():
    bench = registry.load(REPO)
    for cell in CELLS:
        names = {m["name"] for m in registry.metrics_of(bench, "per_layer",
                                                        cell)}
        assert {"pcs.quotients_ms", "csrc.quotients_roofline"} <= names


def test_the_readers_find_nothing_without_the_kernel_or_the_span():
    from types import SimpleNamespace

    ctx = SimpleNamespace(span_ms={}, kernels=[("other_kernel", 1.0)],
                          n_profiled=2)
    assert METRIC.read(ctx) is None
    assert registry.metric_reader(REPO, "pcs.quotients_ms")(ctx) is None
    ctx.span_ms["fri_quotients"] = 12.5
    assert registry.metric_reader(REPO, "pcs.quotients_ms")(ctx) == 12.5
