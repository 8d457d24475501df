"""The port's span tree (`tracing.enable(sync=False)`): records with parents
and request ids, counters on the innermost span, the transfer counters of
the numpy bridge, and the disabled span's shared no-op.  No JAX here."""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from tstwo_tpu_torch import kernels, tracing
from tstwo_tpu_torch.utils import to_host_list, to_numpy_u32, to_torch_u32


@pytest.fixture(autouse=True)
def _tracing_off():
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


def _children(recs, index):
    return [r["name"] for r in recs if r["parent"] == index]


@pytest.fixture(scope="module")
def cpu_prove_records():
    from tstwo_tpu_torch.examples.wide_fibonacci import prove_wide_fibonacci

    tracing.reset()
    tracing.enable(sync=False)
    try:
        with tracing.request(7):
            prove_wide_fibonacci(5, 4, seed=0, device="cpu")
        return tracing.records()
    finally:
        tracing.disable()
        tracing.reset()


def test_a_cpu_prove_gives_a_span_tree_under_its_request(cpu_prove_records):
    recs = cpu_prove_records
    assert recs and all(r["request"] == 7 for r in recs)
    (root,) = [i for i, r in enumerate(recs) if r["name"] == "prove"]
    assert recs[root]["parent"] is None
    (dec,) = [i for i, r in enumerate(recs) if r["name"] == "decommitment"]
    assert recs[dec]["parent"] == root
    assert _children(recs, dec) == ["fri_decommit"] + ["tree_decommit"] * 3
    (fri,) = [i for i, r in enumerate(recs) if r["name"] == "fri_decommit"]
    assert _children(recs, fri) == ["queries", "first_layer", "inner_layers"]
    trees = [i for i, r in enumerate(recs) if r["name"] == "tree_decommit"]
    # the preprocessed tree of wide Fibonacci holds no column: nothing to
    # read; the trace and composition trees fetch their witness once
    assert [_children(recs, i) for i in trees] == [
        ["plan", "assemble"], ["plan", "fetch", "assemble"],
        ["plan", "fetch", "assemble"]]


def test_parents_open_before_their_children_and_close_after(
        cpu_prove_records):
    recs = cpu_prove_records
    for i, r in enumerate(recs):
        assert r["t0"] <= r["t1"]
        assert r["device_t0"] is None and r["device_t1"] is None  # no CUDA
        if r["parent"] is not None:
            p = recs[r["parent"]]
            assert r["parent"] < i
            assert p["t0"] <= r["t0"] and r["t1"] <= p["t1"]


def test_the_default_mode_keeps_its_records_and_ignores_counters():
    tracing.enable()
    with tracing.request(3):
        with tracing.span("outer"):
            tracing.count("upload_bytes", 8)
            with tracing.span("inner"):
                pass
    assert [sorted(r) for r in tracing.records()] == [
        ["name", "seconds", "t0"]] * 2
    assert [r["name"] for r in tracing.records()] == ["inner", "outer"]
    assert tracing.counts() == {}


def test_count_lands_on_the_innermost_open_span_and_the_request():
    tracing.enable(sync=False)
    tracing.count("outside", 1)
    with tracing.request("r"):
        with tracing.span("a"):
            tracing.count("x", 2)
            with tracing.span("b"):
                tracing.count("x", 3)
            tracing.count("y", 1)
    a, b = tracing.records()
    assert a["counts"] == {"x": 2, "y": 1} and b["counts"] == {"x": 3}
    assert (a["parent"], b["parent"]) == (None, 0)
    assert tracing.counts() == {None: {"outside": 1}, "r": {"x": 5, "y": 1}}


def test_a_span_holds_the_hand_kernel_launches_made_inside_it(monkeypatch):
    tracing.enable(sync=False)
    with tracing.span("outer"):
        monkeypatch.setitem(kernels.LAUNCHES, "merkle_layer",
                            kernels.LAUNCHES["merkle_layer"] + 2)
        with tracing.span("inner"):
            monkeypatch.setitem(kernels.LAUNCHES, "cfft_forward",
                                kernels.LAUNCHES["cfft_forward"] + 3)
    assert [r["launches"] for r in tracing.records()] == [5, 3]


@pytest.mark.parametrize("device,counted", [("cpu", False), ("meta", True)])
def test_to_torch_u32_counts_an_upload_only_off_the_cpu(device, counted):
    arr = np.arange(1000, dtype=np.uint32)
    tracing.enable(sync=False)
    with tracing.request(0):
        with tracing.span("site"):
            out = to_torch_u32(arr, device)
    assert out.device.type == device and tuple(out.shape) == (1000,)
    want = {"upload_bytes": arr.nbytes, "uploads": 1} if counted else {}
    assert tracing.records()[0]["counts"] == want
    assert tracing.counts() == {0: want}


@pytest.mark.parametrize("kind,names", [
    ("upload", ("upload_bytes", "uploads")),
    ("fetch", ("fetch_bytes", "fetches"))])
def test_a_transfer_off_the_cpu_counts_its_bytes_and_one_call(kind, names):
    from tstwo_tpu_torch.utils import _count_transfer

    t = torch.zeros((3, 5), dtype=torch.int64)
    tracing.enable(sync=False)
    with tracing.request(0):
        _count_transfer(kind, t, "meta")
        _count_transfer(kind, t, "cpu")
    assert tracing.counts() == {0: {names[0]: 120, names[1]: 1}}


def test_a_host_read_runs_under_a_fetch_span_and_counts_nothing_on_the_cpu():
    t = torch.arange(6, dtype=torch.int32).reshape(2, 3)
    tracing.enable(sync=False)
    with tracing.span("site"):
        host = to_numpy_u32(t)
        values = to_host_list(t[:, 0])
    assert host.dtype == np.uint32 and host.tolist() == t.tolist()
    assert values == [0, 3]
    recs = tracing.records()
    assert [(r["name"], r["parent"]) for r in recs] == [
        ("site", None), ("fetch", 0), ("fetch", 0)]
    assert all(r["counts"] == {} for r in recs)


def test_tracing_off_a_span_is_one_shared_object_that_opens_no_range(
        tmp_path):
    assert tracing.span("x") is tracing.span("y")
    assert tracing.request(1) is tracing.span("z")

    def body():
        with tracing.span("off_range"):
            tracing.count("uploads", 1)

    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        body()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    names = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}
    assert "off_range" not in names
    assert tracing.records() == [] and tracing.counts() == {}


def test_the_span_tree_opens_a_profiler_range_for_every_span(tmp_path):
    tracing.enable(sync=False)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tracing.request(0):
            with tracing.span("tree_outer"):
                with tracing.span("tree_inner"):
                    pass
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    ranges = {e["name"]: e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("cat") == "user_annotation"}
    assert {"tree_outer", "tree_inner"} <= set(ranges)
    outer, inner = ranges["tree_outer"], ranges["tree_inner"]
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]


def test_profile_prove_sums_the_tree_by_path(cpu_prove_records):
    from tstwo_tpu_torch.profile_prove import span_table

    rows = {r["span"]: r for r in span_table(cpu_prove_records)}
    tree = rows["prove > decommitment > tree_decommit"]
    assert tree["calls"] == 3
    assert rows["prove > decommitment > tree_decommit > fetch"]["calls"] == 2
    for row in rows.values():
        assert 0 <= row["self_ms"] <= row["host_ms"] + 1e-9
        assert row["device_ms"] == 0.0 and row["launches"] == 0
    children = sum(r["host_ms"] for span, r in rows.items()
                   if span.startswith("prove > decommitment > tree_decommit >"
                                      ) and span.count(">") == 3)
    assert tree["self_ms"] == pytest.approx(tree["host_ms"] - children)


def test_profile_prove_sums_counters_over_a_span_and_its_children():
    from tstwo_tpu_torch.profile_prove import span_table

    tracing.enable(sync=False)
    with tracing.request(0):
        with tracing.span("a"):
            tracing.count("uploads", 1)
            with tracing.span("b"):
                tracing.count("fetch_bytes", 8)
    rows = {r["span"]: r for r in span_table(tracing.records())}
    assert (rows["a"]["uploads"], rows["a"]["fetch_bytes"]) == (1, 8)
    assert (rows["a > b"]["uploads"], rows["a > b"]["fetch_bytes"]) == (0, 8)


def test_every_tree_counts_its_decommitted_hashes_and_values():
    """`decommit_hashes` and `decommit_values` land on each tree's
    `assemble` span: its hash witness, and its queried values plus its
    column witness (a FRI layer's tree queries every leaf it opens, 4
    coordinates each, and keeps those values out of the proof)."""
    from tstwo_tpu_torch.examples.wide_fibonacci import prove_wide_fibonacci

    tracing.enable(sync=False)
    with tracing.request(5):
        proof, _, _ = prove_wide_fibonacci(5, 4, seed=1, device="cpu")
    counts = [r["counts"] for r in tracing.records()
              if r["name"] == "assemble"]
    p = proof.commitment_scheme_proof
    fri = [p.fri_proof.first_layer, *p.fri_proof.inner_layers]
    # FRI's layers decommit first, then the commitment trees
    assert len(counts) == len(fri) + len(p.decommitments) == len(fri) + 3
    for c, layer in zip(counts, fri):
        assert c["decommit_hashes"] == len(layer.decommitment.hash_witness)
        assert layer.decommitment.column_witness == []
        assert c["decommit_values"] > 0 and c["decommit_values"] % 4 == 0
    for c, dec, values in zip(counts[len(fri):], p.decommitments,
                              p.queried_values):
        assert c["decommit_hashes"] == len(dec.hash_witness)
        assert c["decommit_values"] == len(values) + len(dec.column_witness)
    totals = tracing.counts()[5]
    for name in ("decommit_hashes", "decommit_values"):
        assert totals[name] == sum(c[name] for c in counts)
