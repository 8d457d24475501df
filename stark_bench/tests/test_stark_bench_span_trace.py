"""stark_bench/span_trace.py: the attribution of a profile's device time
and idle gaps to the program's ranges, the host-side sums of the span
tree, and the traced run's metrics of the tree on the CPU, with and
without the span tree in the program.  Run from the repository root:

    python -m pytest stark_bench/tests -n 4
"""
from __future__ import annotations

import json

import pytest
import torch

from bench_fixtures import tiny_checkout
from stark_bench import registry, run, span_trace
from stark_bench.device_trace import load_events

TREE_METRICS = ("pcs.decommit_host_ms", "utils.fetch_wait_ms",
                "utils.upload_mib")


def _range(name, ts, dur, tid=1):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts,
            "dur": dur, "pid": 1, "tid": tid}


def _launch(corr, ts):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
            "ts": ts, "dur": 1, "pid": 1, "tid": 1,
            "args": {"correlation": corr}}


def _device(cat, name, corr, ts, dur, nbytes=None):
    args = {"correlation": corr}
    if nbytes is not None:
        args["bytes"] = nbytes
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 0, "tid": 7, "args": args}


@pytest.fixture
def trace(tmp_path):
    """One proof, 100 us: the composition at 10-30 us, a fetch at 40-60 us;
    a kernel launched in the composition runs at 14-18, one launched in
    the fetch runs after it at 62-72 (as a read's copy waits for the
    stream), the fetch's DtoH copy at 75-77, an upload launched under the
    root span at 33-34; a range of another thread and a CPU operator that
    must be ignored."""
    events = [
        _range("bench.proof", 0, 100), _range("bench.prove", 5, 95),
        _range("prove", 6, 94), _range("composition", 10, 20),
        _range("fetch", 40, 20), _range("composition", 0, 100, tid=2),
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 11,
         "dur": 2, "pid": 1, "tid": 1},
        _launch(1, 12), _launch(2, 45), _launch(3, 50), _launch(4, 32),
        _device("kernel", "k_comp", 1, 14, 4),
        _device("kernel", "k_fetch", 2, 62, 10),
        _device("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 3, 75, 2,
                64),
        _device("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 4, 33, 1,
                4096),
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return load_events(path)


def test_a_kernel_goes_to_the_range_open_at_its_launch(trace):
    seen = span_trace.analyse(trace)
    device = {name: round(s * 1e6, 6) for name, s in seen["device_by_span"]}
    # launched inside fetch, run after it ended: still the fetch's
    assert device == {"fetch": 12.0, "composition": 4.0, "prove": 1.0}
    assert seen["htod_bytes_by_proof"] == [4096]
    assert (seen["dtoh_copies"], seen["dtoh_outside_fetch"]) == (1, 0)


def test_a_gap_goes_to_the_range_open_at_its_middle(trace):
    seen = span_trace.analyse(trace)
    idle = {name: round(s * 1e6, 6) for name, s in seen["idle_by_span"]}
    # gaps 0-14 (mid 7: prove), 18-33 (composition), 34-62 (fetch),
    # 72-75 and 77-100 (prove)
    assert idle == {"prove": 40.0, "fetch": 28.0, "composition": 15.0}
    inside = {k: round(v * 1e6, 6) for k, v in seen["idle_inside"].items()}
    # the root opens at 6 us: the first gap is inside it from there
    assert inside == {"prove": 77.0, "composition": 16.0, "fetch": 20.0}
    assert round(seen["idle_in_prove"] * 1e6, 6) == 83.0
    assert round(seen["idle_in_prove_covered"] * 1e6, 6) == 43.0


def test_a_copy_launched_outside_a_fetch_is_counted(trace):
    moved = [dict(e, ts=35) if e.get("args", {}).get("correlation") == 3
             and e["cat"] == "cuda_runtime" else e for e in trace]
    assert span_trace.analyse(moved)["dtoh_outside_fetch"] == 1


def test_no_proof_range_or_no_device_event_gives_nothing(trace):
    assert span_trace.analyse([e for e in trace
                               if e["name"] != "bench.proof"]) == {}
    assert span_trace.analyse([e for e in trace if e["pid"] == 1]) == {}


def test_outermost_spans_and_their_host_time():
    def rec(name, parent, t0, t1, request=0):
        return {"name": name, "parent": parent, "t0": t0, "t1": t1,
                "request": request}

    records = [rec("prove", None, 0.0, 1.0), rec("decommitment", 0, 0.5, 0.9),
               rec("fetch", 1, 0.6, 0.7), rec("fetch", 2, 0.62, 0.68),
               rec("fetch", 0, 0.2, 0.3), rec("fetch", None, 2.0, 2.5, None)]
    assert span_trace.outermost(records, "fetch") == [2, 4]
    assert span_trace.outermost(records, "fetch", within="decommitment") \
        == [2]
    assert span_trace.host_ms(records, [2, 4]) == pytest.approx(200.0)
    assert span_trace.counted({None: {"x": 5}, 0: {"x": 2}, 1: {"x": 3}},
                              "x") == 5


def _traced_run(tmp_path):
    root = tiny_checkout(tmp_path)
    return run.run_cell(root, registry.load(root), "tiny.cell", 2 ** 33 + 5,
                        0.2, True, torch.device("cpu"), t0=0.0)


def test_a_cpu_traced_run_reports_the_tree_metrics_a_cpu_can_give(
        tmp_path):
    result = _traced_run(tmp_path)
    assert result["correct"] is True
    metrics = result["metrics"]
    for name in TREE_METRICS:
        assert metrics[name]["value"] >= 0, name
    assert metrics["utils.upload_mib"]["value"] == 0.0
    assert metrics["pcs.decommit_host_ms"]["value"] > 0
    # no device events on the CPU: nothing idles
    assert "constraint_framework.composition_idle_ms" not in metrics
    assert "pcs.decommit_ms" in metrics


def test_without_the_span_tree_its_metrics_go_missing_and_the_run_holds(
        tmp_path, monkeypatch):
    from tstwo_tpu_torch import tracing

    monkeypatch.delattr(tracing, "request")
    result = _traced_run(tmp_path)
    assert result["correct"] is True
    assert not set(TREE_METRICS) & set(result["metrics"])
    assert "pcs.decommit_ms" in result["metrics"]
