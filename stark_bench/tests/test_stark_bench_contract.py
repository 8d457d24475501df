"""BENCHMARK.json against the benchmark's contract, and the harness's
lookups by name.  Run from the repository root:

    python -m pytest stark_bench/tests -n 4
"""
from __future__ import annotations

import ast
import json
import re
import subprocess
import sys

import pytest
import torch

from bench_fixtures import REPO, product_checkout, tiny_checkout
from stark_bench import control, registry, run
from stark_bench.compare import PARTS, parts_of

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_and_paths():
    assert set(BENCH) == TOP_KEYS
    assert 1 <= len(BENCH["paths"]) <= 16
    for path in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", path)
        assert not path.startswith("/") and ".." not in path.split("/")
        assert not path.endswith("_torch")
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(_line(w) for w in BENCH["command"])
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_lines_use_allowed_characters():
    names = []
    for cfg in BENCH["configs"]:
        assert set(cfg) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(cfg["name"]) and _line(cfg["source"])
        assert _line(cfg["why"]) and len(cfg["reduced"]) <= 16
        assert all(NAME.match(k) for k in cfg["reduced"])
        assert cfg["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))
        names.append(("config", cfg["name"]))
    for cell in BENCH["workloads"]:
        assert set(cell) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(cell["name"]) and NAME.match(cell["traffic"])
        assert cell["chips"] in (1, 4) and _line(cell["why"])
        names.append(("cell", cell["name"]))
    for section in ("end_to_end", "per_layer"):
        for m in BENCH[section]:
            allowed = ({"name", "unit", "better", "bound", "source"}
                       if section == "end_to_end" else
                       {"name", "unit", "better", "source", "layer", "moves"})
            assert set(m) - {"workloads"} == allowed, m["name"]
            assert NAME.match(m["name"]) and UNIT.match(m["unit"])
            assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
            if section == "end_to_end":
                assert m["source"] in ("host_clock", "device_trace")
                assert 0.01 <= m["bound"] <= 0.25
            else:
                assert _line(m["layer"])
                assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
            names.append(("metric", m["name"]))
    assert len(names) == len(set(names))


def test_every_cell_reports_setup_another_end_to_end_and_a_layer_metric():
    for cell in BENCH["workloads"]:
        e2e = {m["name"] for m in registry.metrics_of(BENCH, "end_to_end",
                                                      cell["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert registry.metrics_of(BENCH, "per_layer", cell["name"])
    assert {c["config"] for c in BENCH["workloads"]} == {
        c["name"] for c in BENCH["configs"]}


@pytest.mark.parametrize("cell", [c["name"] for c in BENCH["workloads"]])
def test_cell_resolves_its_files_by_name(cell):
    entry = registry.workload(BENCH, cell)
    cfg = registry.config(REPO, BENCH, entry["config"])
    mix = registry.traffic(REPO, entry["traffic"])
    assert mix["log_n_rows"] >= 1 and cfg["name"] == entry["config"]
    recipe = registry.recipe(REPO, cfg)
    assert callable(recipe.prove) and callable(recipe.proof_fields)
    reference = registry.reference(REPO, cfg)
    assert callable(reference.prove) and callable(reference.trace_inputs)
    assert parts_of(cfg)  # raises where the parts compare nothing
    for m in registry.metrics_of(BENCH, "per_layer", cell):
        assert callable(registry.metric_reader(REPO, m["name"]))


@pytest.mark.parametrize("kind", ["stark", "not_stark"])
def test_a_new_configuration_traffic_and_metric_need_only_new_files(
        tmp_path, kind):
    """A throwaway configuration, traffic mix and per-layer metric, added
    as new files and entries in a copy, are run with no edit: a STARK
    configuration, and a lookup argument's (bench_fixtures.product_checkout)
    whose proof is compared over its own `proof_parts` and whose reference
    brings its own control."""
    if kind == "stark":
        root = tiny_checkout(tmp_path, name="throwaway")
    else:
        root = product_checkout(tmp_path, name="throwaway")
    (root / "stark_bench" / "metrics" / "throwaway.rows.py").write_text(
        "def read(ctx):\n    return float(1 << ctx.log_n)\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({
        "name": "throwaway.rows", "unit": "count", "better": "higher",
        "source": "program_counter", "layer": "a test", "moves": "prove_s",
        "workloads": ["throwaway.cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    result = run.run_cell(root, registry.load(root), "throwaway.cell", 7,
                          0.5, True, torch.device("cpu"), t0=0.0)
    assert result["correct"] is True
    assert result["metrics"]["throwaway.rows"]["value"] == 16.0
    parts = (list(PARTS) if kind == "stark" else
             ["sumcheck", "layer_masks", "output_claims"])
    assert list(result["checks"]) == parts + ["failed_proofs",
                                              "proofs_compared"]
    assert all(result["checks"][p]["value"] == 0 for p in parts)
    assert result["checks"]["proofs_compared"]["value"] == 2
    assert ("pcs.decommit_ms" in result["metrics"]) == (kind == "stark")
    made = control.readings(root, registry.load(root), "throwaway.cell",
                            2 ** 33 + 5, torch.device("cpu"))
    assert made["control"] == ("n_queries - 1" if kind == "stark"
                               else "first value changed")
    assert list(made["readings"]) == parts
    assert any(n > 0 for n in made["readings"].values())


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    fake = type(sys)("fake")
    for name in ("tstwo_tpu_torch_extra", "tstwo_tpu_torch.fri", "jax_like"):
        monkeypatch.setitem(sys.modules, name, fake)
    assert run.forbidden_modules() == []
    for name in ("tstwo_tpu.ops", "jaxlib"):
        monkeypatch.setitem(sys.modules, name, fake)
    assert run.forbidden_modules() == ["jaxlib", "tstwo_tpu"]


def _imports(path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", sorted(
    (REPO / "stark_bench" / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert not _imports(path) & {"tstwo_tpu_torch", "tstwo_tpu", "jax",
                                 "jaxlib", "flax"}


def test_reference_and_a_run_load_no_program_or_jax_module():
    """In a fresh process: the reference alone loads no module of the
    program; a whole run of a tiny cell loads no JAX module."""
    code = (
        "import sys; sys.path.insert(0, 'stark_bench/tests')\n"
        "import stark_bench.reference.wide_fibonacci\n"
        "top = {m.split('.')[0] for m in sys.modules}\n"
        "assert not top & {'tstwo_tpu_torch', 'tstwo_tpu', 'jax'}, top\n"
        "import pathlib, tempfile, torch\n"
        "from bench_fixtures import tiny_checkout\n"
        "from stark_bench import registry, run\n"
        "root = tiny_checkout(pathlib.Path(tempfile.mkdtemp()))\n"
        "res = run.run_cell(root, registry.load(root), 'tiny.cell', 1, 0.2,"
        " False, torch.device('cpu'), t0=0.0)\n"
        "assert res['correct'] and run.forbidden_modules() == [], res\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), \
        out.stderr[-3000:]


def test_a_run_without_cuda_exits_without_a_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", BENCH["workloads"][0]["name"], "--seed",
                   "5", "--seconds", "1", "--trace", "0"])
    assert rc != 0 and capsys.readouterr().out == ""
