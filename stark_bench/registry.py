"""Finds every part of a cell by the names in BENCHMARK.json.

  configuration  the `file` of its entry in `configs`; its `proof_parts`,
                 where it has them, name the numbers compared and the
                 proof's keys each covers (stark_bench/compare.py; a STARK
                 proof's five without them)
  AIR recipe     stark_bench/recipes/<config air.recipe>.py (the port's
                 API): `prove(config, log_n, trace_seed, device)` and
                 `proof_fields(proof)`, the proof as plain data
  reference      stark_bench/reference/<config air.name>.py:
                 `trace_inputs(trace_seed, log_n)`, `prove(inputs, config,
                 log_n, device)`, and optionally `control(inputs, config,
                 log_n, device)` -> (label, proof), the control of the
                 comparison (stark_bench/control.py; one query fewer
                 without it)
  traffic mix    stark_bench/traffic/<traffic>.json
  metric reader  stark_bench/metrics/<metric name>.py, its `read(ctx)`

A later cell, configuration, traffic mix or per-layer metric is new files
and new entries, whether or not its proof is a STARK proof: nothing here
names one.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Callable, List

ROOT = Path(__file__).resolve().parent.parent
PACKAGE = "stark_bench"


def load(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def workload(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(root: Path, bench: dict, name: str) -> dict:
    for entry in bench["configs"]:
        if entry["name"] == name:
            with open(root / entry["file"]) as f:
                return json.load(f)
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(root: Path, name: str) -> dict:
    with open(root / PACKAGE / "traffic" / f"{name}.json") as f:
        return json.load(f)


def _from_file(path: Path, name: str) -> ModuleType:
    if not path.is_file():
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def recipe(root: Path, cfg: dict) -> ModuleType:
    name = cfg["air"]["recipe"]
    return _from_file(root / PACKAGE / "recipes" / f"{name}.py",
                      f"{PACKAGE}_recipe_{name}")


def reference(root: Path, cfg: dict) -> ModuleType:
    """The configuration's reference module under `root`: the package's
    own where `root` is this checkout, else loaded from its file there
    (its relative imports resolve in the package's reference/)."""
    name = f"{PACKAGE}.reference.{cfg['air']['name']}"
    if Path(root).resolve() == ROOT:
        return importlib.import_module(name)
    return _from_file(root / PACKAGE / "reference" /
                      f"{cfg['air']['name']}.py", name)


def metric_reader(root: Path, name: str) -> Callable:
    module = _from_file(root / PACKAGE / "metrics" / f"{name}.py",
                        f"{PACKAGE}_metric_{name.replace('.', '_')}")
    return module.read


def metrics_of(bench: dict, section: str, cell: str) -> List[dict]:
    """The metrics of `section` that cell reports: those without a
    `workloads` key and those that list it."""
    return [m for m in bench[section]
            if "workloads" not in m or cell in m["workloads"]]
