"""Helpers of the benchmark's tests: a checkout in a temporary directory
with a tiny cell added as new files, the way a later change adds one."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
CONFIG = "stark_bench/configs/wide_fib100_blake2s.json"


def tiny_checkout(tmp_path: Path, flavor: str = "blake2s", log_n: int = 4,
                  n_columns: int = 6, pow_bits: int = 4, n_queries: int = 5,
                  name: str = "tiny") -> Path:
    """A copy of BENCHMARK.json and stark_bench/ with a configuration
    `name`, a traffic mix `name` and a cell `name.cell` added as new
    files and entries; the cell reports every metric."""
    root = tmp_path / "checkout"
    shutil.copytree(REPO / "stark_bench", root / "stark_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    cfg = json.loads((REPO / CONFIG).read_text())
    cfg.update(name=name, merkle_channel=flavor)
    cfg["air"]["n_columns"] = n_columns
    cfg["security"].update(pow_bits=pow_bits, n_queries=n_queries)
    (root / "stark_bench" / "configs" / f"{name}.json").write_text(
        json.dumps(cfg))
    (root / "stark_bench" / "traffic" / f"{name}.json").write_text(
        json.dumps({"loop": "closed", "provers": 1, "log_n_rows": log_n,
                    "warm_proofs": 1, "check_proofs": 2,
                    "profiled_proofs": 2, "span_proofs": 2}))
    bench["configs"].append({"name": name, "source": "a test",
                             "file": f"stark_bench/configs/{name}.json",
                             "reduced": [], "why": "a test"})
    cell = f"{name}.cell"
    bench["workloads"].append({"name": cell, "config": name,
                               "traffic": name, "chips": 1, "why": "a test"})
    for metric in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in metric:
            metric["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root
