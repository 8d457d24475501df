"""Helpers of the benchmark's tests: a checkout in a temporary directory
with a tiny cell added as new files, the way a later change adds one, and
a field that counts its operations."""
from __future__ import annotations

import json
import shutil
import textwrap
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
CONFIG = "stark_bench/configs/wide_fib100_blake2s.json"
# the parts of a GKR batch proof (GkrBatchProof's three fields)
GKR_PARTS = {"sumcheck": ["sumcheck_proofs"],
             "layer_masks": ["layer_masks_by_instance"],
             "output_claims": ["output_claims_by_instance"]}


class CountingField:
    """A field that counts: 9 an M31 product, 3 an addition."""

    ops = 0

    @classmethod
    def add(cls, a, b):
        cls.ops += 3
        return 0

    sub = add

    @classmethod
    def mul(cls, a, b):
        cls.ops += 9
        return 0


def _copy(tmp_path: Path) -> Path:
    root = tmp_path / "checkout"
    shutil.copytree(REPO / "stark_bench", root / "stark_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return root


def _add_cell(root: Path, bench: dict, name: str, cfg: dict, mix: dict,
              metrics) -> None:
    """Configuration, traffic mix and cell `name`, `name`, `name.cell` as
    new files and entries; the cell listed in `metrics`' workloads."""
    (root / "stark_bench" / "configs" / f"{name}.json").write_text(
        json.dumps(cfg))
    (root / "stark_bench" / "traffic" / f"{name}.json").write_text(
        json.dumps(mix))
    bench["configs"].append({"name": name, "source": "a test",
                             "file": f"stark_bench/configs/{name}.json",
                             "reduced": [], "why": "a test"})
    cell = f"{name}.cell"
    bench["workloads"].append({"name": cell, "config": name,
                               "traffic": name, "chips": 1, "why": "a test"})
    for metric in metrics:
        if "workloads" in metric:
            metric["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


def _mix(log_n: int) -> dict:
    return {"loop": "closed", "provers": 1, "log_n_rows": log_n,
            "warm_proofs": 1, "check_proofs": 2, "profiled_proofs": 2,
            "span_proofs": 2}


def tiny_checkout(tmp_path: Path, flavor: str = "blake2s", log_n: int = 4,
                  n_columns: int = 6, pow_bits: int = 4, n_queries: int = 5,
                  name: str = "tiny") -> Path:
    """A copy of BENCHMARK.json and stark_bench/ with a configuration
    `name`, a traffic mix `name` and a cell `name.cell` added as new
    files and entries; the cell reports every metric."""
    root = _copy(tmp_path)
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    cfg = json.loads((REPO / CONFIG).read_text())
    cfg.update(name=name, merkle_channel=flavor)
    cfg["air"]["n_columns"] = n_columns
    cfg["security"].update(pow_bits=pow_bits, n_queries=n_queries)
    _add_cell(root, bench, name, cfg, _mix(log_n),
              bench["end_to_end"] + bench["per_layer"])
    return root


# A stand-in lookup argument whose proof is not a STARK proof: a grand
# product of the trace's values by a tree of products, its proof shaped as
# a GKR batch proof's three parts.  The recipe is the system's side; the
# reference makes the same proof, and its control one from a changed input.
_PRODUCT_TREE = """
import numpy as np
import torch

P = (1 << 31) - 1


def _values(trace_seed, log_n):
    return np.random.default_rng(trace_seed).integers(1, P, size=1 << log_n)


def _proof(values, device):
    layers = [torch.as_tensor(values, dtype=torch.int64, device=device)]
    while layers[-1].numel() > 1:
        v = layers[-1]
        layers.append(v[0::2] * v[1::2] % P)
    return {{"sumcheck_proofs": [[int(v.sum() % P)] for v in layers],
            "layer_masks_by_instance": [[v[:2].tolist()
                                         for v in layers[:-1]]],
            "output_claims_by_instance": [[int(layers[-1][0])]]}}
{side}
"""
_RECIPE = """

def prove(config, log_n, trace_seed, device):
    return _proof(_values(trace_seed, log_n), device)


def proof_fields(proof):
    return proof
"""
_REFERENCE = """

def trace_inputs(trace_seed, log_n):
    return _values(trace_seed, log_n)


def prove(inputs, config, log_n, device):
    return _proof(inputs, device)


def control(inputs, config, log_n, device):
    changed = inputs.copy()
    changed[0] = changed[0] % (P - 1) + 1
    return "first value changed", _proof(changed, device)
"""


def product_checkout(tmp_path: Path, log_n: int = 4,
                     name: str = "products") -> Path:
    """A copy of BENCHMARK.json and stark_bench/ with the stand-in lookup
    argument added as new files and entries: its configuration (with its
    `proof_parts`), recipe, reference with its control, traffic mix and
    cell `name.cell`, which reports the end-to-end metrics."""
    root = _copy(tmp_path)
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    pkg = root / "stark_bench"
    for folder, side in (("recipes", _RECIPE), ("reference", _REFERENCE)):
        (pkg / folder / f"{name}.py").write_text(textwrap.dedent(
            _PRODUCT_TREE.format(side=side)))
    cfg = {"name": name, "air": {"name": name, "recipe": name},
           "proof_parts": GKR_PARTS}
    _add_cell(root, bench, name, cfg, _mix(log_n), bench["end_to_end"])
    return root
