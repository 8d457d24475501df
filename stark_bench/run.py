"""Run one cell of the benchmark once and print its result.

    python3 -m stark_bench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up imports the port, builds its kernels (the first run in a checkout
compiles them into build/ there), proves `warm_proofs` proofs at the
cell's size and freezes its objects out of the garbage collector's scans.  The window then proves fresh traces back to back, one prover
in a closed loop, for `--seconds`: a proof ends when its StarkProof is on
the host after torch.cuda.synchronize().  With `--trace 1` the window is a
few proofs under torch.profiler and a few under the program's synchronised
spans, and the metrics are the cell's per-layer metrics.  After the window
the reference proves a sample of the window's traces again and every field
of those proofs is compared, one number for each part of the proof that the
configuration names (stark_bench/compare.py); the numbers compared, each
beside its limit, then the failed proofs and the proofs compared,
are the last lines on standard error and the last key of the result, the
last line on standard output.  Exits with 2 without enough CUDA devices
and with 3 if a JAX module was loaded; neither prints a result.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()  # set-up counts from the start of the process

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "tstwo_tpu")
GIB = float(1 << 30)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is a JAX package's, whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _card_state() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,clocks.sm,power.limit,"
             "power.draw", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=False)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi: {exc}"


class Cell:
    """One cell's configuration, traffic, recipe and reference."""

    def __init__(self, root: Path, bench: dict, name: str, seed: int):
        from . import registry
        from .compare import parts_of
        from .traffic import ClosedLoop

        self.root = root
        entry = registry.workload(bench, name)
        self.config = registry.config(root, bench, entry["config"])
        self.traffic = registry.traffic(root, entry["traffic"])
        self.loop = ClosedLoop(self.traffic, seed)
        self.recipe = registry.recipe(root, self.config)
        self.reference = registry.reference(root, self.config)
        self.parts = parts_of(self.config)
        self.log_n = self.loop.log_n_rows

    def prove(self, trace_seed: int, device):
        proof = self.recipe.prove(self.config, self.log_n, trace_seed, device)
        _sync(device)
        return proof


def _timed_proofs(cell: Cell, device, deadline=None, count=None,
                  first_index: int = 0, wrap=None):
    """Prove back to back from proof `first_index` until `deadline` (the
    proof that crosses it completes) or for `count` proofs; every proof is
    offered to the check's sample.  Returns (latencies, failed, end)."""
    latencies, failed, i = [], 0, first_index
    end = time.perf_counter()
    while True:
        start = time.perf_counter()
        try:
            with (wrap() if wrap else contextlib.nullcontext()):
                proof = cell.prove(cell.loop.trace_seed(i), device)
            cell.loop.offer(i, proof)
        except Exception:  # a proof that raises is a failed attempt
            traceback.print_exc()
            failed += 1
        end = time.perf_counter()
        latencies.append(end - start)
        i += 1
        if (count is not None and i - first_index >= count) or (
                deadline is not None and end >= deadline):
            return latencies, failed, end


def _check(cell: Cell, device) -> tuple:
    """Prove the sampled traces again with the reference; the counts of
    differing fields of each of the cell's parts, and how many proofs were
    compared."""
    from .compare import compare

    totals = dict.fromkeys(cell.parts, 0)
    sample = [(i, cell.recipe.proof_fields(p)) for i, p in cell.loop.sample()]
    gc.collect()
    if device.type == "cuda":
        import torch

        torch.cuda.empty_cache()
    for index, fields in sample:
        inputs = cell.reference.trace_inputs(cell.loop.trace_seed(index),
                                             cell.log_n)
        ref = cell.reference.prove(inputs, cell.config, cell.log_n, device)
        for part, n in compare(fields, ref, cell.parts).items():
            totals[part] += n
    return totals, len(sample)


def run_cell(root: Path, bench: dict, name: str, seed: int, seconds: float,
             trace: bool, device, t0: float = None) -> dict:
    """One run of a cell on `device`; the result as a dict."""
    import torch

    from . import registry

    t0 = T0 if t0 is None else t0
    cell = Cell(root, bench, name, seed)
    for i in range(int(cell.traffic["warm_proofs"])):
        cell.prove(cell.loop.warm_seed(i), device)
    # the objects of set-up (imports, the warm proofs' caches) leave the
    # collector's scans: a full collection of the window then scans the
    # proofs' own objects, not a heap whose size set-up decided
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    extra_device, breakdown, layer = {}, None, {}
    try:
        if not trace:
            w0 = time.perf_counter()
            latencies, failed, w1 = _timed_proofs(cell, device,
                                                  deadline=w0 + seconds)
            window_s = w1 - w0
        else:
            latencies, failed, layer, extra_device, breakdown = _traced(
                cell, device)
    finally:
        gc.unfreeze()
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    found = forbidden_modules()
    if found:
        return {"forbidden": found}

    attempted = len(latencies)
    completed = attempted - failed
    metrics = {}
    if not trace:
        values = {
            "setup_s": setup_s,
            "prove_s": window_s / completed if completed else None,
            "prove_p90_s": (statistics.quantiles(latencies, n=10,
                                                 method="inclusive")[-1]
                            if len(latencies) >= 2 else None),
            "peak_mem_gib": peak / GIB,
        }
        for m in registry.metrics_of(bench, "end_to_end", name):
            if values.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    else:
        ctx = SimpleNamespace(config=cell.config, traffic=cell.traffic,
                              log_n=cell.log_n, reference=cell.reference,
                              **layer)
        for m in registry.metrics_of(bench, "per_layer", name):
            value = registry.metric_reader(root, m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    diffs, compared = _check(cell, device)
    from .compare import LIMIT

    checks = {part: {"value": n, "limit": LIMIT} for part, n in diffs.items()}
    checks["failed_proofs"] = {"value": failed, "limit": 0}
    checks["proofs_compared"] = {"value": compared, "limit": "at least 1"}
    correct = (compared >= 1 and failed == 0
               and all(n <= LIMIT for n in diffs.values()))
    if device.type == "cuda":
        kind, count = torch.cuda.get_device_name(device), 1
    else:
        kind, count = "cpu", 1
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if device.type == "cuda"
                         else "cpu", "kind": kind, "count": count,
                         "memory_peak_bytes": peak, **extra_device}}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def _traced(cell: Cell, device):
    """Profiled proofs (spans off), then proofs under the program's spans.
    Returns (latencies, failed, reader context, device keys, breakdown)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from tstwo_tpu_torch import tracing

    from .device_trace import PROOF_RANGE, analyse, load_events

    print(f"card before: {_card_state()}", file=sys.stderr)
    n_prof = int(cell.traffic["profiled_proofs"])
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        lat, failed, _ = _timed_proofs(
            cell, device, count=n_prof,
            wrap=lambda: record_function(PROOF_RANGE))
    out_dir = cell.root / "build" / "stark_bench"
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / "profile.json"
    prof.export_chrome_trace(str(path))
    del prof
    try:
        seen = analyse(load_events(path))
    finally:
        path.unlink()
    print(f"card after profile: {_card_state()}", file=sys.stderr)

    n_span = int(cell.traffic["span_proofs"])
    tracing.reset()
    tracing.enable()
    try:
        lat2, failed2, _ = _timed_proofs(cell, device, count=n_span,
                                         first_index=n_prof)
    finally:
        tracing.disable()
    totals = tracing.totals()
    tracing.reset()
    span_ms = {k: 1e3 * v / n_span for k, v in totals.items()}

    layer = {"span_ms": span_ms, "n_profiled": n_prof,
             "kernels": seen.get("kernels", []),
             "launches": seen.get("launches"),
             "busy_s": seen.get("busy_s"), "window_s": seen.get("window_s")}
    extra, breakdown = {}, None
    if seen:
        extra = {"busy_s": seen["busy_s"], "window_s": seen["window_s"]}
        breakdown = {"device_ops": seen["device_ops"],
                     "idle_gaps": seen["idle_gaps"]}
    return lat + lat2, failed + failed2, layer, extra, breakdown


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    from . import registry

    root = registry.ROOT
    # caches of compilers the port may use stay at fixed paths in the
    # checkout (the port's own kernels build into build/tstwo_tpu_torch)
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build" /
                                             "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton_cache")
    # one process, one intra-op thread: the host's other cores stay free
    os.environ["OMP_NUM_THREADS"] = "1"
    os.environ["MKL_NUM_THREADS"] = "1"
    import torch

    torch.set_num_threads(1)

    bench = registry.load(root)
    chips = registry.workload(bench, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"stark_bench: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = run_cell(root, bench, args.workload, args.seed, args.seconds,
                      bool(args.trace), torch.device("cuda", 0))
    found = result.get("forbidden") or forbidden_modules()
    if found:
        print(f"stark_bench: JAX modules loaded: {found}", file=sys.stderr)
        return 3
    for part, check in result["checks"].items():
        print(f"check {part}: {check['value']} (limit {check['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
