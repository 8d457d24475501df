"""Passes 3a and 3b of a traced run, under the program's span tree, and
what they say.

The span tree is `tracing.enable(sync=False)` of the port: spans that do
not synchronise, each a `record_function` range, with counters, each proof
under `tracing.request(i)`.  After the traced run's own passes (proofs
under torch.profiler with spans off, then under the synchronised spans),
the first reader of a metric of the tree calls `measure(ctx)`, which proves
more traces of the run (the proofs after those passes, seeds from the
run's `--seed`) and keeps the result on `ctx` for the other readers:

  3a  `span_proofs` proofs under the span tree, without the profiler: the
      records and counters of the host-side metrics (`outermost`,
      `host_ms`, `counted`);
  3b  `profiled_proofs` proofs under the span tree and torch.profiler:
      `analyse` gives each device interval to the innermost range open on
      the thread that drives the proofs when it was launched (the runtime
      call its `correlation` names), and each idle gap of the device to
      the innermost range open at its middle.  The window, the device
      intervals and the gaps are those of `device_trace.analyse`.

Against a program without the span tree (no `tracing.request`) nothing is
proved and every reader of it finds nothing.
"""
from __future__ import annotations

import argparse
import bisect
import contextlib
import gc
import sys
import time
import traceback
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

from .device_trace import DEVICE_CATS, PROOF_RANGE, _union, load_events

RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
RANGE_CAT = "user_annotation"
ROOT = "prove"
BENCH_PREFIX = "bench."
FETCH = "fetch"
NO_RANGE = "(no range)"


# -- pass 3a: the records -------------------------------------------------

def outermost(records: Sequence[dict], name: str,
              within: Optional[str] = None) -> List[int]:
    """Indices of the records called `name` that no record of that name
    encloses and, if `within` is given, that a record called `within`
    encloses; records of a request only (`request` not None)."""
    inside_name: List[bool] = []
    inside_within: List[bool] = []
    out = []
    for i, r in enumerate(records):
        p = r["parent"]
        under_name = p is not None and (
            inside_name[p] or records[p]["name"] == name)
        under_within = within is None or (p is not None and (
            inside_within[p] or records[p]["name"] == within))
        inside_name.append(under_name)
        inside_within.append(under_within)
        if (r["name"] == name and not under_name and under_within
                and r["request"] is not None):
            out.append(i)
    return out


def host_ms(records: Sequence[dict], indices: Sequence[int]) -> float:
    """The host milliseconds of the records at `indices`."""
    return 1e3 * sum(records[i]["t1"] - records[i]["t0"] for i in indices)


def counted(counts: Dict[object, Dict[str, int]], name: str) -> int:
    """Counter `name` summed over the requests (the proofs)."""
    return sum(c.get(name, 0) for key, c in counts.items() if key is not None)


# -- pass 3b: the profile --------------------------------------------------

def _stacks(ranges: List[tuple], times: Sequence[float]) -> List[tuple]:
    """For each time, the names of the ranges open then, outermost first.
    `ranges` (ts, end, name) of one thread, which nest."""
    order = sorted(range(len(times)), key=lambda k: times[k])
    ranges = sorted(ranges, key=lambda r: (r[0], -r[1]))
    out: List[tuple] = [()] * len(times)
    stack: List[tuple] = []
    nxt = 0
    for k in order:
        t = times[k]
        while nxt < len(ranges) and ranges[nxt][0] <= t:
            r = ranges[nxt]
            while stack and stack[-1][1] <= r[0]:
                stack.pop()
            stack.append(r)
            nxt += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out[k] = tuple(r[2] for r in stack)
    return out


def _inner(stack: tuple) -> str:
    return stack[-1] if stack else NO_RANGE


def _inside(intervals: List[Tuple[float, float]],
            gaps: List[Tuple[float, float]]) -> float:
    """The length of the gaps that lies inside the union of intervals."""
    total, j = 0.0, 0
    for s, e in _union(intervals):
        while j < len(gaps) and gaps[j][1] <= s:
            j += 1
        k = j
        while k < len(gaps) and gaps[k][0] < e:
            total += max(0.0, min(e, gaps[k][1]) - max(s, gaps[k][0]))
            k += 1
    return total


def _top(totals: Dict[str, float], n: int) -> List[list]:
    return [[name, t] for name, t in
            sorted(totals.items(), key=lambda kv: -kv[1])[:n]]


def analyse(events: List[dict], n_top: int = 12) -> dict:
    """Seconds, over the profiled proofs: `idle_by_span` (the n_top largest
    [name, seconds] of the gaps by the innermost range at their middle),
    `device_by_span` (the same of device intervals by the range open at
    their launch), `idle_inside` ({range name: idle seconds inside the
    union of its ranges}), `idle_in_prove` and `idle_in_prove_covered`
    (the idle time of gaps inside `bench.prove`, and of those whose
    innermost range is a program span below the root `prove`),
    `htod_bytes_by_proof` (the bytes of the host-to-device copies
    launched in each proof),
    `dtoh_copies` and `dtoh_outside_fetch` (its device-to-host copies, and
    those launched outside every `fetch` range).  Empty when the trace
    holds no proof range or no device event."""
    proofs = [e for e in events
              if e.get("cat") == RANGE_CAT and e["name"] == PROOF_RANGE]
    if not proofs:
        return {}
    w0 = min(e["ts"] for e in proofs)
    w1 = max(e["ts"] + e["dur"] for e in proofs)
    device = [e for e in events if e.get("cat") in DEVICE_CATS
              and e["ts"] < w1 and e["ts"] + e["dur"] > w0]
    if not device:
        return {}
    pid, tid = proofs[0]["pid"], proofs[0]["tid"]
    ranges = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
              if e.get("cat") == RANGE_CAT and e.get("pid") == pid
              and e.get("tid") == tid]
    launch_at = {e["args"]["correlation"]: e["ts"] for e in events
                 if e.get("cat") in RUNTIME_CATS
                 and "correlation" in e.get("args", {})}

    # device intervals by the range open at their launch
    launches = [launch_at.get(e.get("args", {}).get("correlation"))
                for e in device]
    known = [k for k, t in enumerate(launches) if t is not None]
    stacks = _stacks(ranges, [launches[k] for k in known])
    launch_stack = dict(zip(known, stacks))
    device_totals: Dict[str, float] = defaultdict(float)
    starts = sorted(e["ts"] for e in proofs)
    htod_by_proof = [0] * len(proofs)
    dtoh, dtoh_outside = 0, 0
    for k, e in enumerate(device):
        s, t = max(e["ts"], w0), min(e["ts"] + e["dur"], w1)
        stack = launch_stack.get(k)
        device_totals[_inner(stack) if stack is not None
                      else "(launch not traced)"] += (t - s) / 1e6
        if e["cat"] != "gpu_memcpy":
            continue
        if e["name"].startswith("Memcpy HtoD"):
            at = launches[k] if launches[k] is not None else e["ts"]
            htod_by_proof[max(0, bisect.bisect_right(starts, at) - 1)] += \
                int(e.get("args", {}).get("bytes", 0))
        elif e["name"].startswith("Memcpy DtoH"):
            dtoh += 1
            dtoh_outside += stack is None or FETCH not in stack

    # idle gaps by the range open at their middle
    busy = _union([(max(e["ts"], w0), min(e["ts"] + e["dur"], w1))
                   for e in device])
    gaps, at = [], w0
    for s, t in busy:
        if s > at:
            gaps.append((at, s))
        at = max(at, t)
    if at < w1:
        gaps.append((at, w1))
    idle_totals: Dict[str, float] = defaultdict(float)
    in_prove = covered = 0.0
    for (s, t), stack in zip(gaps, _stacks(ranges,
                                           [(s + t) / 2 for s, t in gaps])):
        seconds = (t - s) / 1e6
        idle_totals[_inner(stack)] += seconds
        if "bench.prove" in stack:
            in_prove += seconds
            inner = _inner(stack)
            covered += seconds * (ROOT in stack and inner != ROOT
                                  and not inner.startswith(BENCH_PREFIX))
    by_name: Dict[str, List[Tuple[float, float]]] = defaultdict(list)
    for s, t, name in ranges:
        if not name.startswith(BENCH_PREFIX):
            by_name[name].append((s, t))
    return {
        "idle_by_span": _top(idle_totals, n_top),
        "device_by_span": _top(device_totals, n_top),
        "idle_inside": {name: _inside(iv, gaps) / 1e6
                        for name, iv in by_name.items()},
        "idle_in_prove": in_prove,
        "idle_in_prove_covered": covered,
        "htod_bytes_by_proof": htod_by_proof,
        "dtoh_copies": dtoh,
        "dtoh_outside_fetch": dtoh_outside,
    }


# -- the passes ------------------------------------------------------------

def _run_seed() -> int:
    """The run's `--seed` from the command line that started it (0 when
    none was given, as in tests that call `run_cell` directly)."""
    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("--seed", type=int, default=0)
    return parser.parse_known_args(sys.argv[1:])[0].seed


def measure(ctx) -> dict:
    """Passes 3a and 3b, made once for the traced run whose reader context
    is `ctx` and kept on it: {"records", "counts", "n"} of 3a and
    {"profile", "n_profiled"} of 3b (`analyse`'s result); empty when the
    program has no span tree or a pass raised."""
    if not hasattr(ctx, "span_tree"):
        try:
            ctx.span_tree = _passes(ctx)
        except Exception:  # the metrics of the tree go missing, not the run
            traceback.print_exc()
            ctx.span_tree = {}
    return ctx.span_tree


def _passes(ctx) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from tstwo_tpu_torch import tracing

    from . import registry
    from .traffic import ClosedLoop

    if not hasattr(tracing, "request"):
        print("span tree: the program has none", file=sys.stderr)
        return {}
    device = torch.device("cuda", 0) if torch.cuda.is_available() \
        else torch.device("cpu")
    recipe = registry.recipe(registry.ROOT, ctx.config)
    loop = ClosedLoop(ctx.traffic, _run_seed())
    n_span = int(ctx.traffic["span_proofs"])
    n_prof = int(ctx.traffic["profiled_proofs"])
    first = n_prof + n_span  # the proofs after the traced run's own

    def proofs(indices, scope) -> List[float]:
        walls = []
        for i in indices:
            start = time.perf_counter()
            with scope(i):
                recipe.prove(ctx.config, ctx.log_n, loop.trace_seed(i),
                             device)
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
            walls.append(time.perf_counter() - start)
        return walls

    @contextlib.contextmanager
    def profiled(i):
        with record_function(PROOF_RANGE), tracing.request(i):
            yield

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    path = registry.ROOT / "build" / "stark_bench" / "profile_spans.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    gc.collect()
    gc.freeze()
    tracing.reset()
    tracing.enable(sync=False)
    try:
        walls = proofs(range(first, first + n_span), tracing.request)
        records, counts = tracing.records(), tracing.counts()
        tracing.reset()
        with profile(activities=activities) as prof:
            # a copy before the proofs: the profiler's first copy of a
            # run may go unrecorded
            torch.ones(1).to(device)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            proofs(range(first + n_span, first + n_span + n_prof), profiled)
        counts_b = tracing.counts()
        counted_b = [counts_b[i].get("upload_bytes", 0) for i in
                     range(first + n_span, first + n_span + n_prof)]
    finally:
        tracing.disable()
        tracing.reset()
        gc.unfreeze()
    prof.export_chrome_trace(str(path))
    del prof
    try:
        seen = analyse(load_events(path))
    finally:
        path.unlink()
    print(f"span tree 3a: {sum(walls) / len(walls)} s a proof, "
          f"{len(records)} spans over {n_span} proofs", file=sys.stderr)
    if seen:
        share = 100 * seen["idle_in_prove_covered"] / max(
            seen["idle_in_prove"], 1e-12)
        print(f"span tree 3b: idle inside bench.prove {seen['idle_in_prove']}"
              f" s, {seen['idle_in_prove_covered']} s of it under a span "
              f"below the root prove ({share} %); HtoD bytes: in the trace "
              f"{seen['htod_bytes_by_proof']}, counted {counted_b};"
              f" DtoH copies {seen['dtoh_copies']}, launched outside a fetch "
              f"span {seen['dtoh_outside_fetch']}", file=sys.stderr)
        print(f"span tree 3b: idle_gaps_by_span {seen['idle_by_span']}",
              file=sys.stderr)
        print(f"span tree 3b: device_by_span {seen['device_by_span']}",
              file=sys.stderr)
    return {"records": records, "counts": counts, "n": n_span,
            "profile": seen, "n_profiled": n_prof}
