"""What a torch.profiler trace of some proofs says about the device.

Device-side events only (a launching host operator also reports the time
of the kernels it launched), read from the timeline rather than from the
profiler's sums, and frozen here: the profiled window runs from the
start of the first `bench.proof` range to the end of the last; the device
is busy while a kernel, a copy or a memset runs on it (the union of their
intervals); an idle gap is a stretch of the window in which none runs, and
is labelled by what the host thread that drives the proofs was inside at
its middle: the innermost of the benchmark's `bench.*` ranges, and the
innermost profiler range or operator there.  Launches are the kernel
events in the window, every kernel, hand-written or PyTorch's.
"""
from __future__ import annotations

import bisect
import json
import re
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
PROOF_RANGE = "bench.proof"
BENCH_PREFIX = "bench."


def load_events(path: Path) -> List[dict]:
    with open(path) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return [e for e in events if e.get("ph") == "X" and "dur" in e]


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def short_name(name: str) -> str:
    """A kernel's name without its template arguments and signature, with
    the functors that say what an at::native kernel computes."""
    if len(name) <= 80:
        return name
    base = name.split("<", 1)[0].replace("void ", "")
    what = dict.fromkeys(re.findall(
        r"(\w*Functor\w*|\w+_kernel_cuda|\w+_kernel_impl\w*)", name))
    return f"{base}[{', '.join(what)}]" if what else base


def _top(totals: Dict[str, float], n: int) -> List[list]:
    return [[name, t] for name, t in
            sorted(totals.items(), key=lambda kv: -kv[1])[:n]]


def analyse(events: List[dict], n_top: int = 10) -> dict:
    """window_s, busy_s, launches, kernels [(name, seconds)], device_ops and
    idle_gaps (the n_top largest, [name, seconds]); times in seconds.
    Empty when the trace holds no proof range or no device event."""
    proofs = [e for e in events
              if e.get("cat") == "user_annotation" and e["name"] == PROOF_RANGE]
    if not proofs:
        return {}
    w0 = min(e["ts"] for e in proofs)
    w1 = max(e["ts"] + e["dur"] for e in proofs)
    device = [(max(e["ts"], w0), min(e["ts"] + e["dur"], w1), e)
              for e in events if e.get("cat") in DEVICE_CATS
              and e["ts"] < w1 and e["ts"] + e["dur"] > w0]
    if not device:
        return {}
    busy = _union([(s, t) for s, t, _ in device])
    op_totals: Dict[str, float] = defaultdict(float)
    kernels = []
    for s, t, e in device:
        op_totals[short_name(e["name"])] += (t - s) / 1e6
        if e["cat"] == "kernel":
            kernels.append((e["name"], e["dur"] / 1e6))

    gaps, at = [], w0
    for s, t in busy:
        if s > at:
            gaps.append((at, s))
        at = max(at, t)
    if at < w1:
        gaps.append((at, w1))
    pid, tid = proofs[0]["pid"], proofs[0]["tid"]
    host = sorted(((e["ts"], -e["dur"], e["ts"] + e["dur"], e["name"])
                   for e in events if e.get("cat") in HOST_CATS
                   and e.get("pid") == pid and e.get("tid") == tid))
    starts = [h[0] for h in host]
    gap_totals: Dict[str, float] = defaultdict(float)
    stack: List[tuple] = []
    nxt = 0
    for s, t in gaps:  # in time order; host ranges of one thread nest
        mid = (s + t) / 2
        stop = bisect.bisect_right(starts, mid)
        while nxt < stop:
            ev = host[nxt]
            while stack and stack[-1][2] <= ev[0]:
                stack.pop()
            stack.append(ev)
            nxt += 1
        while stack and stack[-1][2] < mid:
            stack.pop()
        inner = stack[-1][3] if stack else "(no host range)"
        bench = next((h[3] for h in reversed(stack)
                      if h[3].startswith(BENCH_PREFIX)), "(outside a proof)")
        label = bench if inner == bench else f"{bench} > {inner}"
        gap_totals[label] += (t - s) / 1e6
    return {
        "window_s": (w1 - w0) / 1e6,
        "busy_s": sum(t - s for s, t in busy) / 1e6,
        "launches": len(kernels),
        "kernels": kernels,
        "device_ops": _top(op_totals, n_top),
        "idle_gaps": _top(gap_totals, n_top),
    }
