"""Phase-scoped host timing for the prover pipeline.

`span(name)` is a no-op unless `enable()` was called; then it adds the
wall time of the block to `totals()[name]` and appends one record
`{"name", "seconds", "t0"}` to `records()`; `report()` formats the
totals.  CUDA work is asynchronous, so an enabled span synchronises the
CUDA device (once CUDA is in use) on entry and exit: its time holds the
device work the block launched, at the cost of the host/device overlap
the synchronisation removes.  `enable(use_profiler=True)` also opens a
`torch.profiler.record_function(name)` range for each span, so that the
phases show in a torch.profiler trace (the counterpart of the JAX
package's `use_jax_profiler`).
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, List

_enabled = False
_records: List[dict] = []
_totals: Dict[str, float] = defaultdict(float)
_use_profiler = False


def enable(use_profiler: bool = False) -> None:
    global _enabled, _use_profiler
    _enabled = True
    _use_profiler = use_profiler


def disable() -> None:
    global _enabled
    _enabled = False


def reset() -> None:
    _records.clear()
    _totals.clear()


def records() -> List[dict]:
    return list(_records)


def totals() -> Dict[str, float]:
    return dict(_totals)


def _sync() -> None:
    import torch

    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def span(name: str):
    """Phase span; no-op unless tracing is enabled."""
    if not _enabled:
        yield
        return
    ctx = contextlib.nullcontext()
    if _use_profiler:
        import torch.profiler

        ctx = torch.profiler.record_function(name)
    _sync()
    t0 = time.perf_counter()
    try:
        with ctx:
            yield
    finally:
        _sync()
        dt = time.perf_counter() - t0
        _records.append({"name": name, "seconds": dt, "t0": t0})
        _totals[name] += dt


def report() -> str:
    lines = ["phase timings:"]
    for name, total in sorted(_totals.items(), key=lambda kv: -kv[1]):
        lines.append(f"  {name:<40s} {total * 1e3:10.2f} ms")
    return "\n".join(lines)
