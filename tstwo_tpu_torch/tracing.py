"""Phase-scoped host timing for the prover pipeline.

`span(name)` is a no-op unless `enable()` was called; then it adds the
wall time of the block to `totals()[name]` and appends one record
`{"name", "seconds", "t0"}` to `records()`; `report()` formats the
totals.  CUDA work is asynchronous, so an enabled span synchronises the
CUDA device (once CUDA is in use) on entry and exit: its time holds the
device work the block launched, at the cost of the host/device overlap
the synchronisation removes.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, List

_enabled = False
_records: List[dict] = []
_totals: Dict[str, float] = defaultdict(float)


def enable() -> None:
    global _enabled
    _enabled = True


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
    _sync()
    t0 = time.perf_counter()
    try:
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
