"""Phase-scoped host timing for the prover pipeline.

`span(name)` is a no-op unless `enable()` was called; then it adds the
wall time of the block to `totals()[name]`.  CUDA work is asynchronous, so
an enabled span synchronises the CUDA device (once CUDA is in use) on
entry and exit: its time holds the device work the block launched, at the
cost of the host/device overlap the synchronisation removes.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict

_enabled = False
_totals: Dict[str, float] = defaultdict(float)


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def reset() -> None:
    _totals.clear()


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
        _totals[name] += time.perf_counter() - t0
