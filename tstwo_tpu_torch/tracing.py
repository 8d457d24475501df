"""Phase-scoped timing of the prover pipeline: spans, counters, requests.

`span(name)` does nothing unless `enable()` was called: tracing off, it
returns one shared context object that opens nothing and records nothing.
Enabled, it adds the block's host wall time to `totals()[name]`, and
`report()` formats the totals.  There are two modes.

`enable()`: synchronised spans, the counterpart of the JAX package's.  A
span synchronises the CUDA device (once CUDA is in use) on entry and exit,
so its time holds the device work the block launched, at the cost of the
host/device overlap the synchronisation removes; it appends one record
`{"name", "seconds", "t0"}` when it closes.  `enable(use_profiler=True)`
also opens a `torch.profiler.record_function(name)` range for each span.

`enable(sync=False)`: the span tree.  A span never synchronises.  While a
profiler records (`torch.autograd._profiler_enabled()`) it opens a
`record_function(name)` range, which then lies on the clock of the kernels
and copies, and, inside a `request` on a process that uses CUDA, it
records a CUDA event on the current stream at entry and exit.
It appends its record when it opens: `name`; `t0`, `t1` (host
`time.perf_counter()`); `parent`, the index in `records()` of the
enclosing span's record, or None; `request`, the id of the enclosing
`request`, or None; `launches`, the hand-kernel launches
(`kernels.LAUNCHES`) made inside it; `counts`, what `count()` added while
it was the innermost open span; `device_t0`, `device_t1`, the events'
times on the host clock through the request's anchor (None without them),
computed when `records()` is read after the request has ended.
"""
from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict, List, Optional

_enabled = False
_sync = True
_use_profiler = False
_records: List[dict] = []
_totals: Dict[str, float] = defaultdict(float)
_open: List[tuple] = []  # (index, record) of the open spans, innermost last
_request: Optional["_Request"] = None
_ended: List["_Request"] = []  # ended requests whose device times wait
_counts: Dict[object, Dict[str, int]] = {}
_kernels = None
_torch = None


def enable(use_profiler: bool = False, sync: bool = True) -> None:
    global _enabled, _use_profiler, _sync, _kernels, _torch
    if not sync:
        import torch.profiler

        from . import kernels

        _kernels, _torch = kernels, torch
    _enabled = True
    _use_profiler = use_profiler
    _sync = sync


def disable() -> None:
    global _enabled
    _enabled = False


def reset() -> None:
    _records.clear()
    _totals.clear()
    _counts.clear()
    _ended.clear()


def records() -> List[dict]:
    _resolve_device_times()
    return list(_records)


def totals() -> Dict[str, float]:
    return dict(_totals)


def counts() -> Dict[object, Dict[str, int]]:
    """What `count()` added, by request id (None: outside any request)."""
    return {k: dict(v) for k, v in _counts.items()}


def _sync_device() -> None:
    import torch

    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


class _Off:
    """The span of disabled tracing: one shared object, entered freely."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def _range(name: str):
    import torch.profiler

    return torch.profiler.record_function(name)


class _SyncedSpan:
    __slots__ = ("name", "ctx", "t0")

    def __init__(self, name: str):
        self.name = name
        self.ctx = _range(name) if _use_profiler else None

    def __enter__(self):
        _sync_device()
        self.t0 = time.perf_counter()
        if self.ctx is not None:
            self.ctx.__enter__()

    def __exit__(self, *exc):
        if self.ctx is not None:
            self.ctx.__exit__(*exc)
        _sync_device()
        dt = time.perf_counter() - self.t0
        _records.append({"name": self.name, "seconds": dt, "t0": self.t0})
        _totals[self.name] += dt
        return False


def _event():
    ev = _torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


class _TreeSpan:
    __slots__ = ("name", "rec", "ctx", "request", "ev0", "launches0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        req = self.request = _request
        self.rec = rec = {"name": self.name, "t0": None, "t1": None,
                          "parent": _open[-1][0] if _open else None,
                          "request": req.id if req is not None else None,
                          "launches": 0, "counts": {},
                          "device_t0": None, "device_t1": None}
        _open.append((len(_records), rec))
        _records.append(rec)
        # a range costs microseconds even when nothing records it
        self.ctx = (_torch.profiler.record_function(self.name)
                    if _torch.autograd._profiler_enabled() else None)
        if self.ctx is not None:
            self.ctx.__enter__()
        self.ev0 = (_event() if req is not None and req.anchor is not None
                    else None)
        self.launches0 = sum(_kernels.LAUNCHES.values())
        rec["t0"] = time.perf_counter()

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        rec = self.rec
        rec["launches"] = sum(_kernels.LAUNCHES.values()) - self.launches0
        if self.ev0 is not None:
            self.request.pending.append((rec, self.ev0, _event()))
        if self.ctx is not None:
            self.ctx.__exit__(*exc)
        _open.pop()
        rec["t1"] = t1
        _totals[rec["name"]] += t1 - rec["t0"]
        return False


def span(name: str):
    """Phase span; a shared no-op unless tracing is enabled."""
    if not _enabled:
        return _OFF
    return _SyncedSpan(name) if _sync else _TreeSpan(name)


def counting() -> bool:
    """Whether `count()` counts: the span tree is on."""
    return _enabled and not _sync


def count(name: str, n: int) -> None:
    """Add `n` to counter `name` of the innermost open span and of the
    request; nothing unless the span tree (`enable(sync=False)`) is on."""
    if not _enabled or _sync:
        return
    if _open:
        own = _open[-1][1]["counts"]
        own[name] = own.get(name, 0) + n
    key = _request.id if _request is not None else None
    totals = _counts.setdefault(key, {})
    totals[name] = totals.get(name, 0) + n


class _Request:
    """One request (a proof) of the span tree: its id on every span and
    counter inside it, and the anchor that puts its CUDA events on the
    host clock: a synchronisation at entry (a closed loop's stream is idle
    there), then an event and the host time."""

    __slots__ = ("id", "outer", "anchor", "t", "pending")

    def __init__(self, id):
        self.id = id
        self.pending: List[tuple] = []

    def __enter__(self):
        global _request
        import torch

        self.anchor = None
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
            self.anchor = _event()
        self.t = time.perf_counter()
        _counts.setdefault(self.id, {})
        self.outer, _request = _request, self
        return self

    def __exit__(self, *exc):
        global _request
        _request = self.outer
        if self.pending:
            _ended.append(self)
        return False


def request(id):
    """Context of one request (a proof) with identifier `id`; a shared
    no-op unless the span tree (`enable(sync=False)`) is on."""
    if not _enabled or _sync:
        return _OFF
    return _Request(id)


def _resolve_device_times() -> None:
    if not _ended:
        return
    import torch

    torch.cuda.synchronize()
    for req in _ended:
        for rec, ev0, ev1 in req.pending:
            rec["device_t0"] = req.t + req.anchor.elapsed_time(ev0) / 1e3
            rec["device_t1"] = req.t + req.anchor.elapsed_time(ev1) / 1e3
        req.pending.clear()
    _ended.clear()


def report() -> str:
    lines = ["phase timings:"]
    for name, total in sorted(_totals.items(), key=lambda kv: -kv[1]):
        lines.append(f"  {name:<40s} {total * 1e3:10.2f} ms")
    return "\n".join(lines)
