"""Kernel timing on one CUDA device: `time_call` (device time over many
calls behind a spin kernel, warm and after an L2 flush, and the host's
time a call) and `time_ms`.  chip_smoke.py's kernel table and
measure_poseidon.py time with them; they need a CUDA device.
"""
from __future__ import annotations

import statistics
import time
from functools import lru_cache

import torch

WINDOW_MS = 2.0    # least device time between the two events of a timing
MAX_CALLS = 1000   # stays inside CUDA's queue of pending launches
FLUSH_BYTES = 64 << 20  # written between cold calls; the H100's L2 is 50 MB


@lru_cache(maxsize=None)
def _spin_cycles_per_ms(device_index: int) -> float:
    """Cycles of `torch.cuda._sleep` per millisecond on this device."""
    cycles = 20_000_000
    torch.cuda._sleep(cycles)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    end.synchronize()
    return cycles / start.elapsed_time(end)


def _hold_device(ms: float) -> None:
    """Keep the device busy for about `ms`, so that the host can enqueue
    what follows before the device reaches it."""
    per_ms = _spin_cycles_per_ms(torch.cuda.current_device())
    torch.cuda._sleep(int(min(ms, 400.0) * per_ms))


def time_call(fn, cold: bool = True) -> dict:
    """Device and host time of one call of fn(), after a warm call.

    `ms`: many calls between two CUDA events (a window of at least
    WINDOW_MS), over the count.  The calls are enqueued behind a spin
    kernel that holds the device while the host runs ahead, so the window
    holds device time even where one call's host work (allocation, ctypes,
    launch) outlasts its kernel.  Inputs and outputs of the last call are
    in L2 where they fit: the warm case.
    `host_us`: host clock around that loop over the count, no synchronise:
    what one call costs the enqueueing thread.
    `cold_ms` (if `cold`): median of events around single calls, each after
    FLUSH_BYTES were written to evict L2, also behind a spin kernel.
    `calls`: the count of the `ms` window."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    calls = 1
    while True:
        _hold_device(1.5 * host_ms * calls + 0.2)
        start.record()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3 / calls
        end.record()
        end.synchronize()
        window = start.elapsed_time(end)
        if window >= WINDOW_MS or calls >= MAX_CALLS:
            break
        per_call = max(window / calls, 1e-3)
        calls = min(MAX_CALLS, max(2 * calls,
                                   int(1.25 * WINDOW_MS / per_call) + 1))
    out = {"ms": window / calls, "host_us": host_ms * 1e3, "calls": calls}
    if cold:
        flush = torch.empty(FLUSH_BYTES, dtype=torch.int8, device="cuda")
        reps = 9
        events = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
        _hold_device(1.5 * reps * (host_ms + 0.05) + 0.2)
        for first, last in events:
            flush.zero_()
            first.record()
            fn()
            last.record()
        torch.cuda.synchronize()
        out["cold_ms"] = statistics.median(
            first.elapsed_time(last) for first, last in events)
    return out


def time_ms(fn) -> float:
    """Device time of fn() in ms, warm: see `time_call`."""
    return time_call(fn, cold=False)["ms"]
