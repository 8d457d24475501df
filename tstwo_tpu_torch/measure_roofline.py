"""Roofline probes of one CUDA device: int32 add rate, streaming bandwidth,
M31 and QM31 multiply rates.

    python -m tstwo_tpu_torch.measure_roofline

The counterpart of the JAX package's scripts/measure_roofline.py, items
1-4 (the CFFT is timed against its plain version by chip_smoke.py).
Every time is the device time of one call, taken over a run of many calls
between two CUDA events after a warm call (`time_call`), on inputs
resident in device memory:

  1. int32 add chain: 64 dependent `x = x + b` over N values.  PyTorch
     runs each add as its own launch, so this reads the rate of an eager
     chain (bound by memory traffic), not the ALU peak.
  2. stream: `a + 1` over N int32, one read and one write, as GB/s.
  3. M31 multiply at N = 2^24: the plain version (`ops/m31.mul`) and the
     `m31_mul` kernel, one product per element; then 8 dependent products
     per element, plain (8 passes) against the `m31_mul_chain` kernel (one
     pass), with the two results compared exactly.
  4. QM31 multiply, plain: 4 dependent products over [4, 2^22].

It needs a CUDA device and raises without one; nothing falls back to the
CPU.  `measure()` returns the figures as a dict.
"""
from __future__ import annotations

import json
import statistics
import time
from functools import lru_cache

import numpy as np
import torch

from .ops import m31_kernels, qm31
from .utils import to_torch_u32

P = (1 << 31) - 1
LOG_N = 24
ADD_REPS = 64
MUL_REPS = 8
QM31_LOG_N = 22
QM31_REPS = 4


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


def measure(device=None, seed: int = 0) -> dict:
    """Run the four probes on `device` (default cuda:0); a dict of rates
    and times."""
    if not torch.cuda.is_available():
        raise RuntimeError("the roofline probes need a CUDA device")
    device = torch.device(device or "cuda")
    if device.type != "cuda":
        raise ValueError(f"the roofline probes need a CUDA device, got {device}")
    rng = np.random.default_rng(seed)
    n = 1 << LOG_N

    def rand(shape):
        return to_torch_u32(rng.integers(0, P, size=shape, dtype=np.uint32),
                            device)

    a, b = rand(n), rand(n)
    out = {"device": torch.cuda.get_device_name(device), "n": n}

    def add_chain():
        x = a
        for _ in range(ADD_REPS):
            x = x + b
        return x

    ms = time_ms(add_chain)
    out["int32_add_chain_ms"] = ms
    out["int32_add_chain_ops_per_s"] = ADD_REPS * n / (ms * 1e-3)

    ms = time_ms(lambda: a + 1)
    out["stream_ms"] = ms
    out["stream_gb_per_s"] = 8.0 * n / (ms * 1e-3) / 1e9

    for name, fn in [("m31_mul_plain", lambda: m31_kernels.mul_plain(a, b)),
                     ("m31_mul_kernel", lambda: m31_kernels.mul(a, b))]:
        ms = time_ms(fn)
        out[f"{name}_ms"] = ms
        out[f"{name}_per_s"] = n / (ms * 1e-3)
    for name, fn in [
            ("m31_mul_chain_plain",
             lambda: m31_kernels.mul_chain_plain(a, b, MUL_REPS)),
            ("m31_mul_chain_kernel",
             lambda: m31_kernels.mul_chain(a, b, MUL_REPS))]:
        ms = time_ms(fn)
        out[f"{name}_ms"] = ms
        out[f"{name}_per_s"] = MUL_REPS * n / (ms * 1e-3)
    got = m31_kernels.mul_chain(a, b, MUL_REPS)
    want = m31_kernels.mul_chain_plain(a, b, MUL_REPS)
    out["m31_mul_chain_parity"] = bool(torch.equal(got, want))

    q, r = rand((4, 1 << QM31_LOG_N)), rand((4, 1 << QM31_LOG_N))

    def qchain():
        x = q
        for _ in range(QM31_REPS):
            x = qm31.mul(x, r)
        return x

    ms = time_ms(qchain)
    out["qm31_mul_plain_ms"] = ms
    out["qm31_mul_plain_per_s"] = QM31_REPS * (1 << QM31_LOG_N) / (ms * 1e-3)
    return out


if __name__ == "__main__":
    print(json.dumps(measure(), indent=1))
