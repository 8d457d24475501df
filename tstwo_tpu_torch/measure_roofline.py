"""Roofline probes of one CUDA device: int32 add rate, streaming bandwidth,
M31 and QM31 multiply rates.

    python -m tstwo_tpu_torch.measure_roofline

The counterpart of the JAX package's scripts/measure_roofline.py, items
1-4 (the CFFT is timed against its plain version by chip_smoke.py).
Every time is a median of CUDA-event-timed calls after a warm call, on
inputs resident in device memory:

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


def time_ms(fn, reps: int = 5) -> float:
    """Median CUDA-event time of fn() in ms over `reps` calls after one
    warm call."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


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
