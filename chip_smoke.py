#!/usr/bin/env python3
"""Smoke run of tstwo_tpu_torch on one CUDA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from tstwo_tpu_torch/csrc, holds each against its
plain PyTorch version on the card at the main path's shapes, proves the
golden wide-Fibonacci instance and compares it with the committed JAX
proof, checks a mid-size CUDA proof against the CPU one, then proves and
verifies wide Fibonacci at 2^16 x 32 and 2^18 x 64.  Each phase prints
one line (name, seconds, result); any failure exits non-zero.  The
second-to-last line is the kernel table as JSON, the last line the result
JSON.  Imports nothing of JAX.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
FIXTURE = ROOT / "tests" / "data" / "torch_port_wide_fib_log8x8_seed0.json"
CSRC = "tstwo_tpu_torch/csrc/"
REPLACES = {
    "cfft_forward": "tstwo_tpu/ops/pallas/fft_kernels.py:545",
    "cfft_inverse": "tstwo_tpu/ops/pallas/fft_kernels.py:380",
    "cfft_block_resident": "tstwo_tpu/ops/pallas/fft_kernels.py:147",
    "blake2s": "tstwo_tpu/ops/blake2s.py:262",
    "deinterleave": "tstwo_tpu/ops/pallas/interleave.py:50",
}


def phase(name: str, seconds: float, result: str) -> None:
    print(f"phase {name}: {seconds:.3f} s: {result}", flush=True)


def fail(msg: str) -> None:
    print(f"FAILED: {msg}", flush=True)
    sys.exit(1)


def time_ms(fn, reps: int = 5) -> float:
    """Median CUDA-event time of fn() over `reps` runs after one warm run."""
    import torch

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


def max_abs_err(a, b) -> int:
    import torch

    if a.shape != b.shape:
        fail(f"shape mismatch {tuple(a.shape)} vs {tuple(b.shape)}")
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())


def compare_kernels(device):
    """Phase 3: every kernel against its plain version at the main path's
    shapes (exact: tolerance 0).  Returns the kernel-table rows."""
    import numpy as np
    import torch

    from tstwo_tpu_torch.circle import CanonicCoset
    from tstwo_tpu_torch.ops import blake2s, fft, fri_ops
    from tstwo_tpu_torch.poly.twiddles import precompute_twiddles
    from tstwo_tpu_torch.utils import to_torch_u32

    rng = np.random.default_rng(1)
    P = (1 << 31) - 1
    # the 2^16 x 32 prove's twiddle tree (root coset of log 18)
    tree = precompute_twiddles(CanonicCoset.new(18).circle_domain().half_coset)

    def rand(shape, high=P):
        return to_torch_u32(rng.integers(0, high, size=shape, dtype=np.uint64)
                            .astype(np.uint32), device)

    rows = []

    def check(name, shape, kernel, plain, source):
        t0 = time.perf_counter()
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        got_t = got if isinstance(got, tuple) else (got,)
        want_t = want if isinstance(want, tuple) else (want,)
        err = max(max_abs_err(g, w) for g, w in zip(got_t, want_t))
        ms, plain_ms = time_ms(kernel), time_ms(plain)
        phase(f"kernel {name} {shape}", time.perf_counter() - t0,
              f"max_abs_err {err} (tolerance 0), kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms")
        if err != 0:
            fail(f"{name} {shape} disagrees with its plain version")
        rows.append({"name": name, "shape": shape, "route": "cuda",
                     "source": CSRC + source, "replaces": REPLACES[name],
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})

    for name, (batch, log_n), inverse in [
            ("cfft_forward", (32, 17), False),
            ("cfft_forward", (4, 18), False),
            ("cfft_inverse", (32, 16), True),
            ("cfft_block_resident", (32, 10), False)]:
        x = rand((batch, 1 << log_n))
        line, circle, buf = tree.fft_twiddles(log_n, inverse, device)
        check(name, f"[{batch},2^{log_n}]",
              lambda: fft.cfft_cuda(x, buf, log_n, inverse),
              lambda: fft.fft_plain(x, line, circle, inverse), "cfft.cu")

    for (n_words, log_n), byte_len in [((32, 17), 128), ((16, 16), 64)]:
        w = rand((n_words, 1 << log_n), 1 << 32)
        check("blake2s", f"[{n_words},2^{log_n}]",
              lambda: blake2s.hash_words_major_cuda(w, byte_len),
              lambda: blake2s.hash_words_major_plain(w, byte_len),
              "blake2s.cu")

    x = rand((4, 1 << 18))
    check("deinterleave", "[4,2^18]", lambda: fri_ops.deinterleave_cuda(x),
          lambda: tuple(t.contiguous() for t in fri_ops.deinterleave_plain(x)),
          "deinterleave.cu")
    return rows


def proof_json(proof) -> str:
    from tstwo_tpu_torch.serialize import proof_to_dict

    return json.dumps(proof_to_dict(proof), sort_keys=True)


def main() -> None:
    if not (ROOT / "tstwo_tpu_torch" / "kernels.py").is_file():
        fail("tstwo_tpu_torch is not beside this script")
    if not FIXTURE.is_file():
        fail(f"missing golden fixture {FIXTURE}")
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    sys.path.insert(0, str(ROOT))
    from tstwo_tpu_torch import kernels
    from tstwo_tpu_torch.examples.wide_fibonacci import (
        prove_wide_fibonacci, verify_wide_fibonacci)

    # 1. the card
    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    device = torch.device("cuda", 0)
    phase("card", time.perf_counter() - t0,
          f"{torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} device(s)")

    # 2. build
    t0 = time.perf_counter()
    kernels.lib()
    info = kernels.BUILD_INFO
    phase("build", time.perf_counter() - t0,
          f"nvcc {info['seconds']:.1f} s{' (cached)' if info['cached'] else ''}"
          f" -> {Path(info['path']).relative_to(ROOT)}")
    for line in info.get("ptxas", "").splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}", flush=True)

    # 3. kernels against their plain versions
    t0 = time.perf_counter()
    rows = compare_kernels(device)
    phase("kernels", time.perf_counter() - t0, f"{len(rows)} checks exact")

    # 4. golden proof against the JAX package's
    t0 = time.perf_counter()
    proof, comp, cfg = prove_wide_fibonacci(8, 8, seed=0, device=device)
    if proof_json(proof) != FIXTURE.read_text().strip():
        fail("wide-Fibonacci 8x8 CUDA proof differs from the JAX fixture")
    verify_wide_fibonacci(proof, comp, cfg, 8)
    phase("golden", time.perf_counter() - t0,
          "log 8 x 8 seed 0 proof == JAX fixture; verified")

    # 5. mid-size: CUDA proof == the CPU plain path's proof
    t0 = time.perf_counter()
    cuda_json = proof_json(prove_wide_fibonacci(12, 32, seed=0,
                                                device=device)[0])
    cpu_json = proof_json(prove_wide_fibonacci(12, 32, seed=0,
                                               device="cpu")[0])
    if cuda_json != cpu_json:
        fail("wide-Fibonacci 12x32 CUDA proof differs from the CPU proof")
    phase("mid_size", time.perf_counter() - t0,
          "log 12 x 32 CUDA proof == CPU plain proof")

    # 6. real size, counting the kernels the main path launches.  The
    # first prove at a size also fills the host-side caches of that size
    # (twiddle trees, domain points, vanishing inverses); the second is
    # the warm time.
    t0 = time.perf_counter()
    prove_wide_fibonacci(16, 32, seed=0, device=device)  # warm run
    torch.cuda.synchronize()
    phase("warm", time.perf_counter() - t0, "log 16 x 32 warm prove")
    kernels.reset_launches()
    for log_n, seq in [(16, 32), (18, 64)]:
        walls = []
        for _ in range(2):
            torch.cuda.reset_peak_memory_stats(device)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            proof, comp, cfg = prove_wide_fibonacci(log_n, seq, seed=0,
                                                    device=device)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated(device)
        t1 = time.perf_counter()
        verify_wide_fibonacci(proof, comp, cfg, log_n)
        phase(f"prove {log_n}x{seq}", walls[1],
              f"two proves {walls[0]:.3f} s, {walls[1]:.3f} s; verified in "
              f"{time.perf_counter() - t1:.3f} s;"
              f" peak device memory {peak / 2**30:.3f} GiB; proof "
              f"{proof.size_estimate()} bytes")
    launches = dict(kernels.LAUNCHES)
    phase("launches", 0.0, json.dumps(launches, sort_keys=True))
    counts = {
        "cfft_forward": launches["cfft_forward"],
        "cfft_inverse": launches["cfft_inverse"],
        # the block-resident stage runs in every CFFT launch
        "cfft_block_resident": launches["cfft_forward"]
        + launches["cfft_inverse"],
        "blake2s": launches["blake2s"],
        "deinterleave": launches["deinterleave"],
    }
    for name, n in counts.items():
        if n <= 0:
            fail(f"kernel {name} was not launched by the main path")
    for row in rows:
        row["launches"] = counts[row["name"]]

    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
