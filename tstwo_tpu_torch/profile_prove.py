"""Where a prove spends its time on a CUDA device.

    python -m tstwo_tpu_torch.profile_prove --log-n 18 --seq 64
    python -m tstwo_tpu_torch.profile_prove --path logup --log-n 20
    python -m tstwo_tpu_torch.profile_prove --path gkr --log-n 20
    python -m tstwo_tpu_torch.profile_prove --path poseidon --log-n 20
    python -m tstwo_tpu_torch.profile_prove --log-n 18 --seq 64 \
        --pow-bits 26 --n-queries 70     # 96 bits: stwo-cairo's secure config

`--path` picks the prove: a wide-Fibonacci AIR of 2^log_n rows x seq
columns, the LogUp lookup AIR of 2^log_n rows, a GKR batch of one
GrandProduct and one LogUpGeneric instance of 2^log_n random values each,
or the basic AIR of 2^log_n rows under the Poseidon252 flavour;
`--pow-bits` and `--n-queries` set the PcsConfig of every path but GKR
(default: pow_bits 5, 3 queries, log blowup 1).
After one warm prove it runs three more: one plain, one under the span tree
(`tracing.enable(sync=False)`, the prove under `tracing.request(0)`), and
one under torch.profiler.  Prints one JSON object: the walls, the span tree
(one row per path of span names, in the order they first open: calls, host
ms, self ms (host less the child spans), device ms from the spans' CUDA
events, hand-kernel launches, the uploads and fetches with their
bytes, and the hashes and values the decommitment assembled, each summed
over the span and its children), the hand-kernel
launches of the plain prove (`kernels.LAUNCHES`), and the profile's top
kernels by device time.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time
from typing import Dict, List

COUNTERS = ("uploads", "upload_bytes", "fetches", "fetch_bytes",
            "decommit_hashes", "decommit_values")


def span_table(records: List[dict]) -> List[dict]:
    """The span tree's records summed by path of span names."""
    paths: List[str] = []
    rows: Dict[str, dict] = {}
    for rec in records:
        parent = rec["parent"]
        path = rec["name"] if parent is None else \
            f"{paths[parent]} > {rec['name']}"
        paths.append(path)
        host = rec["t1"] - rec["t0"]
        device = (rec["device_t1"] - rec["device_t0"]
                  if rec["device_t0"] is not None else 0.0)
        row = rows.setdefault(path, {
            "span": path, "calls": 0, "host_ms": 0.0, "self_ms": 0.0,
            "device_ms": 0.0, "launches": 0, **dict.fromkeys(COUNTERS, 0)})
        row["calls"] += 1
        row["host_ms"] += 1e3 * host
        row["self_ms"] += 1e3 * host
        row["device_ms"] += 1e3 * device
        row["launches"] += rec["launches"]
        if parent is not None:
            rows[paths[parent]]["self_ms"] -= 1e3 * host
        at = len(paths) - 1
        while at is not None:  # a span's counts go to it and its ancestors
            for name in COUNTERS:
                rows[paths[at]][name] += rec["counts"].get(name, 0)
            at = records[at]["parent"]
    return list(rows.values())


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--path", default="wide_fibonacci",
                        choices=("wide_fibonacci", "logup", "gkr",
                                 "poseidon"))
    parser.add_argument("--log-n", type=int, default=18)
    parser.add_argument("--seq", type=int, default=64)
    parser.add_argument("--top", type=int, default=12)
    parser.add_argument("--pow-bits", type=int, default=5)
    parser.add_argument("--n-queries", type=int, default=3)
    args = parser.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from . import kernels, tracing
    from .channel.blake2s import Blake2sChannel
    from .examples.basic_air import prove_basic_air
    from .examples.logup_lookup import prove_logup_lookup
    from .examples.wide_fibonacci import prove_wide_fibonacci
    from .fri import FriConfig
    from .lookups.gkr import GRAND_PRODUCT, LOGUP_GENERIC, Layer, prove_batch
    from .lookups.mle import Mle
    from .pcs import PcsConfig

    if not torch.cuda.is_available():
        raise SystemExit("profile_prove needs a CUDA device")
    device = torch.device("cuda", 0)
    config = PcsConfig(args.pow_bits, FriConfig(0, 1, args.n_queries))
    gen = torch.Generator().manual_seed(0)

    def rand_mle(low: int) -> Mle:
        return Mle(torch.randint(low, (1 << 31) - 1, (4, 1 << args.log_n),
                                 generator=gen, dtype=torch.int32).to(device))

    gkr_layers = [Layer(GRAND_PRODUCT, data=rand_mle(0)),
                  Layer(LOGUP_GENERIC, numerators=rand_mle(0),
                        denominators=rand_mle(1))
                  ] if args.path == "gkr" else None

    def prove() -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with tracing.request(0):
            if args.path == "wide_fibonacci":
                prove_wide_fibonacci(args.log_n, args.seq, config, seed=0,
                                     device=device)
            elif args.path == "logup":
                prove_logup_lookup(args.log_n, config, seed=0, device=device)
            elif args.path == "poseidon":
                prove_basic_air(args.log_n, config, device=device,
                                flavor="poseidon252")
            else:
                prove_batch(Blake2sChannel(), gkr_layers)
            torch.cuda.synchronize()
        return time.perf_counter() - t0

    warm_s = prove()
    kernels.reset_launches()
    plain_s = prove()
    launches = dict(kernels.LAUNCHES)

    tracing.reset()
    tracing.enable(sync=False)
    try:
        tree_s = prove()
        records = tracing.records()
    finally:
        tracing.disable()
        tracing.reset()

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        profiled_s = prove()
    # device-side events only (a launching CPU op also reports the time of
    # the kernels it launched)
    by_kernel = sorted(((e.key, e.self_device_time_total, e.count)
                        for e in prof.key_averages()
                        if str(e.device_type).endswith("CUDA")
                        and e.self_device_time_total > 0),
                       key=lambda k: -k[1])
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "path": args.path,
        "shape": (f"2^{args.log_n} x {args.seq}"
                  if args.path == "wide_fibonacci" else f"2^{args.log_n}"),
        "pow_bits": args.pow_bits, "n_queries": args.n_queries,
        "power_limit": subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=False).stdout.strip(),
        "prove_s": {"warm_up": warm_s, "plain": plain_s,
                    "span_tree": tree_s, "profiled": profiled_s},
        "spans": span_table(records),
        "launches_per_prove": launches,
        "top_device_kernels": [
            {"name": name[:90], "ms": t / 1e3, "calls": n}
            for name, t, n in by_kernel[:args.top]],
    }, indent=1))


if __name__ == "__main__":
    main()
