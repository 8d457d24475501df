"""Where a prove spends its time on a CUDA device.

    python -m tstwo_tpu_torch.profile_prove --log-n 18 --seq 64
    python -m tstwo_tpu_torch.profile_prove --path logup --log-n 20
    python -m tstwo_tpu_torch.profile_prove --path gkr --log-n 20

`--path` picks the prove: a wide-Fibonacci AIR of 2^log_n rows x seq
columns, the LogUp lookup AIR of 2^log_n rows, or a GKR batch of one
GrandProduct and one LogUpGeneric instance of 2^log_n random values each.
After one warm prove it runs two more: one under synchronised tracing
spans (host wall time per prover phase, device work included), and one
under torch.profiler (device time by kernel, and the device's busy share
of the prove's wall time).  Prints one JSON object.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import time


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--path", default="wide_fibonacci",
                        choices=("wide_fibonacci", "logup", "gkr"))
    parser.add_argument("--log-n", type=int, default=18)
    parser.add_argument("--seq", type=int, default=64)
    parser.add_argument("--top", type=int, default=12)
    args = parser.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from . import tracing
    from .channel.blake2s import Blake2sChannel
    from .examples.logup_lookup import prove_logup_lookup
    from .examples.wide_fibonacci import prove_wide_fibonacci
    from .lookups.gkr import GRAND_PRODUCT, LOGUP_GENERIC, Layer, prove_batch
    from .lookups.mle import Mle

    if not torch.cuda.is_available():
        raise SystemExit("profile_prove needs a CUDA device")
    device = torch.device("cuda", 0)
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
        if args.path == "wide_fibonacci":
            prove_wide_fibonacci(args.log_n, args.seq, seed=0, device=device)
        elif args.path == "logup":
            prove_logup_lookup(args.log_n, seed=0, device=device)
        else:
            prove_batch(Blake2sChannel(), gkr_layers)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    warm_s = prove()
    plain_s = prove()

    tracing.reset()
    tracing.enable()
    try:
        spans_wall_s = prove()
    finally:
        tracing.disable()
    spans = tracing.totals()

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        profiled_s = prove()
    # device-side events only (a launching CPU op also reports the time of
    # the kernels it launched)
    kernels = [(e.key, e.self_device_time_total, e.count)
               for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")
               and e.self_device_time_total > 0]
    device_us = sum(t for _, t, _ in kernels)
    kernels.sort(key=lambda k: -k[1])
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "path": args.path,
        "shape": (f"2^{args.log_n} x {args.seq}"
                  if args.path == "wide_fibonacci" else f"2^{args.log_n}"),
        "prove_s": {"warm_up": warm_s, "plain": plain_s,
                    "synced_spans": spans_wall_s, "profiled": profiled_s},
        "spans_s": dict(sorted(spans.items(), key=lambda kv: -kv[1])),
        "profiled_device_busy_s": device_us / 1e6,
        "profiled_device_busy_share": device_us / 1e6 / profiled_s,
        "top_device_kernels": [
            {"name": name[:90], "ms": t / 1e3, "calls": n}
            for name, t, n in kernels[:args.top]],
    }, indent=1))


if __name__ == "__main__":
    main()
