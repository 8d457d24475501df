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
After one warm prove it runs two more: one under synchronised tracing
spans (host wall time per prover phase, device work included), and one
under torch.profiler (device time by kernel, and the device's busy share
of the prove's wall time).  It also counts, per warm prove, the launches
of each hand kernel (`kernels.LAUNCHES`), in all and inside
`MerkleProver.commit` (of either flavour), and from the profile the `cat`, `pad`,
`contiguous` and `clone` calls made inside `MerkleProver.commit` with
their device time, and the span of those commits on the device's timeline
(first to last kernel of each).  Every call of `evaluate_values` and
`interpolate_values` (the CFFT's callers) runs under a range too, and
every `aten::` operator that starts inside one is counted
(`ops_in_cfft_callers`): a pad before or a product after the transform
would show there.  Prints one JSON object.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time


COMMIT_RANGE = "MerkleProver.commit"
CFFT_RANGE = "circle_poly.cfft_caller"
GLUE_OPS = ("aten::cat", "aten::pad", "aten::contiguous", "aten::clone")
HAND_KERNEL_TAGS = ("cfft", "blake2s", "deinterleave", "m31_mul", "merkle",
                    "hades", "grind")


def ops_inside(events, range_name: str, op_names) -> dict:
    """Calls of the CPU ops `op_names` that start inside a profiler range
    called `range_name`, with the device time of what they launched:
    {op: {"calls": n, "device_ms": t}}.  `op_names` None: every `aten::`
    operator of the profile."""
    spans = sorted((e.time_range.start, e.time_range.end, e.thread)
                   for e in events if e.name == range_name)
    if op_names is None:  # every aten operator
        op_names = sorted({e.name for e in events
                           if e.name.startswith("aten::")})
    out = {name: {"calls": 0, "device_ms": 0.0} for name in op_names}
    for e in events:
        if e.name not in out:
            continue
        at = e.time_range.start
        if any(s <= at <= t and thread == e.thread for s, t, thread in spans):
            out[e.name]["calls"] += 1
            out[e.name]["device_ms"] += e.device_time_total / 1e3
    return out


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
    from torch.profiler import ProfilerActivity, profile, record_function

    from . import kernels, tracing
    from .channel.blake2s import Blake2sChannel
    from .examples.basic_air import prove_basic_air
    from .examples.logup_lookup import prove_logup_lookup
    from .examples.wide_fibonacci import prove_wide_fibonacci
    from .fri import FriConfig
    from .pcs import PcsConfig
    from .lookups.gkr import GRAND_PRODUCT, LOGUP_GENERIC, Layer, prove_batch
    from .lookups.mle import Mle
    from .vcs.poseidon252_merkle import Poseidon252MerkleProver
    from .vcs.prover import MerkleProver

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

    # every Merkle commit of the prove runs under a profiler range, and its
    # hand-kernel launches are counted apart
    in_commit = dict.fromkeys(kernels.LAUNCHES, 0)

    def counted(commit):
        def counted_commit(*a, **kw):
            before = dict(kernels.LAUNCHES)
            with record_function(COMMIT_RANGE):
                tree = commit(*a, **kw)
            for name, count in kernels.LAUNCHES.items():
                in_commit[name] = in_commit.get(name, 0) + count - before[name]
            return tree
        return staticmethod(counted_commit)

    for prover in (MerkleProver, Poseidon252MerkleProver):
        prover.commit = counted(prover.commit)

    # the CFFT's callers run under a range as well, wherever they were
    # imported by name
    from . import constraint_framework
    from .pcs import prover as pcs_prover
    from .poly import circle_poly

    def ranged(fn):
        def call(*a, **kw):
            with record_function(CFFT_RANGE):
                return fn(*a, **kw)
        return call

    for name in ("evaluate_values", "interpolate_values"):
        wrapped = ranged(getattr(circle_poly, name))
        for module in (circle_poly, pcs_prover, constraint_framework):
            if hasattr(module, name):
                setattr(module, name, wrapped)

    warm_s = prove()
    kernels.reset_launches()
    in_commit = dict.fromkeys(kernels.LAUNCHES, 0)
    plain_s = prove()
    launches = dict(kernels.LAUNCHES)
    launches_in_commit = dict(in_commit)

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
    # (the two ranges also have device-side events, first to last kernel
    # of each commit or CFFT caller: reported apart, they are no kernels)
    averages = [e for e in prof.key_averages()
                if str(e.device_type).endswith("CUDA")
                and e.self_device_time_total > 0]
    commit_span_us = sum(e.self_device_time_total for e in averages
                         if e.key == COMMIT_RANGE)
    cfft_span_us = sum(e.self_device_time_total for e in averages
                       if e.key == CFFT_RANGE)
    by_kernel = [(e.key, e.self_device_time_total, e.count)
                 for e in averages if e.key not in (COMMIT_RANGE, CFFT_RANGE)]
    device_us = sum(t for _, t, _ in by_kernel)
    by_kernel.sort(key=lambda k: -k[1])
    hand = [{"name": name[:60], "ms": t / 1e3, "calls": n}
            for name, t, n in by_kernel
            if any(tag in name for tag in HAND_KERNEL_TAGS)]
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
                    "synced_spans": spans_wall_s, "profiled": profiled_s},
        "spans_s": dict(sorted(spans.items(), key=lambda kv: -kv[1])),
        "profiled_device_busy_s": device_us / 1e6,
        "profiled_device_busy_share": device_us / 1e6 / profiled_s,
        "top_device_kernels": [
            {"name": name[:90], "ms": t / 1e3, "calls": n}
            for name, t, n in by_kernel[:args.top]],
        "hand_kernels_profiled": hand,
        "launches_per_prove": launches,
        "launches_in_merkle_commit": launches_in_commit,
        "merkle_commit_device_span_ms": commit_span_us / 1e3,
        "cfft_callers_device_span_ms": cfft_span_us / 1e3,
        "ops_in_merkle_commit": ops_inside(prof.events(), COMMIT_RANGE,
                                           GLUE_OPS),
        "ops_in_cfft_callers": {
            op: v for op, v in ops_inside(prof.events(), CFFT_RANGE,
                                          None).items() if v["calls"]},
    }, indent=1))


if __name__ == "__main__":
    main()
