"""Warm prove walls of two or more checkouts of this repository on one
card, in turns, each turn a process of its own that imports the package
of its checkout (and builds that checkout's kernels).

    python -m tstwo_tpu_torch.compare_trees build/parent . --order 0,1,1,0

A turn proves wide Fibonacci 2^log_n x seq twice to warm up, then times
`--walls` proves (host clock, each ended by `torch.cuda.synchronize()`)
and `--spans` more under synchronised spans (the `fri_commit` span of
each).  Prints the card's name and power limit, then one JSON line a turn:
the checkout, its walls and spans in ms, and their medians.  Host walls
vary between calls and processes: compare checkouts only within one call,
in alternating turns.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys

TURN = r'''
import json, statistics, sys, time
sys.path.insert(0, sys.argv[1])
import torch
from tstwo_tpu_torch import kernels, tracing
from tstwo_tpu_torch.examples.wide_fibonacci import prove_wide_fibonacci
log_n, seq, n_walls, n_spans = map(int, sys.argv[2:6])
kernels.lib()
device = torch.device("cuda", 0)
for _ in range(2):
    prove_wide_fibonacci(log_n, seq, seed=0, device=device)
walls = []
for _ in range(n_walls):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prove_wide_fibonacci(log_n, seq, seed=0, device=device)
    torch.cuda.synchronize()
    walls.append((time.perf_counter() - t0) * 1e3)
spans = []
for _ in range(n_spans):
    tracing.reset()
    tracing.enable()
    try:
        prove_wide_fibonacci(log_n, seq, seed=0, device=device)
    finally:
        tracing.disable()
    spans.append(tracing.totals()["fri_commit"] * 1e3)
print(json.dumps({"walls_ms": walls, "median_ms": statistics.median(walls),
                  "fri_commit_ms": spans,
                  "fri_commit_median_ms": statistics.median(spans)}))
'''


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="+", help="checkouts of the repository")
    ap.add_argument("--order", default=None,
                    help="turns as indices into the checkouts, e.g. 0,1,1,0"
                         " (default: each once, in order)")
    ap.add_argument("--log-n", type=int, default=18)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--walls", type=int, default=7)
    ap.add_argument("--spans", type=int, default=5)
    a = ap.parse_args(argv)
    order = ([int(i) for i in a.order.split(",")] if a.order
             else list(range(len(a.trees))))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(card, flush=True)
    for i in order:
        out = subprocess.run(
            [sys.executable, "-c", TURN, a.trees[i], str(a.log_n), str(a.seq),
             str(a.walls), str(a.spans)],
            capture_output=True, text=True, timeout=900)
        if out.returncode:
            sys.exit(f"{a.trees[i]}: the turn failed\n{out.stderr[-3000:]}")
        turn = json.loads(out.stdout.strip().splitlines()[-1])
        print(json.dumps({"tree": a.trees[i], **turn}), flush=True)


if __name__ == "__main__":
    main()
