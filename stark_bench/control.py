"""The control of the comparison that decides `correct`, at a cell's size.

    python3 -m stark_bench.control --workload <cell> --seeds 3

The configuration states no precision; its guarantee is its security.  The
control breaks it: the reference proves each seed's first trace with one
query fewer (95 bits instead of 96) in the program's place, and the
comparison judges that proof against the reference's at the stated
configuration.  It prints one JSON line a seed with the numbers compared
(each must read above its limit of 0 for some number).  The benchmark's own
runs do not run it.
"""
from __future__ import annotations

import argparse
import copy
import json
import sys
import time

import torch

from . import registry
from .compare import compare
from .traffic import ClosedLoop


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, default=3)
    parser.add_argument("--first-seed", type=int, default=4_000_000_000)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("stark_bench.control needs a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    root = registry.ROOT
    bench = registry.load(root)
    entry = registry.workload(bench, args.workload)
    config = registry.config(root, bench, entry["config"])
    mix = registry.traffic(root, entry["traffic"])
    reference = registry.reference(config)
    weaker = copy.deepcopy(config)
    weaker["security"]["n_queries"] -= 1
    for k in range(args.seeds):
        seed = args.first_seed + k
        log_n = int(mix["log_n_rows"])
        inputs = reference.trace_inputs(ClosedLoop(mix, seed).trace_seed(0),
                                        log_n)
        t0 = time.perf_counter()
        sound = reference.prove(inputs, config, log_n, device)
        t1 = time.perf_counter()
        control = reference.prove(inputs, weaker, log_n, device)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": "n_queries - 1",
                          "readings": compare(control, sound),
                          "reference_s": t1 - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
