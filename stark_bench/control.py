"""The control of the comparison that decides `correct`, at a cell's size.

    python3 -m stark_bench.control --workload <cell> --seeds 3

The reference proves each seed's first trace in the program's place, at a
weaker guarantee or from a changed input, and the comparison judges that
proof against the reference's sound one, over the configuration's parts of
the proof.  A reference module defines the control of its configuration as
`control(inputs, config, log_n, device)` -> (label, proof); without one the
control is a STARK proof's: the configuration states no precision, its
guarantee is its security, and the control proves with one query fewer (95
bits instead of 96).  It prints one JSON line a seed with the numbers
compared (each must read above its limit of 0 for some number).  The
benchmark's own runs do not run it.
"""
from __future__ import annotations

import argparse
import copy
import json
import sys
import time
from pathlib import Path

import torch

from . import registry
from .compare import compare, parts_of
from .traffic import ClosedLoop


def readings(root: Path, bench: dict, workload: str, seed: int,
             device) -> dict:
    """The control's numbers compared on the first trace of `seed`."""
    entry = registry.workload(bench, workload)
    config = registry.config(root, bench, entry["config"])
    mix = registry.traffic(root, entry["traffic"])
    reference = registry.reference(root, config)
    log_n = int(mix["log_n_rows"])
    inputs = reference.trace_inputs(ClosedLoop(mix, seed).trace_seed(0),
                                    log_n)
    t0 = time.perf_counter()
    sound = reference.prove(inputs, config, log_n, device)
    t1 = time.perf_counter()
    if hasattr(reference, "control"):
        label, control = reference.control(inputs, config, log_n, device)
    else:  # a STARK configuration's: one query fewer
        weaker = copy.deepcopy(config)
        weaker["security"]["n_queries"] -= 1
        label = "n_queries - 1"
        control = reference.prove(inputs, weaker, log_n, device)
    return {"workload": workload, "seed": seed, "control": label,
            "readings": compare(control, sound, parts_of(config)),
            "reference_s": t1 - t0}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, default=3)
    parser.add_argument("--first-seed", type=int, default=4_000_000_000)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("stark_bench.control needs a CUDA device", file=sys.stderr)
        return 2
    root = registry.ROOT
    bench = registry.load(root)
    for k in range(args.seeds):
        print(json.dumps(readings(root, bench, args.workload,
                                  args.first_seed + k,
                                  torch.device("cuda", 0))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
