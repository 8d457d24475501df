"""Where the one-launch top of a Merkle tree should begin, on one CUDA
device.

    python -m tstwo_tpu_torch.measure_merkle

For each log from 1 to MAX_TAIL_LOG + 1 it times, on a random layer
[8, 2^log], the tail kernel (every layer above it in one launch of one
block) against the loop of per-layer launches that computes the same
layers, device time and host enqueue time apart
(`measure_roofline.time_call`).  Then it times `MerkleProver.commit` of a
[4, 2^19] stack, the shape of a FRI first-layer tree, for each setting of
the tail's first level (`TAIL_LOG` = T: layers of at most 2^T nodes go to
the tail; -1: no tail).  Prints one JSON object.  Needs a CUDA device.
"""
from __future__ import annotations

import json

import numpy as np
import torch

from .measure_roofline import time_call
from .ops import blake2s
from .utils import to_torch_u32
from .vcs import prover

COMMIT_LOG = 19
COMMIT_COLUMNS = 4


def measure(device=None, seed: int = 0) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("the Merkle probes need a CUDA device")
    device = torch.device(device or "cuda")
    rng = np.random.default_rng(seed)

    def rand(shape, high):
        return to_torch_u32(rng.integers(0, high, size=shape, dtype=np.uint64)
                            .astype(np.uint32), device)

    def layer_loop(prev):
        while prev.shape[1] > 1:
            prev = blake2s.merkle_layer_cuda(prev, [])

    out = {"device": torch.cuda.get_device_name(device), "tail": [],
           "commit": []}
    for log in range(1, blake2s.MAX_TAIL_LOG + 2):
        prev = rand((8, 1 << log), 1 << 32)
        tail = time_call(lambda: blake2s.merkle_tail_cuda(prev), cold=False)
        loop = time_call(lambda: layer_loop(prev), cold=False)
        out["tail"].append({
            "first_level_log": log - 1, "launches_saved": log - 1,
            "tail_ms": tail["ms"], "tail_host_us": tail["host_us"],
            "layers_ms": loop["ms"], "layers_host_us": loop["host_us"]})
    stack = rand((COMMIT_COLUMNS, 1 << COMMIT_LOG), (1 << 31) - 1)
    saved = prover.TAIL_LOG
    try:
        for tail_log in (-1, *range(4, blake2s.MAX_TAIL_LOG + 1)):
            prover.TAIL_LOG = tail_log
            t = time_call(lambda: prover.MerkleProver.commit([stack]),
                          cold=False)
            out["commit"].append({"tail_log": tail_log, "ms": t["ms"],
                                  "host_us": t["host_us"]})
    finally:
        prover.TAIL_LOG = saved
    return out


if __name__ == "__main__":
    print(json.dumps(measure(), indent=1))
