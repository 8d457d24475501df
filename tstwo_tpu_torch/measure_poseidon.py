"""The Poseidon252 kernels on one CUDA device: what ptxas made of them and
their times at the shapes of a Poseidon252 prove.

    python -m tstwo_tpu_torch.measure_poseidon [--csrc DIR]

Compiles csrc/poseidon252.cu alone with `-Xptxas -v` and reports, for
`hades_permutation_kernel` and `poseidon_merkle_layer_kernel`, the registers
and spills ptxas printed and the kernel's SASS instructions by opcode
(cuobjdump).  Then it holds each row's first nodes against the plain
version (exact) and times the row with `measure_roofline.time_call`: the
Hades permutation of 2^16 states, and Merkle layers of 2^14 and 2^21 leaves
of 3 columns, 2^21 inner nodes, and 2^22 leaves of 4 columns.  `--csrc`
builds every kernel from DIR in place of the package's csrc/ (an older copy
of the sources with the same C interface), so that two versions are timed
on one card in one call: run it as old, new, new, old.  Prints one JSON
object.  Needs a CUDA device and nvcc.
"""
from __future__ import annotations

import argparse
import collections
import json
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import torch

from . import kernels
from .measure_roofline import time_call
from .ops import poseidon252 as pos
from .utils import entry_device, to_torch_u32

KERNELS = ("hades_permutation_kernel", "poseidon_merkle_layer_kernel")
# (log of the nodes, columns, whether the layer has a child layer)
LAYERS = ((14, 3, False), (21, 3, False), (21, 0, True), (22, 4, False))
HADES_LOG = 16
CHECK_NODES = 4096


def _tool(name: str) -> str:
    for cand in (Path(kernels._nvcc()).parent / name, shutil.which(name)):
        if cand and Path(cand).is_file():
            return str(cand)
    raise RuntimeError(f"{name} not found")


def compile_report(csrc: Path) -> dict:
    """ptxas's registers and spills, and SASS opcode counts, per kernel."""
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        cubin = Path(tmp) / "poseidon252.cubin"
        res = subprocess.run(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-cubin",
             "-o", str(cubin), str(csrc / "poseidon252.cu")],
            capture_output=True, text=True, check=True)
        current = None
        for line in res.stderr.splitlines():
            entry = re.search(r"entry function '([^']+)'", line)
            if entry:
                current = next((k for k in KERNELS if k in entry.group(1)), None)
                continue
            if current is None:
                continue
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                              r"loads", line)
            if spill:
                out.setdefault(current, {}).update(
                    spill_stores=int(spill.group(1)),
                    spill_loads=int(spill.group(2)))
            used = re.search(r"Used (\d+) registers", line)
            if used:
                out.setdefault(current, {})["registers"] = int(used.group(1))
                current = None
        sass = subprocess.run([_tool("cuobjdump"), "-sass", str(cubin)],
                              capture_output=True, text=True,
                              check=True).stdout
    for block in sass.split("Function : ")[1:]:
        name = next((k for k in KERNELS if k in block.split("\n", 1)[0]), None)
        if name is None:
            continue
        ops = collections.Counter(
            m.group(1) for m in re.finditer(
                r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
                block))
        out.setdefault(name, {}).update(
            sass_instructions=sum(ops.values()),
            sass_by_opcode=dict(ops.most_common(24)))
    return out


def measure(device=None, seed: int = 0) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("the Poseidon probes need a CUDA device")
    device = entry_device(device)
    rng = np.random.default_rng(seed)

    def felts(n):
        words = rng.integers(0, 1 << 32, size=(8, n), dtype=np.uint64)
        words[7] &= (1 << 19) - 1  # below 2^251, so below p
        return to_torch_u32(words.astype(np.uint32), device)

    def m31(shape):
        return to_torch_u32(rng.integers(0, (1 << 31) - 1, size=shape,
                                         dtype=np.uint64).astype(np.uint32),
                            device)

    def exact(got, want):
        if not torch.equal(got.cpu(), want.cpu()):
            raise AssertionError("kernel differs from the plain version")

    rows = []
    n = 1 << HADES_LOG
    state = torch.stack([felts(n) for _ in range(3)])
    got = pos.hades_permutation_cuda(state)
    for g, w in zip(got, pos.hades_permutation_plain(state[:, :, :CHECK_NODES])):
        exact(g[:, :CHECK_NODES], w)
    t = time_call(lambda: pos.hades_permutation_cuda(state))
    rows.append({"kernel": "hades_permutation", "shape": f"[3,8,2^{HADES_LOG}]",
                 "permutations": n, **t})
    for log_n, n_cols, with_prev in LAYERS:
        n = 1 << log_n
        prev = felts(2 * n) if with_prev else None
        cols = [m31((n_cols, n))] if n_cols else []
        got = pos.merkle_layer_cuda(prev, cols, n, device)
        k = min(n, CHECK_NODES)
        exact(got[:, :k], pos.merkle_layer_plain(
            None if prev is None else prev[:, :2 * k].contiguous(),
            [c[:, :k].contiguous() for c in cols], k, device))
        n_felts = (2 if with_prev else 0) + -(-n_cols // 8) + 1
        t = time_call(lambda: pos.merkle_layer_cuda(prev, cols, n, device))
        rows.append({"kernel": "poseidon_merkle_layer",
                     "shape": (f"2^{log_n} nodes of [8,2^{log_n + 1}]"
                               if with_prev else f"2^{log_n} leaves")
                     + (f" + [{n_cols},2^{log_n}]" if n_cols else ""),
                     "permutations": n * -(-n_felts // 2), **t})
        del prev, cols
    for r in rows:
        r["ns_per_permutation"] = r["ms"] * 1e6 / r["permutations"]
    return {"device": torch.cuda.get_device_name(device), "rows": rows}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--csrc", help="build the kernels from this copy of "
                        "csrc/ in place of the package's")
    args = parser.parse_args()
    if args.csrc:
        kernels.CSRC = Path(args.csrc).resolve()
    out = {"csrc": str(kernels.CSRC), "compile": compile_report(kernels.CSRC)}
    out.update(measure())
    print(json.dumps(out))


if __name__ == "__main__":
    main()
