"""The yardstick of the kernels' roofline shares, frozen.

Copied from the program's own sound arithmetic so that a later change to
the program cannot move it:

- the peaks of one H100 SXM and the integer rate (chip_smoke.py's
  HBM_BYTES_PER_S and INT32_OPS_PER_S): 3.35 TB/s of device memory; 67
  TFLOP/s of float32 outside the tensor cores = 132 SMs x 128 lanes x 2 x
  1.98 GHz, of which an SM issues int32 operations on half the lanes, an
  add, xor or shift being one operation: 1.675e13 integer operations a
  second.  The clock is the data sheet's boost clock, not one sampled: the
  traced run prints `clocks.sm` and `power.limit` beside its numbers;
- 16 integer operations an M31 butterfly and 656 a Blake2s block
  compression, the xors and shifts of its 80 G-mixes and the 16 xors of
  the fold (tests/torch_cuda_cases.py's BUTTERFLY_OPS and
  B2S_OPS_PER_BLOCK);
- a transform's bytes, each input once and each output once, the
  twiddles once; a transform zero-extended from 2^m values is counted by
  the log2(m) layers of its source size (the `cost` of
  tests/torch_cuda_cases.py's `cfft_case`).

A share is the least time the card could take, the larger of operations
over the integer rate and bytes over the memory rate, over the device
time of the kernels that do the work.
"""
from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 4
BUTTERFLY_OPS = 16
B2S_OPS_PER_BLOCK = 80 * 8 + 16


def bound_s(n_ops: float, n_bytes: float) -> Tuple[float, str]:
    """The least seconds for the work, and which rate bounds it."""
    by_ops, by_bytes = n_ops / INT32_OPS_PER_S, n_bytes / HBM_BYTES_PER_S
    return (by_ops, "operations") if by_ops >= by_bytes else (by_bytes,
                                                              "bytes")


def cfft_work(transforms: Iterable[Tuple[int, int, int]]
              ) -> Tuple[float, float]:
    """(operations, bytes) of circle FFTs given as (columns, log size of
    the result, log size of the source)."""
    ops = n_bytes = 0
    for batch, log_n, log_m in transforms:
        n, m = 1 << log_n, 1 << log_m
        ops += BUTTERFLY_OPS * batch * (n >> 1) * log_m
        n_bytes += 4 * (batch * m + batch * n + n)
    return ops, n_bytes


def merkle_blocks(tree: Sequence[Tuple[int, int]]) -> Tuple[int, int, int]:
    """(Blake2s blocks, nodes, column values) of a tree whose columns are
    given as (log size, columns) per size.  A node hashes its two children
    (64 bytes, below the leaves) and its columns' values (4 bytes each);
    a tree without columns is one node that hashes nothing."""
    cols = dict(tree)
    top = max(cols, default=0)
    blocks = nodes = values = 0
    for log in range(top, -1, -1):
        n_bytes = (64 if log < top else 0) + 4 * cols.get(log, 0)
        blocks += (1 << log) * max(1, -(-n_bytes // 64))
        nodes += 1 << log
        values += (1 << log) * cols.get(log, 0)
    return blocks, nodes, values


def blake2s_work(trees: List[Sequence[Tuple[int, int]]]
                 ) -> Tuple[float, float]:
    """(operations, bytes) of Blake2s Merkle trees: every block compressed,
    every column value read once and every node's digest written once."""
    ops = n_bytes = 0
    for tree in trees:
        blocks, nodes, values = merkle_blocks(tree)
        ops += B2S_OPS_PER_BLOCK * blocks
        n_bytes += 4 * values + 32 * nodes
    return ops, n_bytes


def share_pct(work: Tuple[float, float], kernel_s: float
              ) -> Tuple[float, str]:
    least, by = bound_s(*work)
    return 100.0 * least / kernel_s, by
