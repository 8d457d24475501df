"""Hand kernels (csrc/, kernels.py): the DEEP quotient kernel's share of its
roofline, which counts bytes alone.  Work: every column value of the trees
committed before FRI's first layer read once, and each quotient evaluation
of that layer written once, 4 bytes a value, from the cell's sizes (the
AIR's `merkle_trees`); time: the profiled device time of
`accumulate_quotients_kernel` a proof.  Nothing to read for a program
without the kernel."""
import sys
from typing import List, Sequence, Tuple

from stark_bench import roofline

KERNELS = ("accumulate_quotients_kernel",)


def first_layer(trees: List[Sequence[Tuple[int, int]]]) -> int:
    """The index of FRI's first layer among the trees: the last tree that
    holds 4 columns at each log size the trees before it hold."""
    found = None
    for i, tree in enumerate(trees):
        logs = {log for before in trees[:i] for log, _ in before}
        if logs and sorted(tree, reverse=True) == sorted(
                ((log, 4) for log in logs), reverse=True):
            found = i
    if found is None:
        raise ValueError("no tree is FRI's first layer")
    return found


def quotient_bytes(trees: List[Sequence[Tuple[int, int]]]) -> int:
    """Bytes the quotients need: the committed columns' values in, the
    first layer's values out."""
    k = first_layer(trees)
    values = sum(cols << log for tree in trees[:k + 1] for log, cols in tree)
    return 4 * values


def read(ctx):
    seconds = sum(d for name, d in ctx.kernels
                  if any(k in name for k in KERNELS)) / ctx.n_profiled
    if seconds <= 0:
        return None
    n_bytes = quotient_bytes(ctx.reference.merkle_trees(ctx.config,
                                                        ctx.log_n))
    pct, by = roofline.share_pct((0, n_bytes), seconds)
    print(f"csrc.quotients_roofline: {pct} % of the bound by {by}; "
          f"{seconds * 1e3} ms of kernel a proof", file=sys.stderr)
    return pct
