"""Hand kernels (csrc/, kernels.py): the Blake2s Merkle kernels' share of
their roofline.  Work: the blocks of every tree the prove commits, leaves
and nodes, from the cell's sizes (the AIR's `merkle_trees`), counted by
stark_bench/roofline.py; time: the profiled device time of the layer and
tail kernels a proof.  Nothing to read under another Merkle flavour."""
import sys

from stark_bench import roofline

KERNELS = ("blake2s_layer_kernel", "merkle_tail_kernel")


def read(ctx):
    if ctx.config["merkle_channel"] != "blake2s":
        return None
    seconds = sum(d for name, d in ctx.kernels
                  if any(k in name for k in KERNELS)) / ctx.n_profiled
    if seconds <= 0:
        return None
    work = roofline.blake2s_work(ctx.reference.merkle_trees(ctx.config,
                                                            ctx.log_n))
    pct, by = roofline.share_pct(work, seconds)
    print(f"csrc.blake2s_roofline: {pct} % of the bound by {by}; "
          f"{seconds * 1e3} ms of kernel a proof", file=sys.stderr)
    return pct
