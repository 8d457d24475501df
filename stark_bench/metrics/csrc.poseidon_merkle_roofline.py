"""Hand kernels (csrc/, kernels.py): the Poseidon252 Merkle layer kernel's
share of its roofline.  Work: the Hades permutations of every tree the
prove commits, leaves and nodes, from the cell's sizes (the reference's
`poseidon_work`: `poseidon_permutations` x 33,308 integer operations,
each column value read and each node written once), at
stark_bench/roofline.py's rates; time: the profiled device time of the
layer kernel a proof.  Nothing to read under another Merkle flavour."""
import sys

from stark_bench import roofline

KERNELS = ("poseidon_merkle_layer_kernel",)


def read(ctx):
    if ctx.config["merkle_channel"] != "poseidon252":
        return None
    seconds = sum(d for name, d in ctx.kernels
                  if any(k in name for k in KERNELS)) / ctx.n_profiled
    if seconds <= 0:
        return None
    work = ctx.reference.poseidon_work(ctx.config, ctx.log_n)
    pct, by = roofline.share_pct(work, seconds)
    print(f"csrc.poseidon_merkle_roofline: {pct} % of the bound by {by}; "
          f"{seconds * 1e3} ms of kernel a proof for "
          f"{ctx.reference.poseidon_permutations(ctx.config, ctx.log_n)} "
          "permutations", file=sys.stderr)
    return pct
