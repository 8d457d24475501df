"""Hand kernels (csrc/, kernels.py): the circle FFT's share of its roofline.
Work: every transform the prove needs, from the cell's sizes (the AIR's
`cfft_transforms`), counted by stark_bench/roofline.py; time: the profiled
device time of the CFFT pass kernels a proof."""
import sys

from stark_bench import roofline

KERNELS = ("cfft_pass_kernel",)


def read(ctx):
    seconds = sum(d for name, d in ctx.kernels
                  if any(k in name for k in KERNELS)) / ctx.n_profiled
    if seconds <= 0:
        return None
    work = roofline.cfft_work(ctx.reference.cfft_transforms(ctx.config,
                                                            ctx.log_n))
    pct, by = roofline.share_pct(work, seconds)
    print(f"csrc.cfft_roofline: {pct} % of the bound by {by}; "
          f"{seconds * 1e3} ms of kernel a proof", file=sys.stderr)
    return pct
