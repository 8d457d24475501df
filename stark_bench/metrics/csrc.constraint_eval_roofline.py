"""Hand kernels (csrc/, kernels.py): the constraint kernel's share of its
roofline.  Work: the integer operations the AIR's equations need over the
evaluation domain (the reference's `constraint_ops`, counted from the
equations at 9 a product and 3 an addition, whatever implements them);
time: the profiled device time of `constraint_eval_kernel` a proof.
Nothing to read for an AIR whose reference does not count its constraints
or a program without the kernel."""
import sys

from stark_bench import roofline

KERNELS = ("constraint_eval_kernel",)


def read(ctx):
    count = getattr(ctx.reference, "constraint_ops", None)
    if count is None:
        return None
    seconds = sum(d for name, d in ctx.kernels
                  if any(k in name for k in KERNELS)) / ctx.n_profiled
    if seconds <= 0:
        return None
    pct, by = roofline.share_pct((count(ctx.config, ctx.log_n), 0), seconds)
    print(f"csrc.constraint_eval_roofline: {pct} % of the bound by {by}; "
          f"{seconds * 1e3} ms of kernel a proof", file=sys.stderr)
    return pct
