"""Lookups (lookups/gkr.py, sumcheck.py, mle.py): CUDA kernel launches a
proof (every kernel in the torch.profiler trace of the profiled proofs) over
the sum-check rounds a proof (the program's `sumcheck_rounds` counter, pass
3a of stark_bench/span_trace.py): what each host round of the GKR prove
costs in launches.  Nothing to read without device events or without the
counter."""
from stark_bench import span_trace


def read(ctx):
    if not ctx.launches:
        return None
    tree = span_trace.measure(ctx)
    counts = tree.get("counts")
    rounds = span_trace.counted(counts, "sumcheck_rounds") if counts else 0
    if not rounds:
        return None
    return ctx.launches / ctx.n_profiled / (rounds / tree["n"])
