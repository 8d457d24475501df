"""Lookups (lookups/gkr.py, sumcheck.py, mle.py): device idle ms a proof
inside the program's `gkr_sumcheck` ranges, from the torch.profiler timeline
of pass 3b (stark_bench/span_trace.py): the time the sum-check's host round
loop (a sync and the transcript each round) keeps the card waiting.
Nothing to read without device events (a CPU run) or without the program's
span tree."""
from stark_bench import span_trace


def read(ctx):
    tree = span_trace.measure(ctx)
    idle = (tree.get("profile") or {}).get("idle_inside", {}).get(
        "gkr_sumcheck")
    if idle is None:
        return None
    return 1e3 * idle / tree["n_profiled"]
