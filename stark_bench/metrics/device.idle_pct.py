"""Device (H100): the share of the profiled proofs' wall in which no kernel,
copy or memset runs on the card, from the torch.profiler timeline.  The
profiler slows the host, so this reads higher than in an untraced run."""


def read(ctx):
    if not ctx.window_s or ctx.busy_s is None:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s)
