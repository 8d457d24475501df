"""Lookups (lookups/gkr.py, sumcheck.py, mle.py): the program's synchronised
`gkr_sumcheck` spans, the batched sum-check of every GKR layer (its rounds,
their host syncs and the transcript), mean ms a proof."""


def read(ctx):
    return ctx.span_ms.get("gkr_sumcheck")
