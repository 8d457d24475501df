"""Lookups (lookups/gkr.py, sumcheck.py, mle.py): the program's synchronised
`gkr_layers` span, every instance's circuit made by halving its input layer
by layer, mean ms a proof."""


def read(ctx):
    return ctx.span_ms.get("gkr_layers")
