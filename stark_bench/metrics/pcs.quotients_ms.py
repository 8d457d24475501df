"""Commitment scheme (pcs/): the program's synchronised `fri_quotients`
span, the DEEP quotients of every committed column, mean ms a proof."""


def read(ctx):
    return ctx.span_ms.get("fri_quotients")
