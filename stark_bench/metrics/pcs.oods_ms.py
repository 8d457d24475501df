"""Commitment scheme (pcs/): the program's synchronised
`evaluate_columns_out_of_domain` span, mean ms a proof."""


def read(ctx):
    return ctx.span_ms.get("evaluate_columns_out_of_domain")
