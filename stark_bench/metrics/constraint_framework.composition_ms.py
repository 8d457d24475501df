"""Constraint evaluation (constraint_framework/, air/, prover.py): the
program's synchronised `composition` span, mean ms a proof."""


def read(ctx):
    return ctx.span_ms.get("composition")
