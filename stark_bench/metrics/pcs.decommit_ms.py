"""Commitment scheme (pcs/, vcs/prover.py decommit): the program's
synchronised `decommitment` span, mean ms a proof."""


def read(ctx):
    return ctx.span_ms.get("decommitment")
