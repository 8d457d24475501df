"""Merkle trees (vcs/): the program's synchronised `merkle` spans (the trace
and composition trees; FRI's trees are inside `fri_commit`), mean ms a
proof."""


def read(ctx):
    return ctx.span_ms.get("merkle")
