"""FRI (fri.py): the program's synchronised `fri_commit` span, mean ms a
proof."""


def read(ctx):
    return ctx.span_ms.get("fri_commit")
