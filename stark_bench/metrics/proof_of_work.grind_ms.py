"""Proof of work (proof_of_work.py, ops/poseidon252.py): the program's
synchronised `grind` spans, mean ms a proof: the scan for the least nonce,
on the card one launch of a grind kernel and an 8-byte read a batch."""


def read(ctx):
    return ctx.span_ms.get("grind")
