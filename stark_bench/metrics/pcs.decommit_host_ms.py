"""Commitment scheme (pcs/, vcs/prover.py decommit): host ms a proof in the
program's `decommitment` spans less the `fetch` spans inside them, from the
unsynchronised span tree of pass 3a (stark_bench/span_trace.py): the
Python witness plan and assembly, without the waits for the device."""
from stark_bench import span_trace


def read(ctx):
    tree = span_trace.measure(ctx)
    records = tree.get("records")
    if not records:
        return None
    spans = span_trace.outermost(records, "decommitment")
    if not spans:
        return None
    fetches = span_trace.outermost(records, "fetch", within="decommitment")
    return (span_trace.host_ms(records, spans)
            - span_trace.host_ms(records, fetches)) / tree["n"]
