"""Constraint evaluation (constraint_framework/, air/, prover.py): host ms a
proof in the program's outermost `interaction_trace` spans (the LogUp
interaction's generation, `LogupTraceGenerator`'s first column to its
`finalize_last`), from the unsynchronised span tree of pass 3a
(stark_bench/span_trace.py).  The claimed sum's fetch inside it waits for
the device, so the span holds the interaction's device work too.  Nothing
to read for an AIR without LogUp or a program without the span."""
from stark_bench import span_trace


def read(ctx):
    tree = span_trace.measure(ctx)
    records = tree.get("records")
    if not records:
        return None
    spans = span_trace.outermost(records, "interaction_trace")
    if not spans:
        return None
    return span_trace.host_ms(records, spans) / tree["n"]
