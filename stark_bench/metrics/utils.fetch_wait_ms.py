"""Host-device transfers (utils.py to_torch_u32 / to_numpy_u32 and the
prove path's other device reads): host ms a proof inside the program's
`fetch` spans, anywhere in the proof, from the unsynchronised span tree of
pass 3a (stark_bench/span_trace.py): the host waiting for the stream to
drain before each device-to-host read, and the copy."""
from stark_bench import span_trace


def read(ctx):
    tree = span_trace.measure(ctx)
    records = tree.get("records")
    if not records:
        return None
    fetches = span_trace.outermost(records, "fetch")
    if not fetches:
        return None
    return span_trace.host_ms(records, fetches) / tree["n"]
