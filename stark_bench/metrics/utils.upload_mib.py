"""Host-device transfers (utils.py to_torch_u32 / to_numpy_u32 and the
prove path's other device reads): MiB a proof copied from the host to the
device, the program's `upload_bytes` counter summed over the proofs of
pass 3a (stark_bench/span_trace.py).  0 on the CPU, where nothing is
uploaded."""
from stark_bench import span_trace


def read(ctx):
    tree = span_trace.measure(ctx)
    if not tree.get("records"):
        return None
    return span_trace.counted(tree["counts"], "upload_bytes") / tree["n"] \
        / float(1 << 20)
