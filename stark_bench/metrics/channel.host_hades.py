"""Fiat-Shamir channel (channel/poseidon.py): Hades permutations a proof
on the host, the program's `host_hades` counter summed over the proofs of
pass 3a (stark_bench/span_trace.py): the Poseidon252 transcript's mixes
and draws, each a permutation in Python ints.  Nothing to read where the
program has no such counter or no span tree."""
from stark_bench import span_trace

COUNTER = "host_hades"


def read(ctx):
    tree = span_trace.measure(ctx)
    counts = tree.get("counts")
    if not tree.get("records") or not any(COUNTER in c
                                          for c in counts.values()):
        return None
    return span_trace.counted(counts, COUNTER) / tree["n"]
