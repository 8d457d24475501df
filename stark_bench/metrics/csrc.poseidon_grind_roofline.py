"""Hand kernels (csrc/, kernels.py): the Poseidon252 grind kernel's share
of its roofline.  Work: two Hades permutations for each nonce up to the
least hit of each profiled proof, nonce + 1 of them, which any least-hit
grind must hash whatever its batch (the reference's `grind_work`, 33,308
integer operations a permutation), at stark_bench/roofline.py's rates;
time: the profiled device time of the grind kernel in the same proofs.
Their nonces are read by proving their traces again, the run's first
`profiled_proofs` traces (stark_bench/run.py `_traced`).  Nothing to read
under another Merkle flavour or without the kernel in the trace."""
import sys

from stark_bench import registry, roofline, span_trace
from stark_bench.traffic import ClosedLoop

KERNELS = ("poseidon_grind_kernel",)


def read(ctx):
    if ctx.config["merkle_channel"] != "poseidon252":
        return None
    seconds = sum(d for name, d in ctx.kernels
                  if any(k in name for k in KERNELS))
    if seconds <= 0:
        return None
    import torch

    recipe = registry.recipe(registry.ROOT, ctx.config)
    loop = ClosedLoop(ctx.traffic, span_trace._run_seed())
    device = torch.device("cuda", 0) if torch.cuda.is_available() \
        else torch.device("cpu")
    nonces = [recipe.proof_fields(recipe.prove(
        ctx.config, ctx.log_n, loop.trace_seed(i), device))["proof_of_work"]
        for i in range(ctx.n_profiled)]
    pct, by = roofline.share_pct(ctx.reference.grind_work(nonces), seconds)
    print(f"csrc.poseidon_grind_roofline: {pct} % of the bound by {by}; "
          f"{seconds * 1e3} ms of kernel over {ctx.n_profiled} proofs, "
          f"nonces {nonces}", file=sys.stderr)
    return pct
