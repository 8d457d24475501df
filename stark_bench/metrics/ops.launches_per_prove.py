"""Field ops and host dispatch (ops/, plain PyTorch): CUDA kernel launches a
proof, every kernel, hand-written or PyTorch's, from the torch.profiler
trace of the profiled proofs."""


def read(ctx):
    if not ctx.launches:
        return None
    return ctx.launches / ctx.n_profiled
