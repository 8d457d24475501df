"""Device-side tensor ops: plain PyTorch field arithmetic, and the CFFT,
Blake2s and deinterleave wrappers that launch the hand-written CUDA
kernels (csrc/) for CUDA tensors."""

from . import m31, cm31, qm31  # noqa: F401
