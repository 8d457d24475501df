"""tstwo_tpu_torch: the Circle-STARK prover of tstwo_tpu on PyTorch and CUDA.

The Blake2s prove -> verify path of the JAX package, on torch tensors:
columns are int32 tensors of canonical M31 values on one device, or
point-sharded over the ranks of torch.distributed (parallel/, `mesh=`).  On a
CUDA device the circle FFT, the batched Blake2s (Merkle layers and the
proof-of-work grind) and the even/odd deinterleave run as hand-written
CUDA kernels (csrc/, built with nvcc at first use); on the CPU they run as
their plain PyTorch versions.  Proofs
are byte-identical to the JAX package's.

Layers:
  fields / circle          host scalar spine (exact Python ints)
  ops                      tensor field ops + the kernel wrappers
  poly                     circle/line polynomials, twiddles, CFFT
  channel / vcs            Fiat-Shamir + Merkle commitments
  fri / pcs                low-degree test + polynomial commitment scheme
  air / constraint_framework  AIR components and constraint evaluation
  prover                   prove() / verify() orchestration
  parallel                 mesh, sharded CFFT, sharded ops and Merkle trees
"""

from .fields import M31, CM31, QM31, P, SECURE_EXTENSION_DEGREE  # noqa: F401

__version__ = "0.1.0"
