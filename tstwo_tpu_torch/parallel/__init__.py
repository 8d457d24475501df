"""Multi-device proving over torch.distributed: the mesh, the sharded
CFFT, the sharded column operations and the sharded Merkle tree.

The prove is SPMD: every rank runs the same program, and the Fiat-Shamir
channel is replicated (deterministic, no communication), as in the JAX
package's tstwo_tpu/parallel.  A column is point-sharded: rank r of D
holds the slice [r*n/D, (r+1)*n/D) of its last axis, which for a
bit-reversed evaluation is one whole Merkle subtree.  Columns too small
to split (`Mesh.shards`) stay replicated; polynomials (coefficients) stay
replicated, evaluations stay sharded.
"""

from .mesh import Mesh, init_distributed, make_mesh, make_mesh2d  # noqa: F401
