"""Vector commitment schemes: Merkle trees over mixed-size columns."""

from .prover import MerkleDecommitment, MerkleProver  # noqa: F401
from .verifier import MerkleVerificationError, MerkleVerifier  # noqa: F401
from .blake2s_merkle import Blake2sMerkleChannel, hash_node  # noqa: F401
