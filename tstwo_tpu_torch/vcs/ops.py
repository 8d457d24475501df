"""MerkleChannel flavour: pairs a Merkle prover with the channel that
absorbs its roots (reference vcs/ops.ts MerkleChannel + vcs/blake2s_merkle.ts).

A flavour bundles what the PCS/FRI layers need to stay hash-agnostic:
  prover_cls().commit(columns)    device-batched Merkle tree prover
  hash_node(children, values)     host verifier-side node hash
  default_channel()               the matching Fiat-Shamir channel
  fused_fri_transcript            whether FRI's commit keeps the transcript
                                  on the device (channel/device.py)
`commit` takes the device for the tree without columns; a tree with
columns lives where they do.
"""
from __future__ import annotations


class Blake2sMerkleOps:
    """Blake2s flavour (reference vcs/blake2s_merkle.ts).  Roots are 32-byte
    digests; supports the device-resident FRI transcript."""

    name = "blake2s"
    fused_fri_transcript = True

    @staticmethod
    def prover_cls():
        from .prover import MerkleProver

        return MerkleProver

    @staticmethod
    def commit(columns, device=None):
        return Blake2sMerkleOps.prover_cls().commit(columns, device)

    @staticmethod
    def device_root_words(prover):
        """The root as int32 [8] words where the tree lies, for mixing
        into a device transcript with no host round trip."""
        return prover.layers[0][:, 0]

    @staticmethod
    def hash_node(children, values):
        from .blake2s_merkle import hash_node

        return hash_node(children, values)

    @staticmethod
    def default_channel():
        from ..channel.blake2s import Blake2sChannel

        return Blake2sChannel()


class Poseidon252MerkleOps:
    """Poseidon252 flavour (reference vcs/poseidon252_merkle.ts:19-56).
    Roots are FieldElement252; layer hashing is the hand-written Hades
    kernel on a CUDA device (ops/poseidon252.py), the transcript stays on
    the host channel."""

    name = "poseidon252"
    fused_fri_transcript = False

    @staticmethod
    def prover_cls():
        from .poseidon252_merkle import Poseidon252MerkleProver

        return Poseidon252MerkleProver

    @staticmethod
    def commit(columns, device=None):
        return Poseidon252MerkleOps.prover_cls().commit(columns, device)

    @staticmethod
    def hash_node(children, values):
        from .poseidon252_merkle import hash_node

        return hash_node(children, values)

    @staticmethod
    def default_channel():
        from ..channel.poseidon import Poseidon252Channel

        return Poseidon252Channel()


MERKLE_OPS = {
    "blake2s": Blake2sMerkleOps,
    "poseidon252": Poseidon252MerkleOps,
}
