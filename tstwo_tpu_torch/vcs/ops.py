"""MerkleChannel flavour: pairs a Merkle prover with the channel that
absorbs its roots (reference vcs/ops.ts MerkleChannel + vcs/blake2s_merkle.ts).

A flavour bundles what the PCS/FRI layers need to stay hash-agnostic:
  commit(columns)                 device-batched Merkle tree prover
  hash_node(children, values)     host verifier-side node hash
  default_channel()               the matching Fiat-Shamir channel
Only the Blake2s flavour is ported.
"""
from __future__ import annotations


class Blake2sMerkleOps:
    """Blake2s flavour (reference vcs/blake2s_merkle.ts).  Roots are 32-byte
    digests."""

    name = "blake2s"

    @staticmethod
    def commit(columns):
        from .prover import MerkleProver

        return MerkleProver.commit(columns)

    @staticmethod
    def hash_node(children, values):
        from .blake2s_merkle import hash_node

        return hash_node(children, values)

    @staticmethod
    def default_channel():
        from ..channel.blake2s import Blake2sChannel

        return Blake2sChannel()


MERKLE_OPS = {"blake2s": Blake2sMerkleOps}
