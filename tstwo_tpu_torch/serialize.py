"""Proof serialization (JSON-compatible dicts).

The dict layout is the JAX package's (tstwo_tpu/serialize.py), so a proof
made by either package loads into the other's verifier, and two proofs
compare as json.dumps(proof_to_dict(p), sort_keys=True).
"""
from __future__ import annotations

from typing import Any, Dict, List

from .fields import M31, QM31
from .fri import FriLayerProof, FriProof
from .pcs import PcsConfig
from .fri import FriConfig
from .pcs.prover import CommitmentSchemeProof
from .pcs.utils import TreeVec
from .poly.line import LinePoly
from .prover import StarkProof
from .vcs.prover import MerkleDecommitment


def _qm31_to(v: QM31) -> List[int]:
    return list(v.to_ints())


def _qm31_from(v: List[int]) -> QM31:
    return QM31.from_ints(v)


def decommitment_to_dict(d: MerkleDecommitment) -> Dict[str, Any]:
    return {
        "hash_witness": [h.hex() for h in d.hash_witness],
        "column_witness": [m.value for m in d.column_witness],
    }


def decommitment_from_dict(d: Dict[str, Any]) -> MerkleDecommitment:
    return MerkleDecommitment(
        hash_witness=[bytes.fromhex(h) for h in d["hash_witness"]],
        column_witness=[M31(v) for v in d["column_witness"]],
    )


def fri_layer_to_dict(l: FriLayerProof) -> Dict[str, Any]:
    return {
        "fri_witness": [_qm31_to(v) for v in l.fri_witness],
        "decommitment": decommitment_to_dict(l.decommitment),
        "commitment": l.commitment.hex(),
    }


def fri_layer_from_dict(d: Dict[str, Any]) -> FriLayerProof:
    return FriLayerProof(
        fri_witness=[_qm31_from(v) for v in d["fri_witness"]],
        decommitment=decommitment_from_dict(d["decommitment"]),
        commitment=bytes.fromhex(d["commitment"]),
    )


def proof_to_dict(proof: StarkProof) -> Dict[str, Any]:
    p = proof.commitment_scheme_proof
    return {
        "config": {
            "pow_bits": p.config.pow_bits,
            "fri_config": {
                "log_last_layer_degree_bound":
                    p.config.fri_config.log_last_layer_degree_bound,
                "log_blowup_factor": p.config.fri_config.log_blowup_factor,
                "n_queries": p.config.fri_config.n_queries,
            },
        },
        "commitments": [c.hex() for c in p.commitments],
        "sampled_values": [[[_qm31_to(v) for v in col] for col in tree]
                           for tree in p.sampled_values],
        "decommitments": [decommitment_to_dict(d) for d in p.decommitments],
        "queried_values": [[m.value for m in tree] for tree in p.queried_values],
        "proof_of_work": p.proof_of_work,
        "fri_proof": {
            "first_layer": fri_layer_to_dict(p.fri_proof.first_layer),
            "inner_layers": [fri_layer_to_dict(l)
                             for l in p.fri_proof.inner_layers],
            "last_layer_poly": [_qm31_to(c)
                                for c in p.fri_proof.last_layer_poly.coeffs],
        },
    }


def proof_from_dict(d: Dict[str, Any]) -> StarkProof:
    cfg = PcsConfig(
        pow_bits=d["config"]["pow_bits"],
        fri_config=FriConfig(
            d["config"]["fri_config"]["log_last_layer_degree_bound"],
            d["config"]["fri_config"]["log_blowup_factor"],
            d["config"]["fri_config"]["n_queries"],
        ),
    )
    csp = CommitmentSchemeProof(
        config=cfg,
        commitments=TreeVec(bytes.fromhex(c) for c in d["commitments"]),
        sampled_values=TreeVec(
            [[_qm31_from(v) for v in col] for col in tree]
            for tree in d["sampled_values"]),
        decommitments=TreeVec(decommitment_from_dict(x)
                              for x in d["decommitments"]),
        queried_values=TreeVec([M31(v) for v in tree]
                               for tree in d["queried_values"]),
        proof_of_work=d["proof_of_work"],
        fri_proof=FriProof(
            first_layer=fri_layer_from_dict(d["fri_proof"]["first_layer"]),
            inner_layers=[fri_layer_from_dict(l)
                          for l in d["fri_proof"]["inner_layers"]],
            last_layer_poly=LinePoly(tuple(
                _qm31_from(c) for c in d["fri_proof"]["last_layer_poly"])),
        ),
    )
    return StarkProof(csp)
