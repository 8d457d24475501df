"""Proof, channel-state and prover-checkpoint serialization.

The dict layout is the JAX package's (tstwo_tpu/serialize.py), so a proof
made by either package loads into the other's verifier, and two proofs
compare as json.dumps(proof_to_dict(p), sort_keys=True).  The prover
checkpoint (.npz) keeps the JAX package's format too, words as uint32, so
a checkpoint either package wrote resumes in the other.
"""
from __future__ import annotations

from typing import Any, Dict, List

from .channel import ChannelTime
from .channel.blake2s import Blake2sChannel
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


def channel_state_to_dict(ch: Blake2sChannel) -> Dict[str, Any]:
    """Checkpoint the Fiat-Shamir transcript state between proving phases."""
    return {
        "digest": ch.digest.hex(),
        "n_challenges": ch.channel_time.n_challenges,
        "n_sent": ch.channel_time.n_sent,
    }


def channel_state_from_dict(d: Dict[str, Any]) -> Blake2sChannel:
    return Blake2sChannel(
        digest=bytes.fromhex(d["digest"]),
        channel_time=ChannelTime(d["n_challenges"], d["n_sent"]),
    )


# ---------------------------------------------------------------------------
# Mid-prove phase checkpointing (tstwo_tpu/serialize.py:123-252)
#
# A prove has two expensive device phases separated by cheap host-side
# transcript steps: the commit phase (extension CFFTs + Merkle trees per
# committed tree) and the opening phase (quotients / FRI / decommitment).
# `save_prover_checkpoint` snapshots everything the opening phase needs --
# the Fiat-Shamir transcript state plus every committed tree's polynomials,
# evaluations and Merkle layers -- into one .npz; `load_prover_checkpoint`
# restores a CommitmentSchemeProver on a device that continues to a
# byte-identical proof without re-running any committed work.  A mesh
# prove (parallel/) saves whole arrays, gathered from every rank, with
# "mesh": true, and loads onto a mesh by slicing them again.
# ---------------------------------------------------------------------------

def prover_checkpoint_arrays(scheme, channel):
    """(meta dict, {name: numpy uint32 array}) snapshot of a
    CommitmentSchemeProver with N committed trees + the channel state.
    Under a mesh every rank must call it: the sharded evaluations and
    Merkle layers are gathered to whole arrays."""
    from .parallel.ops import gather_points
    from .utils import to_host, to_numpy_u32

    mesh = scheme.mesh

    meta: Dict[str, Any] = {
        "channel": channel_state_to_dict(channel),
        "config": {
            "pow_bits": scheme.config.pow_bits,
            "fri": [scheme.config.fri_config.log_last_layer_degree_bound,
                    scheme.config.fri_config.log_blowup_factor,
                    scheme.config.fri_config.n_queries],
        },
        # the flavour and the mesh are recorded so that a load cannot
        # rebuild the wrong Merkle prover class
        "merkle_flavor": scheme.merkle_ops.name,
        "mesh": mesh is not None,
        "trees": [],
    }
    arrays: Dict[str, Any] = {}
    for ti, tree in enumerate(scheme.trees):
        tmeta = {"poly_logs": [p.log_size() for p in tree.polynomials],
                 "eval_logs": [ev.domain.log_size()
                               for ev in tree.evaluations],
                 "n_layers": len(tree.commitment.layers)}
        meta["trees"].append(tmeta)
        for pi, poly in enumerate(tree.polynomials):
            arrays[f"t{ti}_p{pi}"] = to_numpy_u32(poly.coeffs)
        for ei, ev in enumerate(tree.evaluations):
            arrays[f"t{ti}_e{ei}"] = to_host(ev)
        for li, layer in enumerate(tree.commitment.layers):
            if mesh is not None and tree.commitment.sharded \
                    and li >= mesh.log_size:
                layer = gather_points(mesh, layer)
            arrays[f"t{ti}_l{li}"] = to_numpy_u32(layer)
    return meta, arrays


def save_prover_checkpoint(path: str, scheme, channel) -> None:
    """Write the snapshot to `path`.  Under a mesh every rank calls it,
    rank 0 writes, and no rank returns before the file is written."""
    import json

    import numpy as np

    meta, arrays = prover_checkpoint_arrays(scheme, channel)
    if scheme.mesh is None or scheme.mesh.rank == 0:
        np.savez_compressed(path, __meta__=json.dumps(meta), **arrays)
    if scheme.mesh is not None:
        scheme.mesh.barrier()


def load_prover_checkpoint(path: str, twiddles, device=None, mesh=None):
    """Restore (scheme, channel) on `device` (CUDA device 0 unless the
    caller names one, as `CommitmentSchemeProver`), or with `mesh` (parallel/)
    on the mesh's device with every column the mesh shards sliced to this
    rank's part; `twiddles` is the same TwiddleTree a fresh prove would
    precompute (deterministic from the domain sizes).

    The checkpoint records its Merkle flavour and whether it was saved
    from a mesh prove (the port's or the JAX package's).  The matching
    prover class is rebuilt; an unknown flavour is refused, and so is a
    mesh checkpoint without `mesh`."""
    import json

    import numpy as np

    from .circle import CanonicCoset
    from .parallel.merkle import ShardedMerkleProver
    from .pcs.prover import CommitmentSchemeProver, CommitmentTreeProver
    from .poly.circle_poly import CircleEvaluation, CirclePoly
    from .utils import to_torch_u32
    from .vcs.ops import MERKLE_OPS

    data = np.load(path)
    meta = json.loads(str(data["__meta__"]))
    channel = channel_state_from_dict(meta["channel"])
    cfg = PcsConfig(meta["config"]["pow_bits"],
                    FriConfig(*meta["config"]["fri"]))
    flavor = meta.get("merkle_flavor", "blake2s")
    if flavor not in MERKLE_OPS:
        raise ValueError(f"checkpoint has unsupported Merkle flavor "
                         f"{flavor!r}; known: {sorted(MERKLE_OPS)}")
    if meta.get("mesh", False) and mesh is None:
        raise ValueError(
            "checkpoint was saved from a mesh-sharded prove; pass a "
            "parallel.Mesh to load_prover_checkpoint(mesh=...)")
    merkle_ops = MERKLE_OPS[flavor]
    scheme = CommitmentSchemeProver(cfg, twiddles, device=device,
                                    merkle_ops=merkle_ops, mesh=mesh)

    def tensor(name, sliced=False):
        """The array `name` on the scheme's device, or this rank's slice
        of its last axis."""
        arr = data[name]
        if sliced:
            start, stop = mesh.local_range(arr.shape[-1])
            arr = arr[..., start:stop]
        return to_torch_u32(arr, scheme.device)

    for ti, tmeta in enumerate(meta["trees"]):
        tree = CommitmentTreeProver.__new__(CommitmentTreeProver)
        tree.polynomials = [CirclePoly(tensor(f"t{ti}_p{pi}"))
                            for pi in range(len(tmeta["poly_logs"]))]
        logs = tmeta["eval_logs"]
        shards = [mesh is not None and mesh.shards(log) for log in logs]
        tree.evaluations = [
            CircleEvaluation(CanonicCoset.new(log).circle_domain(),
                             tensor(f"t{ti}_e{ei}", shards[ei]),
                             mesh if shards[ei] else None)
            for ei, log in enumerate(logs)]
        n_layers = tmeta["n_layers"]
        if mesh is None:
            tree.commitment = merkle_ops.prover_cls()(
                [tensor(f"t{ti}_l{li}") for li in range(n_layers)])
        else:
            # a sharded tree's layers from log k = mesh.log_size down to
            # the leaves are the rank's subtree slices (parallel/merkle.py)
            sharded = any(shards)
            tree.commitment = ShardedMerkleProver(mesh, [
                tensor(f"t{ti}_l{li}", sharded and li >= mesh.log_size)
                for li in range(n_layers)], sharded, merkle_ops)
        scheme.trees.append(tree)
    return scheme, channel
