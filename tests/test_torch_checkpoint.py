"""Mid-prove checkpoints of the PyTorch port (tolerance 0: proof bytes).

Mirrors tests/test_serialize.py::test_mid_prove_checkpoint_resume in the
port (save after the commit phase, load, finish: the same bytes as an
uninterrupted prove), then crosses packages: a checkpoint the JAX package
saved resumes in the port to the JAX proof's bytes, and one the port saved
resumes in the JAX package.  Last, the two refusals of a load, and the
fault both packages share: neither saves a Poseidon252 prove.
"""
import json

import numpy as np
import pytest

from tstwo_tpu.channel.blake2s import Blake2sChannel as JaxChannel
from tstwo_tpu.circle import CanonicCoset as JaxCoset
from tstwo_tpu.constraint_framework import FrameworkComponent as JaxComponent
from tstwo_tpu.constraint_framework import \
    TraceLocationAllocator as JaxAllocator
from tstwo_tpu.examples import basic_air as jax_air
from tstwo_tpu.fields import QM31 as JaxQM31
from tstwo_tpu.pcs import PcsConfig as JaxPcsConfig
from tstwo_tpu.pcs.prover import CommitmentSchemeProver as JaxScheme
from tstwo_tpu.poly.circle_poly import CircleEvaluation as JaxEvaluation
from tstwo_tpu.poly.twiddles import precompute_twiddles as jax_twiddles
from tstwo_tpu.prover import prove as jax_prove
from tstwo_tpu.serialize import load_prover_checkpoint as jax_load
from tstwo_tpu.serialize import proof_to_dict as jax_to_dict
from tstwo_tpu.serialize import save_prover_checkpoint as jax_save
from tstwo_tpu_torch.channel.blake2s import Blake2sChannel
from tstwo_tpu_torch.circle import CanonicCoset
from tstwo_tpu_torch.constraint_framework import (FrameworkComponent,
                                                  TraceLocationAllocator)
from tstwo_tpu_torch.examples.basic_air import CONSTRAINT_EVAL_BLOWUP_FACTOR
from tstwo_tpu_torch.examples.basic_air import TestEval as BasicAirEval
from tstwo_tpu_torch.examples.basic_air import generate_trace
from tstwo_tpu_torch.fields import QM31
from tstwo_tpu_torch.pcs import PcsConfig
from tstwo_tpu_torch.pcs.prover import CommitmentSchemeProver
from tstwo_tpu_torch.poly.circle_poly import CircleEvaluation
from tstwo_tpu_torch.poly.twiddles import precompute_twiddles
from tstwo_tpu_torch.prover import prove
from tstwo_tpu_torch.serialize import (load_prover_checkpoint,
                                       prover_checkpoint_arrays,
                                       proof_to_dict, save_prover_checkpoint)

LOG_N = 4


def _twiddle_log(config) -> int:
    return (LOG_N + CONSTRAINT_EVAL_BLOWUP_FACTOR
            + config.fri_config.log_blowup_factor)


def _commit(scheme, channel, trace) -> None:
    """The commit phase of the basic AIR: an empty preprocessed tree, the
    size, the trace."""
    tb = scheme.tree_builder()
    tb.extend_evals([])
    tb.commit(channel)
    channel.mix_u64(LOG_N)
    tb = scheme.tree_builder()
    tb.extend_evals(trace)
    tb.commit(channel)


@pytest.fixture(scope="module")
def port():
    config = PcsConfig()
    domain = CanonicCoset.new(LOG_N).circle_domain()
    trace = [CircleEvaluation(domain, c)
             for c in generate_trace(LOG_N, device="cpu")]
    twiddles = precompute_twiddles(
        CanonicCoset.new(_twiddle_log(config)).circle_domain().half_coset)

    def committed():
        channel = Blake2sChannel()
        scheme = CommitmentSchemeProver(config, twiddles, "cpu")
        _commit(scheme, channel, trace)
        return scheme, channel

    def finish(scheme, channel) -> str:
        component = FrameworkComponent(TraceLocationAllocator(),
                                       BasicAirEval(LOG_N), QM31.zero())
        return json.dumps(proof_to_dict(prove([component], channel, scheme)),
                          sort_keys=True)

    return committed, finish, twiddles


@pytest.fixture(scope="module")
def jax():
    config = JaxPcsConfig()
    domain = JaxCoset.new(LOG_N).circle_domain()
    trace = [JaxEvaluation(domain, c) for c in jax_air.generate_trace(LOG_N)]
    twiddles = jax_twiddles(
        JaxCoset.new(_twiddle_log(config)).circle_domain().half_coset)

    def committed():
        channel = JaxChannel()
        scheme = JaxScheme(config, twiddles)
        _commit(scheme, channel, trace)
        return scheme, channel

    def finish(scheme, channel) -> str:
        component = JaxComponent(JaxAllocator(), jax_air.TestEval(LOG_N),
                                 JaxQM31.zero())
        return json.dumps(jax_to_dict(jax_prove([component], channel,
                                                scheme)), sort_keys=True)

    return committed, finish, twiddles


def test_mid_prove_checkpoint_resume(tmp_path, port):
    committed, finish, twiddles = port
    straight = finish(*committed())
    path = str(tmp_path / "ckpt.npz")
    save_prover_checkpoint(path, *committed())
    scheme, channel = load_prover_checkpoint(path, twiddles, device="cpu")
    assert scheme.device.type == "cpu" and len(scheme.trees) == 2
    assert finish(scheme, channel) == straight


def test_checkpoint_arrays_equal_the_jax_package(port, jax):
    from tstwo_tpu.serialize import prover_checkpoint_arrays as jax_arrays

    meta, arrays = prover_checkpoint_arrays(*port[0]())
    jax_meta, jax_arrays_ = jax_arrays(*jax[0]())
    assert meta == jax_meta
    assert sorted(arrays) == sorted(jax_arrays_)
    for name, a in arrays.items():
        assert a.dtype == np.uint32, name
        np.testing.assert_array_equal(a, np.asarray(jax_arrays_[name]))


def test_jax_checkpoint_resumes_in_the_port(tmp_path, port, jax):
    path = str(tmp_path / "jax_ckpt.npz")
    jax_save(path, *jax[0]())
    want = jax[1](*jax[0]())
    scheme, channel = load_prover_checkpoint(path, port[2], device="cpu")
    assert port[1](scheme, channel) == want


def test_port_checkpoint_resumes_in_the_jax_package(tmp_path, port, jax):
    path = str(tmp_path / "port_ckpt.npz")
    save_prover_checkpoint(path, *port[0]())
    scheme, channel = jax_load(path, jax[2])
    assert jax[1](scheme, channel) == port[1](*port[0]())


def _rewritten(tmp_path, port, **changes) -> str:
    """A checkpoint of the port with `changes` in its meta."""
    meta, arrays = prover_checkpoint_arrays(*port[0]())
    meta.update(changes)
    path = str(tmp_path / "changed.npz")
    np.savez_compressed(path, __meta__=json.dumps(meta), **arrays)
    return path


def test_load_refuses_an_unknown_merkle_flavor(tmp_path, port):
    path = _rewritten(tmp_path, port, merkle_flavor="sha3")
    with pytest.raises(ValueError, match="unsupported Merkle flavor"):
        load_prover_checkpoint(path, port[2], device="cpu")


def test_load_refuses_a_mesh_checkpoint(tmp_path, port):
    path = _rewritten(tmp_path, port, mesh=True)
    with pytest.raises(ValueError, match="mesh-sharded"):
        load_prover_checkpoint(path, port[2], device="cpu")


def test_saving_a_poseidon252_prove_fails_alike_in_both_packages(tmp_path):
    """A matched fault of the reference: `channel_state_to_dict` writes the
    channel's digest with `.hex()`, which a Poseidon252 channel's
    FieldElement252 digest lacks, so neither package saves a Poseidon252
    prove.  Both raise the same error and write no file."""
    from tstwo_tpu.channel.poseidon import Poseidon252Channel as JaxPosChannel
    from tstwo_tpu.vcs.ops import Poseidon252MerkleOps as JaxPosOps
    from tstwo_tpu_torch.channel.poseidon import Poseidon252Channel
    from tstwo_tpu_torch.vcs.ops import Poseidon252MerkleOps

    errors = []
    for scheme, channel, save in (
            (JaxScheme(JaxPcsConfig(), None, merkle_ops=JaxPosOps),
             JaxPosChannel(), jax_save),
            (CommitmentSchemeProver(PcsConfig(), None, device="cpu",
                                    merkle_ops=Poseidon252MerkleOps),
             Poseidon252Channel(), save_prover_checkpoint)):
        channel.mix_u64(4)
        path = tmp_path / f"{len(errors)}.npz"
        with pytest.raises(AttributeError) as err:
            save(str(path), scheme, channel)
        assert not path.exists()
        errors.append(str(err.value))
    assert errors[0] == errors[1]
    assert "'FieldElement252' object has no attribute 'hex'" in errors[0]
