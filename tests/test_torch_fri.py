"""FRI parity of the PyTorch port (tolerance 0).

The port's plain deinterleave (the CPU path, and the version its CUDA
kernel csrc/deinterleave.cu is held against on the card) must equal the
JAX Pallas kernel in interpret mode; the folds, the decomposition, the
DEEP quotients and a whole FRI proof must equal the JAX package's.
"""
import numpy as np
import pytest

import jax.numpy as jnp

from tstwo_tpu import fri as jax_fri
from tstwo_tpu.channel.blake2s import Blake2sChannel as JaxChannel
from tstwo_tpu.circle import CanonicCoset as JaxCanonicCoset
from tstwo_tpu.circle import CirclePoint as JaxCirclePoint
from tstwo_tpu.fields import QM31 as JaxQM31
from tstwo_tpu.ops import fri_ops as jax_fri_ops
from tstwo_tpu.ops import qm31 as jax_qm31
from tstwo_tpu.ops.pallas.interleave import deinterleave_pallas
from tstwo_tpu.pcs import quotients as jax_quotients
from tstwo_tpu.poly.circle_poly import CircleEvaluation as JaxCircleEvaluation
from tstwo_tpu.poly.circle_poly import SecureCirclePoly as JaxSecureCirclePoly
from tstwo_tpu.poly.twiddles import precompute_twiddles as jax_twiddles
from tstwo_tpu.queries import Queries as JaxQueries
from tstwo_tpu.serialize import fri_layer_to_dict as jax_layer_to_dict
from tstwo_tpu_torch import fri
from tstwo_tpu_torch.channel.blake2s import Blake2sChannel
from tstwo_tpu_torch.circle import CanonicCoset, CirclePoint
from tstwo_tpu_torch.fields import QM31
from tstwo_tpu_torch.ops import fri_ops, qm31
from tstwo_tpu_torch.pcs import quotients
from tstwo_tpu_torch.poly.circle_poly import CircleEvaluation, SecureCirclePoly
from tstwo_tpu_torch.poly.twiddles import precompute_twiddles
from tstwo_tpu_torch.queries import Queries
from tstwo_tpu_torch.serialize import fri_layer_to_dict
from tstwo_tpu_torch.utils import to_numpy_u32, to_torch_u32
from tstwo_tpu_torch.vcs.ops import Blake2sMerkleOps

P = (1 << 31) - 1
ALPHA = [123456789, 987654321, P - 1, 42]


def _values(seed, shape):
    return np.random.default_rng(seed).integers(0, P, size=shape,
                                                dtype=np.uint32)


def test_plain_deinterleave_matches_pallas():
    x = _values(1, (4, 1 << 13))
    even, odd = fri_ops._deinterleave(to_torch_u32(x))
    jeven, jodd = deinterleave_pallas(jnp.asarray(x), interpret=True)
    np.testing.assert_array_equal(to_numpy_u32(even), np.asarray(jeven))
    np.testing.assert_array_equal(to_numpy_u32(odd), np.asarray(jodd))


def test_cuda_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        fri_ops.deinterleave_cuda(to_torch_u32(_values(2, (2, 8))))


@pytest.mark.parametrize("log_n", [1, 6, 11])
def test_fold_line_matches_jax(log_n):
    vals = _values(10 + log_n, (4, 1 << log_n))
    itw = _values(20 + log_n, 1 << (log_n - 1))
    alpha = np.array(ALPHA, np.uint32)
    got = fri_ops.fold_line(to_torch_u32(vals), to_torch_u32(itw),
                            to_torch_u32(alpha))
    want = jax_fri_ops.fold_line(jnp.asarray(vals), jnp.asarray(itw),
                                 jnp.asarray(alpha))
    np.testing.assert_array_equal(to_numpy_u32(got), np.asarray(want))


@pytest.mark.parametrize("log_n", [2, 7, 12])
def test_fold_circle_into_line_matches_jax(log_n):
    domain = CanonicCoset.new(log_n).circle_domain()
    jdomain = JaxCanonicCoset.new(log_n).circle_domain()
    src = _values(30 + log_n, (4, 1 << log_n))
    dst = _values(40 + log_n, (4, 1 << (log_n - 1)))
    alpha = np.array(ALPHA, np.uint32)
    ytw = fri_ops.domain_y_itwiddles(domain, "cpu")
    np.testing.assert_array_equal(
        to_numpy_u32(ytw), np.asarray(jax_fri_ops.domain_y_itwiddles(jdomain)))
    got = fri_ops.fold_circle_into_line(to_torch_u32(dst), to_torch_u32(src),
                                        ytw, to_torch_u32(alpha))
    want = jax_fri_ops.fold_circle_into_line(
        jnp.asarray(dst), jnp.asarray(src),
        jax_fri_ops.domain_y_itwiddles(jdomain), jnp.asarray(alpha))
    np.testing.assert_array_equal(to_numpy_u32(got), np.asarray(want))


def test_decompose_matches_jax():
    vals = _values(50, (4, 1 << 9))
    g, lam = fri_ops.decompose(to_torch_u32(vals))
    jg, jlam = jax_fri_ops.decompose(jnp.asarray(vals))
    np.testing.assert_array_equal(to_numpy_u32(g), np.asarray(jg))
    np.testing.assert_array_equal(to_numpy_u32(lam), np.asarray(jlam))


def _oods_point(pkg_point, pkg_qm31, seed):
    """A QM31 circle point off the trace domain: (2t, 1 - t^2) / (1 + t^2)."""
    t = pkg_qm31.from_ints(_values(seed, 4).tolist())
    one = pkg_qm31.one()
    den = (one + t * t).inverse()
    return pkg_point((t + t) * den, (one - t * t) * den)


def test_compute_fri_quotients_matches_jax():
    # two column sizes, each sampled at two points (a mask shift and OODS)
    rng_cols = [(9, 0), (9, 1), (8, 2)]
    ours, theirs, our_samples, their_samples = [], [], [], []
    points = [_oods_point(CirclePoint, QM31, s) for s in (60, 61)]
    jpoints = [_oods_point(JaxCirclePoint, JaxQM31, s) for s in (60, 61)]
    for log_size, seed in rng_cols:
        vals = _values(70 + seed, 1 << log_size)
        ours.append(CircleEvaluation(
            CanonicCoset.new(log_size).circle_domain(), to_torch_u32(vals)))
        theirs.append(JaxCircleEvaluation(
            JaxCanonicCoset.new(log_size).circle_domain(), jnp.asarray(vals)))
        svals = [_values(80 + seed + 10 * k, 4).tolist() for k in range(2)]
        our_samples.append([quotients.PointSample(p, QM31.from_ints(v))
                            for p, v in zip(points, svals)])
        their_samples.append([jax_quotients.PointSample(p, JaxQM31.from_ints(v))
                              for p, v in zip(jpoints, svals)])
    coeff = _values(90, 4).tolist()
    got = quotients.compute_fri_quotients(ours, our_samples,
                                          QM31.from_ints(coeff), 1)
    want = jax_quotients.compute_fri_quotients(theirs, their_samples,
                                               JaxQM31.from_ints(coeff), 1)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.domain.log_size() == w.domain.log_size()
        np.testing.assert_array_equal(to_numpy_u32(g.values),
                                      np.asarray(w.values))


def _secure_eval(pkg_poly, pkg_coset, coeffs, log_domain, asarray):
    domain = pkg_coset.new(log_domain).circle_domain()
    return pkg_poly(asarray(coeffs)).evaluate(domain)


def test_commit_host_proof_matches_jax_fused_commit():
    """The port's host-transcript FRI commit == the JAX fused commit."""
    config = fri.FriConfig(1, 1, 3)
    jconfig = jax_fri.FriConfig(1, 1, 3)
    log_degrees = [8, 7]
    coeffs = [_values(100 + d, (4, 1 << d)) for d in log_degrees]
    ours = [_secure_eval(SecureCirclePoly, CanonicCoset, c, d + 1,
                         to_torch_u32) for c, d in zip(coeffs, log_degrees)]
    theirs = [_secure_eval(JaxSecureCirclePoly, JaxCanonicCoset, c, d + 1,
                           jnp.asarray) for c, d in zip(coeffs, log_degrees)]
    tree = precompute_twiddles(ours[0].domain.half_coset)
    jtree = jax_twiddles(theirs[0].domain.half_coset)
    ch, jch = Blake2sChannel(), JaxChannel()
    prover = fri.FriProver.commit_host(ch, config, ours, tree)
    jprover = jax_fri.FriProver.commit(jch, jconfig, theirs, jtree)
    assert ch.digest == jch.digest
    positions = [1, 77, 300, 511]
    proof = prover.decommit_on_queries(Queries.from_positions(positions, 9))
    jproof = jprover.decommit_on_queries(JaxQueries.from_positions(positions, 9))
    assert fri_layer_to_dict(proof.first_layer) == \
        jax_layer_to_dict(jproof.first_layer)
    assert [fri_layer_to_dict(l) for l in proof.inner_layers] == \
        [jax_layer_to_dict(l) for l in jproof.inner_layers]
    assert [c.to_ints() for c in proof.last_layer_poly.coeffs] == \
        [c.to_ints() for c in jproof.last_layer_poly.coeffs]
    # and the port's verifier accepts it
    verifier = fri.FriVerifier.commit(
        Blake2sChannel(), config, proof,
        [fri.CirclePolyDegreeBound(d) for d in log_degrees])
    queries = Queries.from_positions(positions, 9)
    evals = []
    for se in ours:
        q = queries.fold(queries.log_domain_size - se.domain.log_size())
        evals.append([se.at(p) for p in q.positions])
    verifier.decommit_on_queries(queries, evals)


def _commit_inputs(log_degrees, seed):
    coeffs = [_values(seed + d, (4, 1 << d)) for d in log_degrees]
    ours = [_secure_eval(SecureCirclePoly, CanonicCoset, c, d + 1,
                         to_torch_u32) for c, d in zip(coeffs, log_degrees)]
    theirs = [_secure_eval(JaxSecureCirclePoly, JaxCanonicCoset, c, d + 1,
                           jnp.asarray) for c, d in zip(coeffs, log_degrees)]
    return (ours, precompute_twiddles(ours[0].domain.half_coset), theirs,
            jax_twiddles(theirs[0].domain.half_coset))


def _layer_state(prover):
    """Roots, every inner layer's values and the last-layer poly."""
    return ([prover.first_layer.merkle_tree.root()]
            + [l.merkle_tree.root() for l in prover.inner_layers],
            [np.asarray(to_numpy_u32(l.evaluation.values)
                        if hasattr(l.evaluation.values, "numpy")
                        else l.evaluation.values).tolist()
             for l in prover.inner_layers],
            [c.to_ints() for c in prover.last_layer_poly.coeffs])


@pytest.mark.parametrize("log_degrees,last_bound,start", [
    ([8, 7], 1, None), ([7, 6, 4], 0, (bytes(32), 238_210_100)),
    ([9], 2, (bytes(range(32)), 5))])
def test_commit_matches_jax_commit_and_commit_host(log_degrees, last_bound,
                                                   start):
    """The port's device-transcript commit == its host-transcript commit ==
    the JAX package's commit: channel digest and ChannelTime, every root,
    the inner-layer values, the last-layer poly and the decommitment on
    fixed queries, from channels with draws and mixes behind them."""
    from tstwo_tpu.channel import ChannelTime as JaxChannelTime
    from tstwo_tpu_torch.channel import ChannelTime

    config = fri.FriConfig(last_bound, 1, 3)
    jconfig = jax_fri.FriConfig(last_bound, 1, 3)
    ours, tree, theirs, jtree = _commit_inputs(log_degrees, 200)
    digest, n_sent = start or (bytes(32), 0)
    ch = Blake2sChannel(digest, ChannelTime(1, n_sent))
    host_ch = Blake2sChannel(digest, ChannelTime(1, n_sent))
    jch = JaxChannel(digest, JaxChannelTime(1, n_sent))
    prover = fri.FriProver.commit(ch, config, ours, tree)
    host = fri.FriProver.commit_host(host_ch, config, ours, tree)
    jprover = jax_fri.FriProver.commit(jch, jconfig, theirs, jtree)
    assert ch == host_ch
    assert ch.digest == jch.digest
    assert (ch.channel_time.n_challenges, ch.channel_time.n_sent) == (
        jch.channel_time.n_challenges, jch.channel_time.n_sent)
    assert _layer_state(prover) == _layer_state(host) == _layer_state(jprover)
    log = log_degrees[0] + 1
    positions = [0, 3, (1 << log) // 3, (1 << log) - 1]
    proof = prover.decommit_on_queries(Queries.from_positions(positions, log))
    want = host.decommit_on_queries(Queries.from_positions(positions, log))
    jproof = jprover.decommit_on_queries(
        JaxQueries.from_positions(positions, log))
    for got in (proof, want):
        assert fri_layer_to_dict(got.first_layer) == \
            jax_layer_to_dict(jproof.first_layer)
        assert [fri_layer_to_dict(l) for l in got.inner_layers] == \
            [jax_layer_to_dict(l) for l in jproof.inner_layers]


def test_commit_fetches_every_root_with_the_state():
    """`commit` brings the roots to the host in its one fetch: decommit
    reads no root from the device afterwards."""
    ours, tree, _, _ = _commit_inputs([6], 300)
    prover = fri.FriProver.commit(Blake2sChannel(), fri.FriConfig(0, 1, 3),
                                  ours, tree)
    trees = [prover.first_layer.merkle_tree] + [
        l.merkle_tree for l in prover.inner_layers]
    assert all(t._root is not None for t in trees)
    assert [t._root for t in trees] == [
        t.digest(to_numpy_u32(t.layers[0][:, 0])) for t in trees]


def test_commit_dispatch_leaves_the_channel_until_finish():
    ours, tree, _, _ = _commit_inputs([6], 400)
    ch = Blake2sChannel()
    finish = fri.FriProver.commit_dispatch(ch, fri.FriConfig(0, 1, 3), ours,
                                           tree)
    assert ch == Blake2sChannel()
    finish()
    host_ch = Blake2sChannel()
    fri.FriProver.commit_host(host_ch, fri.FriConfig(0, 1, 3), ours, tree)
    assert ch == host_ch


def test_commit_of_a_logging_channel_raises_as_jax_does():
    """The reference's commit reads `channel_time`, which its
    LoggingChannel lacks: both packages raise the same AttributeError."""
    from tstwo_tpu.channel.logging import LoggingChannel as JaxLogging
    from tstwo_tpu_torch.channel.logging import LoggingChannel

    ours, tree, theirs, jtree = _commit_inputs([5], 500)
    with pytest.raises(AttributeError, match="channel_time"):
        fri.FriProver.commit(LoggingChannel(Blake2sChannel()),
                             fri.FriConfig(0, 1, 3), ours, tree)
    with pytest.raises(AttributeError, match="channel_time"):
        jax_fri.FriProver.commit(JaxLogging(JaxChannel()),
                                 jax_fri.FriConfig(0, 1, 3), theirs, jtree)


def test_poseidon_flavour_commit_takes_the_host_transcript(monkeypatch):
    """A flavour without `fused_fri_transcript` goes to `commit_host`, as
    tstwo_tpu/fri.py:430 does (the Poseidon252 proof tests then run the
    whole path)."""
    from tstwo_tpu_torch.vcs.ops import Poseidon252MerkleOps

    assert not Poseidon252MerkleOps.fused_fri_transcript
    assert Blake2sMerkleOps.fused_fri_transcript
    calls = []

    def host(*args):
        calls.append(args)
        return "host"

    monkeypatch.setattr(fri.FriProver, "commit_host", staticmethod(host))
    ours, tree, _, _ = _commit_inputs([4], 600)
    config = fri.FriConfig(0, 1, 3)
    assert fri.FriProver.commit("ch", config, ours, tree,
                                merkle_ops=Poseidon252MerkleOps) == "host"
    assert calls == [("ch", config, ours, tree, Poseidon252MerkleOps, None)]


def test_qm31_scalar_is_a_broadcastable_column():
    a = qm31.scalar(QM31.from_ints([1, 2, 3, 4]), (5,), "cpu")
    assert tuple(a.shape) == (4, 5)
    np.testing.assert_array_equal(to_numpy_u32(a[:, 3]), [1, 2, 3, 4])
    np.testing.assert_array_equal(
        to_numpy_u32(qm31.scalar(QM31.from_ints([1, 2, 3, 4]), device="cpu")),
        np.asarray(jax_qm31.scalar(JaxQM31.from_ints([1, 2, 3, 4]))))
