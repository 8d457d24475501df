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
    ytw = fri_ops.domain_y_itwiddles(domain)
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


def test_qm31_scalar_is_a_broadcastable_column():
    a = qm31.scalar(QM31.from_ints([1, 2, 3, 4]), (5,))
    assert tuple(a.shape) == (4, 5)
    np.testing.assert_array_equal(to_numpy_u32(a[:, 3]), [1, 2, 3, 4])
    np.testing.assert_array_equal(
        to_numpy_u32(qm31.scalar(QM31.from_ints([1, 2, 3, 4]))),
        np.asarray(jax_qm31.scalar(JaxQM31.from_ints([1, 2, 3, 4]))))
