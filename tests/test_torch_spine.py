"""Host-spine parity of the PyTorch port with the JAX package.

The modules copied with their jax lines removed (queries, constraints,
poly/utils, air/mask, the Merkle flavour, tracing) must behave as the
JAX package's do, including the reference's known poly/utils.fold fault,
which the port matches rather than fixes.
"""
import numpy as np
import pytest

from tstwo_tpu import constraints as jax_constraints
from tstwo_tpu.air import mask as jax_mask
from tstwo_tpu.channel.blake2s import Blake2sChannel as JaxChannel
from tstwo_tpu.circle import CanonicCoset as JaxCanonicCoset
from tstwo_tpu.circle import CirclePoint as JaxCirclePoint
from tstwo_tpu.fields import M31 as JaxM31
from tstwo_tpu.fields import QM31 as JaxQM31
from tstwo_tpu.poly import utils as jax_poly_utils
from tstwo_tpu.queries import Queries as JaxQueries
from tstwo_tpu.vcs.blake2s_merkle import hash_node as jax_hash_node
from tstwo_tpu_torch import constraints, tracing
from tstwo_tpu_torch.air import mask
from tstwo_tpu_torch.channel.blake2s import Blake2sChannel
from tstwo_tpu_torch.circle import CanonicCoset, CirclePoint
from tstwo_tpu_torch.fields import M31, QM31
from tstwo_tpu_torch.pcs import quotients
from tstwo_tpu_torch.poly import utils as poly_utils
from tstwo_tpu_torch.queries import Queries
from tstwo_tpu_torch.utils import to_numpy_u32, to_torch_u32
from tstwo_tpu_torch.vcs import MerkleProver
from tstwo_tpu_torch.vcs.ops import MERKLE_OPS

P = (1 << 31) - 1


def test_queries_generate_matches_jax():
    ours, theirs = Blake2sChannel(), JaxChannel()
    ours.mix_u64(7)
    theirs.mix_u64(7)
    q = Queries.generate(ours, 12, 20)
    jq = JaxQueries.generate(theirs, 12, 20)
    assert q.positions == jq.positions
    assert q.fold(3).positions == jq.fold(3).positions


@pytest.mark.parametrize("trace_log,eval_log", [(3, 4), (6, 8)])
def test_vanishing_denominator_inverses_match_jax(trace_log, eval_log):
    np.testing.assert_array_equal(
        constraints.coset_vanishing_denominator_inverses_bitrev(trace_log,
                                                                eval_log),
        jax_constraints.coset_vanishing_denominator_inverses_bitrev(trace_log,
                                                                    eval_log))


def test_poly_utils_fold_matches_jax_including_its_fault():
    vals = [3, 5, 7, 11]
    factors = [13, 17]
    got = poly_utils.fold([M31(v) for v in vals], [M31(f) for f in factors])
    want = jax_poly_utils.fold([JaxM31(v) for v in vals],
                               [JaxM31(f) for f in factors])
    assert got.value == want.value
    assert poly_utils.repeat_value([1, 2], 3) == \
        jax_poly_utils.repeat_value([1, 2], 3)
    # M31 values with QM31 factors fail in the reference; the port matches
    with pytest.raises(AttributeError):
        jax_poly_utils.fold([JaxM31(1), JaxM31(2)],
                            [JaxQM31.from_ints([1, 2, 3, 4])])
    with pytest.raises(AttributeError):
        poly_utils.fold([M31(1), M31(2)], [QM31.from_ints([1, 2, 3, 4])])


def test_shifted_mask_points_match_jax():
    point = CirclePoint.get_random_point(Blake2sChannel())
    jpoint = JaxCirclePoint.get_random_point(JaxChannel())
    pts = mask.shifted_mask_points([[0, 1], [2]], [CanonicCoset.new(4)] * 2,
                                   point)
    jpts = jax_mask.shifted_mask_points([[0, 1], [2]],
                                        [JaxCanonicCoset.new(4)] * 2, jpoint)
    assert [[(p.x.to_ints(), p.y.to_ints()) for p in col] for col in pts] == \
        [[(p.x.to_ints(), p.y.to_ints()) for p in col] for col in jpts]
    assert mask.fixed_mask_points([[0], [0, 0]], point) == \
        [[point], [point, point]]


def test_blake2s_merkle_flavour():
    ops = MERKLE_OPS["blake2s"]
    cols = [to_torch_u32(np.arange(16, dtype=np.uint32) * 3)]
    assert ops.commit(cols).root() == MerkleProver.commit(cols).root()
    children = (b"\x01" * 32, b"\x02" * 32)
    assert ops.hash_node(children, [M31(5), M31(P - 1)]) == \
        jax_hash_node(children, [JaxM31(5), JaxM31(P - 1)])
    assert isinstance(ops.default_channel(), Blake2sChannel)


def test_row_quotients_match_the_host_scalar_reference():
    """The tensor accumulation (prover and verifier) against the per-row
    host scalar recipe of reference backend/cpu/quotients.ts."""
    rng = np.random.default_rng(5)
    domain = CanonicCoset.new(5).circle_domain()
    cols = rng.integers(0, P, size=(3, 32), dtype=np.uint32)
    point = CirclePoint.get_random_point(Blake2sChannel())
    samples = [[quotients.PointSample(point, QM31.from_ints(
        rng.integers(0, P, size=4).tolist()))] for _ in range(3)]
    batches = quotients.ColumnSampleBatch.new_vec(samples)
    coeff = QM31.from_ints([9, 8, 7, 6])
    xs, ys = quotients.domain_points_bitrev(domain, "cpu")
    got = to_numpy_u32(quotients._accumulate_rows(to_torch_u32(cols), xs, ys,
                                                  batches, coeff))
    consts = quotients.quotient_constants(batches, coeff)
    for row in (0, 7, 31):
        p = CirclePoint(M31(int(xs[row])), M31(int(ys[row])))
        want = quotients.accumulate_row_quotients(
            batches, [M31(int(c)) for c in cols[:, row]], consts, p)
        assert got[:, row].tolist() == list(want.to_ints())


def test_tracing_spans_record_only_when_enabled():
    tracing.reset()
    with tracing.span("off"):
        pass
    assert tracing.totals() == {}
    tracing.enable()
    try:
        with tracing.span("on"):
            pass
    finally:
        tracing.disable()
    assert set(tracing.totals()) == {"on"}
    tracing.reset()
