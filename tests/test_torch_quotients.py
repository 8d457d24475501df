"""The DEEP quotients' host side and plain version against the JAX package
and the per-row host recipe: the constants packed in numpy for
csrc/quotients.cu, the domain points made as the kernel makes them, the
plain accumulation and the verifier's `fri_answers`.  The kernel itself
is held to the plain version on the card (tests/test_torch_cuda.py)."""
import numpy as np
import pytest
import torch

from tstwo_tpu.circle import CanonicCoset as JaxCanonicCoset
from tstwo_tpu.circle import CirclePoint as JaxCirclePoint
from tstwo_tpu.fields import M31 as JaxM31
from tstwo_tpu.fields import QM31 as JaxQM31
from tstwo_tpu.pcs import quotients as jax_quotients
from tstwo_tpu_torch import kernels
from tstwo_tpu_torch.channel.blake2s import Blake2sChannel
from tstwo_tpu_torch.circle import CanonicCoset, CirclePoint
from tstwo_tpu_torch.fields import CM31, M31, QM31
from tstwo_tpu_torch.pcs import quotients
from tstwo_tpu_torch.utils import to_numpy_u32, to_torch_u32

P = (1 << 31) - 1


def _qm31(rng):
    return QM31.from_ints(rng.integers(0, P, size=4).tolist())


def _two_points(log_size):
    """z and z - g, g the trace domain's step: the points of a column
    sampled at mask offsets 0 and -1 (Poseidon2's interaction)."""
    z = CirclePoint.get_random_point(Blake2sChannel())
    g = CanonicCoset.new(log_size).step().into_ef(QM31.from_base)
    return z, z - g


def _batches(rng, n_cols, log_size, shuffle):
    """Every column sampled at z, every third also at z - g; with
    `shuffle`, each batch lists its columns out of index order."""
    z, zg = _two_points(log_size)
    samples = []
    for i in range(n_cols):
        s = [quotients.PointSample(z, _qm31(rng))]
        if i % 3 == 0:
            s.append(quotients.PointSample(zg, _qm31(rng)))
        samples.append(s)
    batches = quotients.ColumnSampleBatch.new_vec(samples)
    if shuffle:
        for b in batches:
            order = rng.permutation(len(b.columns_and_values))
            b.columns_and_values = [b.columns_and_values[i] for i in order]
    return batches


@pytest.mark.parametrize("seed,n_cols,shuffle", [
    (0, 1, False), (1, 7, False), (2, 7, True), (3, 40, True)])
def test_packed_constants_sum_the_line_coefficients(seed, n_cols, shuffle):
    """c alpha^j is each column's c_j; A, B the sums of its a_j, b_j;
    alpha^k the batch's coefficient (`quotient_constants`)."""
    rng = np.random.default_rng(seed)
    batches = _batches(rng, n_cols, 6, shuffle)
    alpha = _qm31(rng)
    pack = quotients.pack_quotient_constants(batches, alpha)
    want = quotients.quotient_constants(batches, alpha)
    assert pack.batches.shape == (len(batches), quotients.BATCH_WORDS)
    assert pack.offsets.tolist() == np.cumsum(
        [0] + [len(b.columns_and_values) for b in batches]).tolist()
    assert pack.columns.tolist() == [i for b in batches
                                     for i, _ in b.columns_and_values]

    def q(words):
        return QM31.from_ints([int(w) for w in words])

    def cm(words):
        return CM31(int(words[0]), int(words[1]))

    for b, (batch, coeffs) in enumerate(zip(batches, want.line_coeffs)):
        words = pack.batches[b]
        px, py = batch.point.x, batch.point.y
        assert cm(words[0:2]) == px.c0 * py.c1 - py.c0 * px.c1
        assert cm(words[2:4]) == -py.c1 and cm(words[4:6]) == px.c1
        c = py.complex_conjugate() - py
        assert c.c0 == CM31.zero() and cm(words[6:8]) == c.c1
        a_sum, b_sum = QM31.zero(), QM31.zero()
        for j, (a, bb, cc) in enumerate(coeffs):
            weight = q(pack.weights[pack.offsets[b] + j])
            assert weight == alpha.pow(j + 1)
            assert c * weight == cc
            a_sum, b_sum = a_sum + a, b_sum + bb
        assert q(words[8:12]) == a_sum and q(words[12:16]) == b_sum
        assert q(words[16:20]) == want.batch_random_coeffs[b]


@pytest.mark.parametrize("log_size", range(1, 23))
def test_kernel_points_are_the_bit_reversed_domain(log_size):
    """The points made from the initial point and the step multiples, as
    csrc/quotients.cu makes them, at every row, against the JAX package's
    bit-reversed domain; `domain_points_bitrev` uploads them."""
    domain = CanonicCoset.new(log_size).circle_domain()
    want = jax_quotients._domain_points_bitrev_np(
        domain.half_coset.initial_index.value, domain.half_coset.log_size)
    got = quotients.domain_points_plain(domain, 0, domain.size())
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    xs, ys = quotients.domain_points_bitrev(domain, "cpu")
    assert np.array_equal(to_numpy_u32(xs), want[0])
    assert np.array_equal(to_numpy_u32(ys), want[1])
    assert quotients._step_points(domain.half_coset.initial_index.value,
                                  log_size).shape == (max(log_size - 1, 1), 2)


@pytest.mark.parametrize("log_size,size", [
    (3, 2), (5, 2), (12, 2), (4, 4), (5, 4), (12, 4)])
def test_kernel_points_of_a_rank_slice(log_size, size):
    """A rank's slice (first row rank * n / D) made on its own equals that
    slice of the whole domain's points."""
    domain = CanonicCoset.new(log_size).circle_domain()
    xs, ys = jax_quotients._domain_points_bitrev_np(
        domain.half_coset.initial_index.value, domain.half_coset.log_size)
    m = domain.size() // size
    for rank in range(size):
        gx, gy = quotients.domain_points_plain(domain, rank * m, m)
        assert np.array_equal(gx, xs[rank * m:(rank + 1) * m])
        assert np.array_equal(gy, ys[rank * m:(rank + 1) * m])


def test_kernel_points_refuse_part_of_a_quad():
    domain = CanonicCoset.new(5).circle_domain()
    with pytest.raises(ValueError, match="quads"):
        quotients.domain_points_plain(domain, 2, 8)


@pytest.mark.parametrize("shuffle", [False, True])
def test_plain_rows_match_the_host_scalar_reference(shuffle):
    """Two points (z, z - g), batches out of index order: every row of the
    plain version against reference backend/cpu/quotients.ts's per-row
    recipe."""
    rng = np.random.default_rng(11)
    log_size = 5
    batches = _batches(rng, 7, log_size, shuffle)
    coeff = _qm31(rng)
    domain = CanonicCoset.new(log_size).circle_domain()
    cols = rng.integers(0, P, size=(7, 32), dtype=np.uint32)
    got = to_numpy_u32(quotients.accumulate_quotients(
        domain, list(to_torch_u32(cols)), coeff, batches, 1).values)
    consts = quotients.quotient_constants(batches, coeff)
    xs, ys = quotients.domain_points_bitrev(domain, "cpu")
    for row in range(32):
        p = CirclePoint(M31(int(xs[row])), M31(int(ys[row])))
        want = quotients.accumulate_row_quotients(
            batches, [M31(int(c)) for c in cols[:, row]], consts, p)
        assert got[:, row].tolist() == list(want.to_ints()), row


def _jax_point(p):
    return JaxCirclePoint(JaxQM31.from_ints(p.x.to_ints()),
                          JaxQM31.from_ints(p.y.to_ints()))


def _jax_batches(batches):
    return [jax_quotients.ColumnSampleBatch(
        _jax_point(b.point),
        [(i, JaxQM31.from_ints(v.to_ints())) for i, v in b.columns_and_values])
        for b in batches]


@pytest.mark.parametrize("log_size,n_cols", [(2, 1), (4, 3), (7, 13)])
def test_quotients_match_jax(log_size, n_cols):
    """The whole domain on the CPU against the JAX package's fused pass,
    out-of-order batches at two points."""
    import jax.numpy as jnp

    rng = np.random.default_rng(log_size)
    batches = _batches(rng, n_cols, log_size, True)
    coeff = _qm31(rng)
    cols = rng.integers(0, P, size=(n_cols, 1 << log_size), dtype=np.uint32)
    got = quotients.accumulate_quotients(
        CanonicCoset.new(log_size).circle_domain(), list(to_torch_u32(cols)),
        coeff, batches, 1)
    want = jax_quotients.accumulate_quotients(
        JaxCanonicCoset.new(log_size).circle_domain(),
        [jnp.asarray(c) for c in cols], JaxQM31.from_ints(coeff.to_ints()),
        _jax_batches(batches), 1)
    assert np.array_equal(to_numpy_u32(got.values), np.asarray(want.values))


@pytest.mark.parametrize("size", [2, 4])
def test_a_rank_slice_is_the_slice_of_the_whole(size):
    """`quotient_rows` on a rank's slice, told its first row, equals that
    slice of the whole domain's quotients (the mesh path)."""
    rng = np.random.default_rng(size)
    log_size = 6
    batches = _batches(rng, 5, log_size, False)
    coeff = _qm31(rng)
    domain = CanonicCoset.new(log_size).circle_domain()
    cols = to_torch_u32(rng.integers(0, P, size=(5, 64), dtype=np.uint32))
    whole = quotients.quotient_rows(domain, list(cols), coeff, batches)
    m = 64 // size
    for rank in range(size):
        part = quotients.quotient_rows(
            domain, list(cols[:, rank * m:(rank + 1) * m]), coeff, batches,
            row0=rank * m)
        assert torch.equal(part, whole[:, rank * m:(rank + 1) * m])


def test_fri_answers_match_jax():
    """The verifier's recomputation at the queried rows, two points and
    two trees, against the JAX package's host path."""
    rng = np.random.default_rng(3)
    log_size, n_cols, queries = 7, (4, 3), [3, 17, 40, 41, 99, 127]
    batches = _batches(rng, sum(n_cols), log_size, False)
    samples = [[] for _ in range(sum(n_cols))]
    for b in batches:
        for i, v in b.columns_and_values:
            samples[i].append(quotients.PointSample(b.point, v))
    coeff = _qm31(rng)
    qvals = rng.integers(0, P, size=len(queries) * sum(n_cols)).tolist()
    trees = [qvals[:len(queries) * n_cols[0]],
             qvals[len(queries) * n_cols[0]:]]
    got = quotients._fri_answers_for_log_size(
        log_size, samples, coeff, queries,
        [iter([M31(v) for v in t]) for t in trees], list(n_cols))
    jax_samples = [[jax_quotients.PointSample(
        _jax_point(s.point), JaxQM31.from_ints(s.value.to_ints()))
        for s in col] for col in samples]
    want = jax_quotients._fri_answers_for_log_size(
        log_size, jax_samples, JaxQM31.from_ints(coeff.to_ints()), queries,
        [iter([JaxM31(v) for v in t]) for t in trees], list(n_cols),
        device=False)
    assert [v.to_ints() for v in got] == [v.to_ints() for v in want]


def test_the_kernel_wrapper_refuses_cpu_columns():
    rng = np.random.default_rng(0)
    batches = _batches(rng, 2, 4, False)
    cols = list(to_torch_u32(rng.integers(0, P, size=(2, 16),
                                          dtype=np.uint32)))
    with pytest.raises(ValueError, match="CUDA"):
        quotients.accumulate_quotients_cuda(
            CanonicCoset.new(4).circle_domain(), cols, _qm31(rng), batches)


def test_the_kernel_is_built_and_names_what_it_replaces():
    assert "quotients.cu" in kernels.SOURCES
    assert kernels.LAUNCHES["accumulate_quotients"] >= 0
    src = (kernels.CSRC / "quotients.cu").read_text()
    assert "tstwo_tpu/pcs/quotients.py:149" in src
    assert "_accumulate_quotients_kernel" in src and "3.35 TB/s" in src
