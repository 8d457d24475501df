"""The GKR sum-check's hypercube work (tstwo_tpu_torch/lookups/gkr_kernels.py)
on the CPU: its plain round sums and folds against the benchmark's plain
reference (stark_bench/reference/gkr_lookups.py, which imports nothing of
the port), round by round for every layer kind, tolerance 0; the kernels'
registration in kernels.py; and the counter `gkr_round_sums_on_card`,
which a CPU prove leaves silent.  The kernels themselves run on the card:
tests/test_torch_cuda.py holds them to these plain versions there.
"""
from __future__ import annotations

import re

import numpy as np
import pytest
import torch

from stark_bench.recipes.gkr_lookups import proof_fields
from stark_bench.reference import gkr_lookups as reference
from tstwo_tpu_torch import kernels, tracing
from tstwo_tpu_torch.channel.blake2s import Blake2sChannel
from tstwo_tpu_torch.fields import QM31
from tstwo_tpu_torch.lookups import gkr_kernels
from tstwo_tpu_torch.lookups.gkr import EqEvals, Layer, prove_batch
from tstwo_tpu_torch.lookups.mle import BaseMle, Mle
from tstwo_tpu_torch.utils import to_torch_u32

P = (1 << 31) - 1
KINDS = list(gkr_kernels.KINDS)


def _qm31(rng) -> QM31:
    return QM31.from_ints([int(v) for v in rng.integers(0, P, 4)])


def _tuple(v: QM31) -> tuple:
    return tuple(v.to_ints())


def _layer(kind, log_n, rng):
    """The port's input layer of `kind` over 2^log_n random points and the
    reference's columns of the same function: base numerators zero-
    extended, LogUpSingles' numerators all 1."""
    n = 1 << log_n

    def cols(shape):
        return to_torch_u32(rng.integers(1, P, size=shape, dtype=np.uint32),
                            "cpu")

    num, den = cols((4, n)), cols((4, n))
    ones = torch.zeros((4, n), dtype=torch.int32)
    ones[0] = 1
    if kind == gkr_kernels.GRAND_PRODUCT:
        return Layer(kind, data=Mle(num)), (num,)
    if kind == gkr_kernels.LOGUP_GENERIC:
        return Layer(kind, numerators=Mle(num), denominators=Mle(den)), \
            (num, den)
    if kind == gkr_kernels.LOGUP_MULTIPLICITIES:
        base = cols((n,))
        secure = torch.zeros((4, n), dtype=torch.int32)
        secure[0] = base
        return Layer(kind, numerators=BaseMle(base),
                     denominators=Mle(den)), (secure, den)
    return Layer(kind, denominators=Mle(den)), (ones, den)


@pytest.mark.parametrize("log_n", [2, 3, 6])
@pytest.mark.parametrize("kind", KINDS)
def test_rounds_equal_the_reference_round_by_round(kind, log_n):
    """Each round polynomial (the round sums through the eq correction)
    and each fold of the port's oracle equal the reference's, to the
    mask: the layer of 2^log_n points as the oracle of a sum-check of
    log_n - 1 rounds."""
    rng = np.random.default_rng(10 * log_n + KINDS.index(kind))
    layer, cols = _layer(kind, log_n, rng)
    y = [_qm31(rng) for _ in range(log_n - 1)]
    lam = _qm31(rng)
    oracle = layer.into_multivariate_poly(lam, EqEvals.generate(y, "cpu"))
    ref_kind = (gkr_kernels.GRAND_PRODUCT
                if kind == gkr_kernels.GRAND_PRODUCT
                else gkr_kernels.LOGUP_GENERIC)
    ref = reference.Oracle(ref_kind, tuple(c.to(torch.int64) for c in cols),
                           [_tuple(v) for v in y],
                           reference.eq_table([_tuple(v) for v in y], "cpu"),
                           _tuple(lam))
    for _ in range(log_n - 1):
        claim = _qm31(rng)
        got = oracle.sum_as_poly_in_first_variable(claim)
        assert [_tuple(c) for c in got.coeffs] == ref.round(_tuple(claim))
        r = _qm31(rng)
        oracle = oracle.fix_first_variable(r)
        ref.fix(_tuple(r))
    mask = oracle.try_into_mask().columns()
    assert [(_tuple(a), _tuple(b)) for a, b in mask] == ref.mask()


@pytest.mark.parametrize("n_terms", [1, 2, 64])
@pytest.mark.parametrize("kind", KINDS)
def test_round_sums_equal_the_reference_sums(kind, n_terms):
    """The plain round sums at 0 and at 2 against the reference's gate
    (`gate_terms`) and sum (`total`) over the same quarters of the layer,
    over the prefix of a longer eq table."""
    rng = np.random.default_rng(n_terms + 7 * KINDS.index(kind))
    layer, ref_cols = _layer(kind, (4 * n_terms).bit_length() - 1, rng)
    eq_arr = to_torch_u32(rng.integers(0, P, size=(4, 3 * n_terms),
                                       dtype=np.uint32), "cpu")[:, :n_terms]
    lam = _qm31(rng)
    round_kind, cols = layer.round_columns()
    got = gkr_kernels.round_sums_plain(round_kind, eq_arr, cols, lam)
    assert got.dtype == torch.int32 and got.shape == (8,)

    h = n_terms
    quarters = [(c[:, 0:2 * h:2], c[:, 1:2 * h:2], c[:, 2 * h::2],
                 c[:, 2 * h + 1::2]) for c in (c.to(torch.int64)
                                               for c in ref_cols)]
    q0a, q0b, q1a, q1b = zip(*quarters)
    q2a = [reference.qv_sub(reference.qv_add(u, u), v)
           for u, v in zip(q1a, q0a)]
    q2b = [reference.qv_sub(reference.qv_add(u, u), v)
           for u, v in zip(q1b, q0b)]
    ref_kind = (gkr_kernels.GRAND_PRODUCT
                if kind == gkr_kernels.GRAND_PRODUCT
                else gkr_kernels.LOGUP_GENERIC)
    eq64 = eq_arr.to(torch.int64)
    want = torch.cat([
        reference.total(reference.qv_mul(eq64, reference.gate_terms(
            ref_kind, q0a, q0b, _tuple(lam)))),
        reference.total(reference.qv_mul(eq64, reference.gate_terms(
            ref_kind, q2a, q2b, _tuple(lam))))])
    assert got.tolist() == want.tolist()
    assert gkr_kernels.round_sums(round_kind, eq_arr, cols, lam) == (
        QM31.from_ints(want[:4].tolist()), QM31.from_ints(want[4:].tolist()))


@pytest.mark.parametrize("base", [False, True])
@pytest.mark.parametrize("n", [2, 8, 1 << 10])
def test_fold_equals_the_reference_fold(n, base):
    """lhs + c (rhs - lhs) over the halves, of a QM31 MLE or of a base-field
    one (zero-extended), against the reference's fold; the input is left
    as it was."""
    rng = np.random.default_rng(n + base)
    arr = to_torch_u32(rng.integers(0, P, size=(n,) if base else (4, n),
                                    dtype=np.uint32), "cpu")
    before = arr.clone()
    c = _qm31(rng)
    secure = arr.to(torch.int64)
    if base:
        secure = torch.zeros((4, n), dtype=torch.int64)
        secure[0] = arr
    lo, hi = secure[:, :n // 2], secure[:, n // 2:]
    want = reference.qv_add(lo, reference.qv_mul(
        reference.vec(_tuple(c), "cpu"), reference.qv_sub(hi, lo)))
    got = gkr_kernels.fold(arr, c)
    assert got.dtype == torch.int32 and got.shape == (4, n // 2)
    assert got.tolist() == want.tolist()
    assert torch.equal(arr, before)
    mle = (BaseMle if base else Mle)(arr)
    assert mle.fix_first_variable(c).evals.tolist() == want.tolist()


def test_the_kernels_are_registered_and_name_what_they_replace():
    assert "gkr.cu" in kernels.SOURCES
    assert len(kernels._SIGNATURES["tstwo_gkr_round_sums"]) == 14
    assert len(kernels._SIGNATURES["tstwo_mle_fold"]) == 10
    assert kernels.LAUNCHES["gkr_round_sums"] >= 0
    assert kernels.LAUNCHES["mle_fold"] >= 0
    src = (kernels.CSRC / "gkr.cu").read_text()
    assert "tstwo_tpu/lookups/gkr.py:311" in src
    assert "tstwo_tpu/lookups/mle.py:27" in src and "3.35 TB/s" in src
    for name in ("tstwo_gkr_round_sums", "tstwo_mle_fold"):
        assert f'extern "C" int {name}(' in src
    consts = {"kGrandProduct": gkr_kernels.GRAND_PRODUCT,
              "kLogUpGeneric": gkr_kernels.LOGUP_GENERIC,
              "kLogUpMultiplicities": gkr_kernels.LOGUP_MULTIPLICITIES,
              "kLogUpSingles": gkr_kernels.LOGUP_SINGLES}
    for const, kind in consts.items():
        value = re.search(rf"constexpr int {const} = (\d+);", src).group(1)
        assert int(value) == gkr_kernels.KINDS[kind]


def test_the_kernel_wrappers_refuse_cpu_tensors():
    rng = np.random.default_rng(5)
    layer, _ = _layer(gkr_kernels.LOGUP_GENERIC, 4, rng)
    eq_arr = to_torch_u32(rng.integers(0, P, size=(4, 4), dtype=np.uint32),
                          "cpu")
    kind, cols = layer.round_columns()
    with pytest.raises(ValueError, match="CUDA"):
        gkr_kernels.round_sums_cuda(kind, eq_arr, cols, _qm31(rng))
    with pytest.raises(ValueError, match="CUDA"):
        gkr_kernels.fold_cuda(cols[0], _qm31(rng))
    with pytest.raises(ValueError, match="unknown layer kind"):
        gkr_kernels.round_sums_cuda("LogUpFancy", eq_arr, cols, _qm31(rng))


@pytest.mark.parametrize("kinds", [[gkr_kernels.GRAND_PRODUCT,
                                    gkr_kernels.LOGUP_GENERIC],
                                   [gkr_kernels.LOGUP_MULTIPLICITIES],
                                   [gkr_kernels.LOGUP_SINGLES]])
def test_round_sums_on_card_is_silent_on_the_cpu(kinds):
    """A CPU prove under the span tree counts its rounds but no round sum
    on the card and launches no kernel; without the span tree nothing is
    counted."""
    rng = np.random.default_rng(len(kinds))
    layers = [_layer(kind, 5, rng)[0] for kind in kinds]
    kernels.reset_launches()
    tracing.reset()
    tracing.enable(sync=False)
    try:
        with tracing.request(0):
            traced = prove_batch(Blake2sChannel(), layers)[0]
        counts = tracing.counts()[0]
    finally:
        tracing.disable()
        tracing.reset()
    assert counts["sumcheck_rounds"] == sum(range(5))
    assert "gkr_round_sums_on_card" not in counts
    assert kernels.LAUNCHES["gkr_round_sums"] == 0
    assert kernels.LAUNCHES["mle_fold"] == 0
    untraced = prove_batch(Blake2sChannel(), layers)[0]
    assert tracing.counts() == {}
    assert proof_fields(untraced) == proof_fields(traced)
