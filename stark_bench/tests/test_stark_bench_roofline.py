"""The frozen work counts of the kernel rooflines against brute counts made
while the reference proves at small shapes."""
from __future__ import annotations

from collections import Counter

import pytest
import torch

from bench_fixtures import CountingField
from stark_bench import roofline
from stark_bench.reference import merkle, prover
from stark_bench.reference import wide_fibonacci as air
from stark_bench.reference.hashes import n_blocks

SHAPES = [
    (4, {"n_columns": 6, "log_blowup_factor": 1, "log_last": 0}),
    (5, {"n_columns": 20, "log_blowup_factor": 1, "log_last": 1}),
    (4, {"n_columns": 3, "log_blowup_factor": 2, "log_last": 0}),
]


def _config(n_columns, log_blowup_factor, log_last):
    return {"air": {"name": "wide_fibonacci", "n_columns": n_columns},
            "merkle_channel": "blake2s",
            "security": {"pow_bits": 2, "n_queries": 4,
                         "log_blowup_factor": log_blowup_factor,
                         "log_last_layer_degree_bound": log_last}}


@pytest.mark.parametrize("log_n,shape", SHAPES)
def test_merkle_blocks_equal_the_blocks_the_reference_hashes(
        log_n, shape, monkeypatch):
    cfg = _config(**shape)
    counted = []
    real = merkle.blake2s_words

    def counting(words, n, device):
        counted.append(n * n_blocks(4 * len(words)))
        return real(words, n, device)

    monkeypatch.setattr(merkle, "blake2s_words", counting)
    monkeypatch.setattr(merkle, "HOST_LAYER_NODES", 0)
    air.prove(air.trace_inputs(3, log_n), cfg, log_n, "cpu")
    trees = air.merkle_trees(cfg, log_n)
    assert sum(counted) == sum(roofline.merkle_blocks(t)[0] for t in trees)
    ops, _ = roofline.blake2s_work(trees)
    assert ops == roofline.B2S_OPS_PER_BLOCK * sum(counted)


@pytest.mark.parametrize("n_columns", [3, 6, 100])
def test_constraint_ops_equal_a_brute_count_of_the_evaluation(n_columns):
    CountingField.ops = 0
    q = (1, 2, 3, 4)
    air.row_composition(CountingField, [0] * n_columns,
                        [q] * (n_columns - 2), 5)
    for log_n in (4, 20):
        assert air.constraint_ops(_config(n_columns, 1, 0), log_n) == \
            CountingField.ops << (log_n + air.CONSTRAINT_LOG_BLOWUP)
    if n_columns == 100:
        assert CountingField.ops == 6207


def _structural_butterflies(batch: int, log_n: int, m: int) -> int:
    """Butterflies of the forward transform whose second input is not a
    zero of the extension: a layer's butterfly over two zeros, or over a
    value and a zero, computes nothing."""
    live = torch.zeros(1 << log_n, dtype=torch.bool)
    live[:m] = True
    count = 0
    for layer in range(log_n - 1, -1, -1):
        blocks = live.view(-1, 2, 1 << layer)
        count += int(blocks[:, 1, :].sum())
        both = blocks[:, 0, :] | blocks[:, 1, :]
        live = torch.stack([both, both], dim=1).reshape(-1)
    return batch * count


@pytest.mark.parametrize("log_n,shape", SHAPES)
def test_cfft_transforms_are_those_the_reference_makes(
        log_n, shape, monkeypatch):
    cfg = _config(**shape)
    made = Counter()
    real_eval, real_interp = prover.evaluate, prover.interpolate

    def evaluate(coeffs, log_size):
        made[(coeffs.shape[0], log_size,
              coeffs.shape[1].bit_length() - 1)] += 1
        return real_eval(coeffs, log_size)

    def interpolate(values, log_size):
        made[(values.shape[0], log_size, log_size)] += 1
        return real_interp(values, log_size)

    monkeypatch.setattr(prover, "evaluate", evaluate)
    monkeypatch.setattr(prover, "interpolate", interpolate)
    air.prove(air.trace_inputs(4, log_n), cfg, log_n, "cpu")
    assert made == Counter(air.cfft_transforms(cfg, log_n))


@pytest.mark.parametrize("batch,log_n,log_m", [(1, 3, 3), (2, 5, 4),
                                               (3, 6, 3), (1, 1, 1)])
def test_cfft_operations_count_the_layers_of_the_source(batch, log_n, log_m):
    ops, n_bytes = roofline.cfft_work([(batch, log_n, log_m)])
    brute = _structural_butterflies(batch, log_n, 1 << log_m)
    assert ops == roofline.BUTTERFLY_OPS * brute
    assert n_bytes == 4 * (batch * (1 << log_m) + (batch + 1) * (1 << log_n))


def test_bound_takes_the_larger_of_operations_and_bytes():
    assert roofline.bound_s(1.675e13, 0.0) == (1.0, "operations")
    assert roofline.bound_s(0.0, 3.35e12) == (1.0, "bytes")
    pct, by = roofline.share_pct((1.675e13, 1.0), 2.0)
    assert pct == 50.0 and by == "operations"
