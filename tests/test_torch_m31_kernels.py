"""The port's M31 probe kernels' plain versions against the JAX package's
Pallas kernels (interpret mode) and a numpy uint64 reference (tolerance 0).

On the CPU `m31_kernels.mul` / `mul_chain` take their plain versions; the
CUDA kernels are held against the same plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tstwo_tpu.ops.pallas import m31_kernels as jax_kernels
from tstwo_tpu_torch.ops import m31_kernels
from tstwo_tpu_torch.utils import to_numpy_u32, to_torch_u32

P = (1 << 31) - 1
EDGE = np.array([0, 1, 2, P - 1, P - 2, 1 << 16, (1 << 16) - 1,
                 (1 << 30) + 12345], dtype=np.uint32)


def _numpy_chain(a, b, reps):
    want = a.astype(np.uint64)
    for _ in range(reps):
        want = want * b.astype(np.uint64) % P
    return want.astype(np.uint32)


def _rand_pair(log_n):
    rng = np.random.default_rng(log_n)
    n = 1 << log_n
    return (rng.integers(0, P, size=n, dtype=np.uint32),
            rng.integers(0, P, size=n, dtype=np.uint32))


@pytest.mark.parametrize("log_n", [10, 12])
def test_mul_matches_jax_and_numpy(log_n):
    a, b = _rand_pair(log_n)
    got = to_numpy_u32(m31_kernels.mul(to_torch_u32(a), to_torch_u32(b)))
    jax_got = np.asarray(jax_kernels.mul(jnp.asarray(a), jnp.asarray(b),
                                         interpret=True))
    np.testing.assert_array_equal(got, jax_got)
    np.testing.assert_array_equal(got, _numpy_chain(a, b, 1))


@pytest.mark.parametrize("reps", [1, 5, 8])
@pytest.mark.parametrize("log_n", [10, 12])
def test_mul_chain_matches_jax_and_numpy(log_n, reps):
    a, b = _rand_pair(log_n)
    got = to_numpy_u32(m31_kernels.mul_chain(to_torch_u32(a),
                                             to_torch_u32(b), reps))
    jax_got = np.asarray(jax_kernels.mul_chain(
        jnp.asarray(a), jnp.asarray(b), reps=reps, interpret=True))
    np.testing.assert_array_equal(got, jax_got)
    np.testing.assert_array_equal(got, _numpy_chain(a, b, reps))


def test_mul_edge_values():
    """The edge values of the JAX package's Pallas test, tiled to 1024."""
    a = np.tile(EDGE, 1024 // len(EDGE) * 8)[:1024]
    b = a[::-1].copy()
    got = to_numpy_u32(m31_kernels.mul(to_torch_u32(a), to_torch_u32(b)))
    np.testing.assert_array_equal(got, _numpy_chain(a, b, 1))
    np.testing.assert_array_equal(got, np.asarray(jax_kernels.mul(
        jnp.asarray(a), jnp.asarray(b), interpret=True)))
    chain = to_numpy_u32(m31_kernels.mul_chain(to_torch_u32(a),
                                               to_torch_u32(b), 8))
    np.testing.assert_array_equal(chain, _numpy_chain(a, b, 8))


@pytest.mark.parametrize("n", [1, 1000, 4097])
def test_any_length_and_zero_reps(n):
    """No N % 1024 restriction; reps 0 returns a."""
    a = np.resize(EDGE, n)
    b = a[::-1].copy()
    ta, tb = to_torch_u32(a), to_torch_u32(b)
    np.testing.assert_array_equal(to_numpy_u32(m31_kernels.mul(ta, tb)),
                                  _numpy_chain(a, b, 1))
    np.testing.assert_array_equal(
        to_numpy_u32(m31_kernels.mul_chain(ta, tb, 3)), _numpy_chain(a, b, 3))
    np.testing.assert_array_equal(
        to_numpy_u32(m31_kernels.mul_chain(ta, tb, 0)), a)


def test_rejects_bad_shapes_and_reps():
    x = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError):
        m31_kernels.mul(x, torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError):
        m31_kernels.mul(x.reshape(2, 4), x.reshape(2, 4))
    with pytest.raises(ValueError):
        m31_kernels.mul(x[:0], x[:0])
    with pytest.raises(ValueError):
        m31_kernels.mul_chain(x, x, -1)
