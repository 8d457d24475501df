"""CFFT parity of the PyTorch port against the JAX package (tolerance 0).

The port's plain CFFT (the CPU path, and the version its CUDA kernel
csrc/cfft.cu is held against on the card) must equal the JAX layered path,
the JAX Pallas kernels in interpret mode (fft_large: the two-pass large
kernel; fft_fused: the VMEM-resident one), and the JAX evaluate /
interpolate at every special-cased size.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tstwo_tpu.circle import CanonicCoset as JaxCanonicCoset
from tstwo_tpu.ops import fft as jax_fft
from tstwo_tpu.ops import m31 as jax_m31
from tstwo_tpu.ops.pallas import fft_kernels
from tstwo_tpu.poly import circle_poly as jax_circle_poly
from tstwo_tpu.poly import twiddles as jax_twiddles
from tstwo_tpu_torch import kernels
from tstwo_tpu_torch.circle import CanonicCoset
from tstwo_tpu_torch.ops import fft
from tstwo_tpu_torch.poly import circle_poly, twiddles
from tstwo_tpu_torch.utils import to_numpy_u32, to_torch_u32

P = (1 << 31) - 1


def _jax_twiddles(log_n, inverse):
    domain = JaxCanonicCoset.new(log_n).circle_domain()
    tree = jax_twiddles.precompute_twiddles(domain.half_coset)
    line = jax_twiddles.domain_line_twiddles(log_n, tree, inverse)
    return line, jax_twiddles.circle_layer_twiddles(line[0])


def _port_twiddles(log_n, inverse):
    domain = CanonicCoset.new(log_n).circle_domain()
    tree = twiddles.precompute_twiddles(domain.half_coset)
    line, circle, _ = tree.fft_twiddles(log_n, inverse, "cpu")
    return line, circle


def _values(seed, shape):
    return np.random.default_rng(seed).integers(0, P, size=shape,
                                                dtype=np.uint32)


def _port_fft(vals, log_n, inverse):
    line, circle = _port_twiddles(log_n, inverse)
    return to_numpy_u32(fft.fft_plain(to_torch_u32(vals), line, circle,
                                      inverse))


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("log_n", range(3, 15))
def test_plain_cfft_matches_jax_layered(log_n, inverse):
    vals = _values(log_n, (3, 1 << log_n))
    line, circle = _jax_twiddles(log_n, inverse)
    jfn = jax_fft.ifft_bitrev_to_natural if inverse else \
        jax_fft.fft_natural_to_bitrev
    want = np.asarray(jfn(jnp.asarray(vals), line, circle))
    np.testing.assert_array_equal(_port_fft(vals, log_n, inverse), want)
    np.testing.assert_array_equal(_port_fft(vals[1], log_n, inverse),
                                  want[1])


@pytest.mark.parametrize("inverse", [False, True])
def test_plain_cfft_matches_pallas_fft_large(inverse):
    """log 15 with chunk 2^14: the two-pass kernel's grid split."""
    log_n = 15
    vals = _values(500 + inverse, (2, 1 << log_n))
    line, circle = _jax_twiddles(log_n, inverse)
    want = np.asarray(fft_kernels.fft_large(
        jnp.asarray(vals), tuple(line), circle, log_n, chunk_log=14,
        inverse=inverse, scale_n_inv=False, interpret=True))
    np.testing.assert_array_equal(_port_fft(vals, log_n, inverse), want)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("log_n", [9, 10])
def test_plain_cfft_matches_pallas_fft_fused(log_n, inverse):
    vals = _values(600 + log_n, 1 << log_n)
    line, circle = _jax_twiddles(log_n, inverse)
    want = np.asarray(fft_kernels.fft_fused(
        jnp.asarray(vals), tuple(line), circle, log_n, inverse=inverse,
        interpret=True))
    got = _port_fft(vals, log_n, inverse)
    if inverse:  # fft_fused's inverse includes the 1/N scaling
        n_inv = pow(1 << log_n, P - 2, P)
        got = np.asarray(jax_m31.mul(jnp.asarray(got), jnp.uint32(n_inv)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("log_n", range(1, 17))
def test_evaluate_and_interpolate_match_jax(log_n):
    coeffs = _values(700 + log_n, (2, 1 << log_n))
    domain = CanonicCoset.new(log_n).circle_domain()
    jdomain = JaxCanonicCoset.new(log_n).circle_domain()
    ev = circle_poly.evaluate_values(to_torch_u32(coeffs), domain)
    want = np.asarray(jax_circle_poly.evaluate_values(jnp.asarray(coeffs),
                                                      jdomain))
    np.testing.assert_array_equal(to_numpy_u32(ev), want)
    back = circle_poly.interpolate_values(ev, domain)
    jback = np.asarray(jax_circle_poly.interpolate_values(jnp.asarray(want),
                                                          jdomain))
    np.testing.assert_array_equal(to_numpy_u32(back), jback)
    np.testing.assert_array_equal(to_numpy_u32(back), coeffs)


def test_evaluate_zero_extends_onto_a_larger_domain():
    coeffs = _values(800, (4, 1 << 6))
    domain = CanonicCoset.new(8).circle_domain()
    tree = twiddles.precompute_twiddles(CanonicCoset.new(9)
                                        .circle_domain().half_coset)
    jdomain = JaxCanonicCoset.new(8).circle_domain()
    jtree = jax_twiddles.precompute_twiddles(JaxCanonicCoset.new(9)
                                             .circle_domain().half_coset)
    got = circle_poly.evaluate_values(to_torch_u32(coeffs), domain, tree)
    want = jax_circle_poly.evaluate_values(jnp.asarray(coeffs), jdomain, jtree)
    np.testing.assert_array_equal(to_numpy_u32(got), np.asarray(want))


def test_twiddle_buffer_layout():
    """Layer l of the kernel's buffer starts at n - (n >> l)."""
    log_n = 6
    n = 1 << log_n
    line, circle = _port_twiddles(log_n, False)
    buf = fft.twiddle_buffer(line, circle)
    assert buf.numel() == n - 1
    assert torch.equal(buf[:n // 2], circle)
    for l in range(1, log_n):
        off = n - (n >> l)
        assert torch.equal(buf[off:off + (n >> (l + 1))], line[l - 1])


def test_bit_reverse_matches_jax():
    vals = _values(900, (2, 1 << 9))
    np.testing.assert_array_equal(
        to_numpy_u32(fft.bit_reverse(to_torch_u32(vals), 9)),
        np.asarray(jax_fft.bit_reverse(jnp.asarray(vals), 9)))


def test_cuda_wrapper_refuses_cpu_tensors():
    """No fallback: the kernel wrapper takes CUDA tensors only."""
    line, circle = _port_twiddles(5, False)
    x = to_torch_u32(_values(1, 1 << 5))
    with pytest.raises(ValueError, match="CUDA"):
        fft.cfft_cuda(x, fft.twiddle_buffer(line, circle), 5, False)


def test_dispatch_rejects_other_devices():
    with pytest.raises(ValueError, match="unsupported device"):
        kernels.on_cuda(torch.empty(4, dtype=torch.int32, device="meta"))
