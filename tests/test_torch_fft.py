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


def _port_fft(vals, log_n, inverse, scale=None):
    line, circle = _port_twiddles(log_n, inverse)
    return to_numpy_u32(fft.fft_plain(to_torch_u32(vals), line, circle,
                                      inverse, scale))


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
    # fft_fused's inverse includes the 1/N scaling: the plain version's
    # `scale`, as the kernel has it
    scale = pow(1 << log_n, P - 2, P) if inverse else None
    np.testing.assert_array_equal(_port_fft(vals, log_n, inverse, scale), want)
    if inverse:  # and it is the product by hand of the unscaled transform
        by_hand = np.asarray(jax_m31.mul(
            jnp.asarray(_port_fft(vals, log_n, True)), jnp.uint32(scale)))
        np.testing.assert_array_equal(by_hand, want)


def test_plain_inverse_with_scale_matches_pallas_fft_large_scale_n_inv():
    """The 1/N inside the transform, as fft_large's last pass has it."""
    log_n = 15
    vals = _values(650, (2, 1 << log_n))
    line, circle = _jax_twiddles(log_n, True)
    want = np.asarray(fft_kernels.fft_large(
        jnp.asarray(vals), tuple(line), circle, log_n, chunk_log=14,
        inverse=True, scale_n_inv=True, interpret=True))
    got = _port_fft(vals, log_n, True, pow(1 << log_n, P - 2, P))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("scale", [None, 1])
def test_plain_scale_of_one_or_none_changes_nothing(scale):
    vals = _values(660, (2, 1 << 6))
    for inverse in (False, True):
        np.testing.assert_array_equal(_port_fft(vals, 6, inverse, scale),
                                      _port_fft(vals, 6, inverse))


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


@pytest.mark.parametrize("blowup", [1, 2, 3])
@pytest.mark.parametrize("log_m", [0, 1, 3, 6, 9, 12])
def test_evaluate_zero_extends_by_a_blowup(log_m, blowup):
    """Coefficients of length 2^log_m onto a domain 2^blowup times larger,
    the twiddle tree one size larger still (as the commitment scheme has
    it)."""
    log_n = log_m + blowup
    coeffs = _values(810 + log_n, (3, 1 << log_m))
    domain = CanonicCoset.new(log_n).circle_domain()
    tree = twiddles.precompute_twiddles(CanonicCoset.new(log_n + 1)
                                        .circle_domain().half_coset)
    jdomain = JaxCanonicCoset.new(log_n).circle_domain()
    jtree = jax_twiddles.precompute_twiddles(JaxCanonicCoset.new(log_n + 1)
                                             .circle_domain().half_coset)
    got = circle_poly.evaluate_values(to_torch_u32(coeffs), domain, tree)
    want = jax_circle_poly.evaluate_values(jnp.asarray(coeffs), jdomain, jtree)
    np.testing.assert_array_equal(to_numpy_u32(got), np.asarray(want))


def test_evaluate_refuses_a_length_that_is_no_power_of_two():
    """A length that is no power of two is no longer refused: it pads to
    the next power of two as the JAX package's evaluate_values does (and
    equals it); more coefficients than points are still refused."""
    domain = CanonicCoset.new(4).circle_domain()
    coeffs = _values(1, (2, 6))
    got = circle_poly.evaluate_values(to_torch_u32(coeffs), domain)
    want = jax_circle_poly.evaluate_values(
        jnp.asarray(coeffs), JaxCanonicCoset.new(4).circle_domain())
    np.testing.assert_array_equal(to_numpy_u32(got), np.asarray(want))
    with pytest.raises(ValueError, match="too small"):
        circle_poly.evaluate_values(to_torch_u32(_values(1, (2, 32))), domain)


def test_interpolate_scales_inside_the_transform():
    """interpolate_values hands 1/N to the transform (one function with
    the kernel) and equals the unscaled transform times 1/N."""
    log_n = 7
    vals = _values(820, (2, 1 << log_n))
    domain = CanonicCoset.new(log_n).circle_domain()
    got = circle_poly.interpolate_values(to_torch_u32(vals), domain)
    line, circle = _port_twiddles(log_n, True)
    unscaled = fft.ifft_bitrev_to_natural(to_torch_u32(vals), line, circle)
    n_inv = pow(1 << log_n, P - 2, P)
    want = to_numpy_u32(unscaled).astype(np.uint64) * n_inv % P
    np.testing.assert_array_equal(to_numpy_u32(got), want.astype(np.uint32))


# -- the kernel's schedule ---------------------------------------------------

@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("log_n", range(1, 31))
def test_cfft_plan_does_every_layer_once_in_order(log_n, inverse):
    plan = fft.cfft_plan(log_n, inverse)
    layers = []
    for kind, first, count, _ in plan:
        assert kind in ("contiguous", "strided") and count >= 1
        run = list(range(first, first + count))
        layers += run if inverse else run[::-1]
    want = list(range(log_n))
    assert layers == (want if inverse else want[::-1])
    # the contiguous pass holds the lowest layers; one of it a transform
    assert [p[0] for p in plan].count("contiguous") == 1
    assert plan[0 if inverse else -1][:2] == ("contiguous", 0)


@pytest.mark.parametrize("log_n", range(1, 31))
def test_cfft_plan_pass_limits_and_tiles(log_n):
    plan = fft.cfft_plan(log_n, True)
    assert len(plan) <= (1 if log_n <= 11 else 2 if log_n <= 20 else 3)
    if log_n <= 22:  # the LogUp 2^20 shapes: two passes
        assert len(plan) <= 2
    assert fft.cfft_plan(log_n, False) == plan[::-1]
    for kind, first, count, (rows, words) in plan:
        assert 4 * rows * words <= fft.SHARED_BYTES
        assert rows * words // 16 <= 512  # a thread holds 16 words
        if kind == "contiguous":
            small = log_n <= fft.SMALL_CHUNK_LOG
            assert (rows, words) == (
                1, 1 << (fft.SMALL_CHUNK_LOG if small else fft.CHUNK_LOG))
            assert count <= fft.CHUNK_LOG and count <= log_n
        else:
            # 2^count rows, 2^first words apart; whole 32-byte sectors
            assert rows == 1 << count and 4 <= count <= fft.MAX_STRIDED_LOG
            assert words >= fft.MIN_WIDTH and words <= 1 << first
            assert rows * words >= 1 << fft.CHUNK_LOG
    # a tile holds at least 16 words a thread and one window of rows
    assert all(rows * words >= 1 << fft.SMALL_CHUNK_LOG
               for _, _, _, (rows, words) in plan)


def test_cfft_plan_refuses_sizes_out_of_range():
    for log_n in (0, 31):
        with pytest.raises(ValueError, match="log_n"):
            fft.cfft_plan(log_n, False)


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


def test_twiddle_tree_drops_and_remakes_its_device_copies():
    """`drop_device_copies` forgets the cached tensors and kernel buffers;
    the next use makes equal ones from the host arrays."""
    from tstwo_tpu_torch.circle import CanonicCoset
    from tstwo_tpu_torch.poly.twiddles import precompute_twiddles

    tree = precompute_twiddles(CanonicCoset.new(7).circle_domain().half_coset)
    line, circle, buf = tree.fft_twiddles(6, False, "cpu")
    assert tree.fft_twiddles(6, False, "cpu")[2] is buf
    tree.drop_device_copies()
    line2, circle2, buf2 = tree.fft_twiddles(6, False, "cpu")
    assert buf2 is not buf and torch.equal(buf2, buf)
    assert torch.equal(circle2, circle)
    assert all(torch.equal(a, b) for a, b in zip(line2, line))


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


@pytest.mark.parametrize("which", ["wide_fibonacci", "basic_air",
                                   "logup_lookup", "generate_trace"])
def test_entry_points_default_to_cuda_and_raise_without_it(which,
                                                           monkeypatch):
    """No quiet step down to the CPU: without a device argument the entry
    points want CUDA device 0 and say so where there is none."""
    from tstwo_tpu_torch.examples import (basic_air, logup_lookup,
                                          wide_fibonacci)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    call = {"wide_fibonacci": lambda: wide_fibonacci.prove_wide_fibonacci(4, 4),
            "basic_air": lambda: basic_air.prove_basic_air(4),
            "logup_lookup": lambda: logup_lookup.prove_logup_lookup(4),
            "generate_trace": lambda: wide_fibonacci.generate_trace(4, 4)}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call[which]()


def test_entry_points_take_the_cpu_when_asked():
    from tstwo_tpu_torch.examples import basic_air
    from tstwo_tpu_torch.utils import entry_device

    assert entry_device("cpu") == torch.device("cpu")
    assert entry_device(torch.device("cuda", 1)) == torch.device("cuda", 1)
    proof, component, config = basic_air.prove_basic_air(4, device="cpu")
    basic_air.verify_basic_air(proof, component, config, 4)


def test_dispatch_rejects_other_devices():
    with pytest.raises(ValueError, match="unsupported device"):
        kernels.on_cuda(torch.empty(4, dtype=torch.int32, device="meta"))
