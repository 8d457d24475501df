"""The CUDA kernels against their plain PyTorch versions on the card, at
edge shapes the main path does not reach (tolerance 0).

Needs a CUDA GPU and skips without one.  The GPU machine has no JAX, so
run this file there without the suite's conftest (which imports jax) and
its xdist options:

    python -m pytest -o addopts="" --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from tstwo_tpu_torch import kernels
from tstwo_tpu_torch.ops import blake2s, fft, fri_ops, m31_kernels
from tstwo_tpu_torch.utils import to_torch_u32

P = (1 << 31) - 1
pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda", 0)


def _rand(rng, shape, device, high=P):
    return to_torch_u32(rng.integers(0, high, size=shape, dtype=np.uint64)
                        .astype(np.uint32), device)


def _exact(got, want):
    assert got.shape == want.shape
    assert torch.equal(got.cpu(), want.cpu())


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("log_n", [1, 2, 3, 5, 10, 11, 12, 13, 15])
def test_cfft_kernel_matches_plain(device, log_n, inverse):
    """Any twiddles: the kernel's butterfly schedule, block/global split
    (2^11 chunks) and buffer offsets against the layered plain version."""
    rng = np.random.default_rng(log_n)
    n = 1 << log_n
    x = _rand(rng, (3, n), device)
    circle = _rand(rng, (n // 2,), device)
    line = [_rand(rng, (n >> (l + 1),), device) for l in range(1, log_n)]
    got = fft.cfft_cuda(x, fft.twiddle_buffer(line, circle), log_n, inverse)
    _exact(got, fft.fft_plain(x, line, circle, inverse))


@pytest.mark.parametrize("byte_len", [0, 4, 64, 100, 260])
@pytest.mark.parametrize("n", [1, 127, 4097])
def test_blake2s_kernel_matches_plain(device, n, byte_len):
    rng = np.random.default_rng(n + byte_len)
    total = max(1, -(-byte_len // 64)) * 16
    words = _rand(rng, (total, n), device, 1 << 32)
    _exact(blake2s.hash_words_major_cuda(words, byte_len),
           blake2s.hash_words_major_plain(words, byte_len))


@pytest.mark.parametrize("shape", [(2,), (3, 6), (2, 5, 10), (4, 1 << 12)])
def test_deinterleave_kernel_matches_plain(device, shape):
    x = _rand(np.random.default_rng(len(shape)), shape, device)
    for got, want in zip(fri_ops.deinterleave_cuda(x),
                         fri_ops.deinterleave_plain(x)):
        _exact(got, want.contiguous())


def test_deinterleave_kernel_takes_a_view_at_an_odd_offset(device):
    base = _rand(np.random.default_rng(9), (1 + 64,), device)
    x = base[1:]  # contiguous, 4-byte but not 8-byte aligned
    assert x.data_ptr() % 8
    for got, want in zip(fri_ops.deinterleave_cuda(x),
                         fri_ops.deinterleave_plain(x)):
        _exact(got, want.contiguous())


M31_EDGE = np.array([0, 1, 2, P - 1, P - 2, 1 << 16, (1 << 16) - 1,
                     (1 << 30) + 12345], dtype=np.uint32)


@pytest.mark.parametrize("reps", [0, 1, 5, 8])
@pytest.mark.parametrize("n", [1, 1000, 1024, 4097])
def test_m31_kernels_match_plain_on_edge_values(device, n, reps):
    """Any N (no N % 1024 tiling), the edge values of the Pallas tests."""
    a = np.resize(M31_EDGE, n)
    a_t, b_t = to_torch_u32(a, device), to_torch_u32(a[::-1].copy(), device)
    _exact(m31_kernels.mul_cuda(a_t, b_t), m31_kernels.mul_plain(a_t, b_t))
    _exact(m31_kernels.mul_chain_cuda(a_t, b_t, reps),
           m31_kernels.mul_chain_plain(a_t, b_t, reps))


def test_m31_kernels_match_plain_on_random_values(device):
    rng = np.random.default_rng(12)
    a, b = _rand(rng, (1 << 20) + 3, device), _rand(rng, (1 << 20) + 3, device)
    _exact(m31_kernels.mul_cuda(a, b), m31_kernels.mul_plain(a, b))
    _exact(m31_kernels.mul_chain_cuda(a, b, 8),
           m31_kernels.mul_chain_plain(a, b, 8))


def test_dispatch_sends_cuda_tensors_to_the_kernels(device):
    rng = np.random.default_rng(3)
    kernels.reset_launches()
    x = _rand(rng, (2, 1 << 6), device)
    line = [_rand(rng, (64 >> (l + 1),), device) for l in range(1, 6)]
    fft.fft_natural_to_bitrev(x, line, _rand(rng, (32,), device))
    fft.ifft_bitrev_to_natural(x, line, _rand(rng, (32,), device))
    blake2s.hash_words_major(_rand(rng, (8, 16), device, 1 << 32), 32)
    fri_ops._deinterleave(x)
    m31_kernels.mul(x[0], x[1])
    m31_kernels.mul_chain(x[0], x[1], 3)
    assert kernels.LAUNCHES == {"cfft_forward": 1, "cfft_inverse": 1,
                                "blake2s": 1, "deinterleave": 1,
                                "m31_mul": 1, "m31_mul_chain": 1}
