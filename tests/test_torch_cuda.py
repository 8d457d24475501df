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


@pytest.mark.parametrize("words,byte_len", [(1, 4), (15, 60), (17, 128),
                                            (0, 0), (5, 64)])
def test_blake2s_kernel_takes_fewer_words_than_its_blocks(device, words,
                                                          byte_len):
    """Words past those given are zero constants in the kernel."""
    w = _rand(np.random.default_rng(words), (words, 300), device, 1 << 32)
    _exact(blake2s.hash_words_major_cuda(w, byte_len),
           blake2s.hash_words_major_plain(w, byte_len))
    with pytest.raises(ValueError, match="more words"):
        blake2s.hash_words_major_cuda(
            _rand(np.random.default_rng(0), (17, 4), device), 64)


def _layer_inputs(rng, n, entries, with_prev, device):
    prev = _rand(rng, (8, 2 * n), device, 1 << 32) if with_prev else None
    cols = [_rand(rng, (n,) if c == 0 else (c, n), device) for c in entries]
    return prev, cols


# column entries of a layer: 0 for a single column [n], C for a stack [C, n]
LAYER_ENTRIES = [(), (0,), (4,), (15,), (16,), (17,), (32,), (33,), (64,),
                 (0, 3, 0, 1), (0,) * 20]


@pytest.mark.parametrize("with_prev", [False, True])
@pytest.mark.parametrize("entries", LAYER_ENTRIES,
                         ids=lambda e: "cols" + "_".join(map(str, e)))
@pytest.mark.parametrize("n", [1, 2, 1000, 4096])
def test_merkle_layer_kernel_matches_plain(device, n, entries, with_prev):
    """Messages of 0 to 320 bytes (0: n hashes of the empty message):
    child pairs, [n] and [C, n] entries mixed, more entries than the
    kernel's segment table holds."""
    rng = np.random.default_rng(n + len(entries))
    prev, cols = _layer_inputs(rng, n, entries, with_prev, device)
    _exact(blake2s.merkle_layer_cuda(prev, cols, n, device),
           blake2s.merkle_layer_plain(prev, cols, n, device))


def test_merkle_layer_kernel_reads_views_where_they_lie(device):
    rng = np.random.default_rng(21)
    n = 512
    flat = _rand(rng, (1 + 16 * n,), device, 1 << 32)
    prev = flat[1:].view(8, 2 * n)  # 4-byte but not 8-byte aligned
    assert prev.data_ptr() % 8
    big = _rand(rng, (9, 3 * n + 1), device)
    cols = [big[2:5, 1:1 + n],      # rows a stride apart, odd offset
            big[7, n:2 * n],        # one row of a stack
            big[:, ::3][:2, :n],    # stride 3 on the last axis: copied
            big[0:0, :n]]           # no rows
    kernels.reset_launches()
    got = blake2s.merkle_layer_cuda(prev, cols)
    assert kernels.LAUNCHES["merkle_layer"] == 1
    _exact(got, blake2s.merkle_layer_plain(prev, cols))


@pytest.mark.parametrize("log", range(1, blake2s.MAX_TAIL_LOG + 2))
def test_merkle_tail_kernel_matches_plain_layer_by_layer(device, log):
    rng = np.random.default_rng(log)
    flat = _rand(rng, (1 + (8 << log),), device, 1 << 32)
    for prev in (flat[:-1].view(8, 1 << log), flat[1:].view(8, 1 << log)):
        got = blake2s.merkle_tail_cuda(prev)
        want = blake2s.merkle_tail_plain(prev)
        assert len(got) == len(want) == log
        for g, w in zip(got, want):
            _exact(g, w)


def test_merkle_tail_kernel_refuses_a_layer_too_large(device):
    prev = torch.zeros((8, 2 << (blake2s.MAX_TAIL_LOG + 1)),
                       dtype=torch.int32, device=device)
    with pytest.raises(ValueError, match="the tail takes"):
        blake2s.merkle_tail_cuda(prev)


@pytest.mark.parametrize("sizes", [
    [(0, 3)], [(1, 0)], [(10, 2)], [(11, 0)], [(12, 4)], [(13, 64)],
    [(13, 2), (12, 0), (6, 4), (13, 0), (2, 0), (0, 0)], [(13, 1), (3, 2)]],
    ids=str)
def test_merkle_commit_on_the_card_equals_the_cpu_tree(device, sizes):
    from tstwo_tpu_torch.vcs import MerkleProver

    rng = np.random.default_rng(len(sizes))
    cols = [_rand(rng, ((1 << log) if c == 0 else (c, 1 << log)), "cpu")
            for log, c in sizes]
    kernels.reset_launches()
    on_card = MerkleProver.commit([c.to(device) for c in cols])
    assert kernels.LAUNCHES["deinterleave"] == 0
    on_cpu = MerkleProver.commit(cols)
    assert len(on_card.layers) == len(on_cpu.layers)
    for a, b in zip(on_card.layers, on_cpu.layers):
        _exact(a, b)
    assert on_card.root() == on_cpu.root()
    queries = {log: sorted({0, (1 << log) // 3, (1 << log) - 1})
               for log, _ in sizes}
    got = on_card.decommit(queries, [c.to(device) for c in cols])
    want = on_cpu.decommit(queries, cols)
    assert [v.value for v in got[0]] == [v.value for v in want[0]]
    assert got[1].hash_witness == want[1].hash_witness


def test_empty_merkle_commit_on_the_card(device):
    import hashlib

    from tstwo_tpu_torch.vcs import MerkleProver

    tree = MerkleProver.commit([], device)
    assert tree.layers[0].device.type == "cuda"
    assert tree.root() == hashlib.blake2s(b"").digest()


@pytest.mark.parametrize("shape", [
    (2,), (6,), (3, 6), (5, 10), (2, 5, 10), (7, 1 << 10), (4, 1 << 12),
    (3, (1 << 12) + 2), (1 << 23,), (4, 1 << 18), (4, 1 << 20)], ids=str)
def test_deinterleave_kernel_matches_plain(device, shape):
    """2 to 2^23 values, odd row counts, odd and even counts of pairs."""
    x = _rand(np.random.default_rng(len(shape)), shape, device)
    for got, want in zip(fri_ops.deinterleave_cuda(x),
                         fri_ops.deinterleave_plain(x)):
        assert got.is_contiguous()
        _exact(got, want.contiguous())


@pytest.mark.parametrize("offset", [1, 2, 3, 4])
@pytest.mark.parametrize("n", [64, 66, 1 << 14])
def test_deinterleave_kernel_takes_a_view_at_any_offset(device, offset, n):
    """Contiguous views 4, 8 and 16-byte aligned: the kernel's 16-byte and
    8-byte paths and the wrapper's copy."""
    base = _rand(np.random.default_rng(9), (offset + n,), device)
    x = base[offset:]
    assert x.data_ptr() % 16 == 4 * offset % 16
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
    prev = blake2s.merkle_layer(None, [x])
    blake2s.merkle_tail(blake2s.merkle_layer(prev, []))
    fri_ops._deinterleave(x)
    m31_kernels.mul(x[0], x[1])
    m31_kernels.mul_chain(x[0], x[1], 3)
    assert kernels.LAUNCHES == {"cfft_forward": 1, "cfft_inverse": 1,
                                "blake2s": 2, "merkle_layer": 1,
                                "merkle_tail": 1, "deinterleave": 1,
                                "m31_mul": 1, "m31_mul_chain": 1}
