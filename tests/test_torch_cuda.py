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
from tstwo_tpu_torch.ops import (blake2s, constraint_eval, fft, fri_ops,
                                 m31_kernels)
from tstwo_tpu_torch.ops import poseidon252 as pos
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


def _cfft_case(rng, batch, log_n, device, log_m=None):
    """Random values [batch, 2^log_m] and any (random) twiddles."""
    n = 1 << log_n
    x = _rand(rng, (batch, n if log_m is None else 1 << log_m), device)
    circle = _rand(rng, (n // 2,), device)
    line = [_rand(rng, (n >> (l + 1),), device) for l in range(1, log_n)]
    return x, line, circle


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("log_n", [1, 2, 3, 5, 10, 11, 12, 13, 15])
def test_cfft_kernel_matches_plain(device, log_n, inverse):
    """Any twiddles: the kernel's windows, its contiguous/strided split
    and buffer offsets against the layered plain version."""
    rng = np.random.default_rng(log_n)
    x, line, circle = _cfft_case(rng, 3, log_n, device)
    got = fft.cfft_cuda(x, fft.twiddle_buffer(line, circle), log_n, inverse)
    _exact(got, fft.fft_plain(x, line, circle, inverse))


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("batch,log_n", [
    (2, 16), (2, 18), (2, 20), (1, 21), (1, 22), (1, 24),
    (1, 12), (3, 12), (5, 12), (65, 12), (1, 14), (3, 14), (5, 14), (65, 14),
    (1, 4), (5, 7), (65, 9), (300, 3)])
def test_cfft_kernel_matches_plain_at_every_pass_count(device, batch, log_n,
                                                       inverse):
    """One, two and three passes; odd batches (a block walks over several
    columns, the last block over fewer); tiles that hold whole columns.
    The input is left as it was."""
    rng = np.random.default_rng(100 * log_n + batch)
    x, line, circle = _cfft_case(rng, batch, log_n, device)
    before = x.clone()
    buf = fft.twiddle_buffer(line, circle)
    before_launches = fft.cfft_kernel_launches()
    got = fft.cfft_cuda(x, buf, log_n, inverse)
    assert fft.cfft_kernel_launches() - before_launches \
        == len(fft.cfft_plan(log_n, inverse))
    assert [p[:4] for p in fft.cfft_kernel_plan(batch, log_n, inverse)] \
        == fft.cfft_plan(log_n, inverse)
    _exact(got, fft.fft_plain(x, line, circle, inverse))
    _exact(x, before)


@pytest.mark.parametrize("shrink", [0, 1, 2, 3])
@pytest.mark.parametrize("batch,log_n", [(3, 3), (3, 8), (5, 12), (3, 14),
                                         (2, 17), (1, 21), (1, 23)])
def test_cfft_forward_zero_extends_inside_the_kernel(device, batch, log_n,
                                                     shrink):
    """Coefficient lengths n, n/2, n/4, n/8 against the padded plain
    version; the short input is read, never written."""
    rng = np.random.default_rng(10 * log_n + shrink)
    x, line, circle = _cfft_case(rng, batch, log_n, device, log_n - shrink)
    before = x.clone()
    got = fft.cfft_cuda(x, fft.twiddle_buffer(line, circle), log_n, False,
                        coeff_len=1 << (log_n - shrink))
    padded = torch.nn.functional.pad(x, (0, (1 << log_n) - x.shape[-1]))
    _exact(got, fft.fft_plain(padded, line, circle, False))
    _exact(x, before)
    # the dispatching function infers the length from the tensor
    _exact(fft.fft_natural_to_bitrev(x, line, circle), got)


@pytest.mark.parametrize("scale", [1, P - 1, 0x12345678])
@pytest.mark.parametrize("batch,log_n", [(3, 2), (3, 9), (5, 12), (3, 15),
                                         (2, 20), (1, 23)])
def test_cfft_inverse_scales_inside_the_kernel(device, batch, log_n, scale):
    rng = np.random.default_rng(log_n + scale % 97)
    x, line, circle = _cfft_case(rng, batch, log_n, device)
    before = x.clone()
    got = fft.cfft_cuda(x, fft.twiddle_buffer(line, circle), log_n, True,
                        scale=scale)
    _exact(got, fft.fft_plain(x, line, circle, True, scale))
    _exact(x, before)
    _exact(fft.ifft_bitrev_to_natural(x, line, circle, scale=scale), got)


def test_cfft_kernel_takes_views(device):
    """A contiguous view that is not 16-byte aligned (scalar loads), and a
    strided one (copied by the dispatching function)."""
    rng = np.random.default_rng(77)
    log_n = 13
    x, line, circle = _cfft_case(rng, 2, log_n, device)
    buf = fft.twiddle_buffer(line, circle)
    flat = torch.cat([x.reshape(-1)[:1], x.reshape(-1)])
    view = flat[1:].view(2, 1 << log_n)
    assert view.data_ptr() % 16
    for inverse in (False, True):
        want = fft.fft_plain(x, line, circle, inverse)
        _exact(fft.cfft_cuda(view, buf, log_n, inverse), want)
        wide = torch.stack([x, x], dim=-1)[..., 0]  # last axis stride 2
        assert not wide.is_contiguous()
        _exact(fft._transform(wide, line, circle, buf, inverse), want)


def test_cfft_wrapper_guards(device):
    rng = np.random.default_rng(5)
    x, line, circle = _cfft_case(rng, 2, 6, device)
    buf = fft.twiddle_buffer(line, circle)
    with pytest.raises(ValueError, match="coefficient length"):
        fft.cfft_cuda(x[:, :48].contiguous(), buf, 6, False, coeff_len=48)
    with pytest.raises(ValueError, match="coefficient length"):
        fft.cfft_cuda(x[:, :32].contiguous(), buf, 6, True, coeff_len=32)
    with pytest.raises(ValueError, match="must end in"):
        fft.cfft_cuda(x, buf, 6, False, coeff_len=32)
    with pytest.raises(ValueError, match="scale"):
        fft.cfft_cuda(x, buf, 6, False, scale=5)
    with pytest.raises(ValueError, match="twiddle buffer"):
        fft.cfft_cuda(x, buf[:-1], 6, False)


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


def _program_case(kind, log, device, rng):
    """A lowered program, random card columns and its scalars."""
    from tstwo_tpu_torch.constraint_framework import InfoEvaluator
    from tstwo_tpu_torch.constraint_framework.logup import LookupElements
    from tstwo_tpu_torch.constraint_framework.program import lower
    from tstwo_tpu_torch.examples.logup_lookup import LookupEval
    from tstwo_tpu_torch.examples.wide_fibonacci import WideFibonacciEval
    from tstwo_tpu_torch.fields import QM31

    def qm31s(k):
        return [QM31.from_ints([int(v) for v in rng.integers(0, P, 4)])
                for _ in range(k)]

    if kind == "wide_fib":
        ev, params = WideFibonacciEval(log - 1, 12), []
    else:
        ev = LookupEval(log - 1, LookupElements(*qm31s(2), 1),
                        kind == "logup_pairs")
        info = InfoEvaluator(log - 1)
        ev.evaluate(info)
        params = info.secure_params
    program = lower(ev, log - 1, log)
    stacks = [_rand(rng, (c, 1 << log), device) if c else None
              for c in program.columns]
    scalars = to_torch_u32(program.scalars(
        qm31s(program.n_constraints), params, qm31s(1)[0]).view(np.uint32),
        device)
    return program, program.device_code(device), stacks, scalars


@pytest.mark.parametrize("rows_per_thread", [0, 1, 2, 4, 8])
@pytest.mark.parametrize("kind,log", [("wide_fib", 2), ("wide_fib", 5),
                                      ("wide_fib", 10), ("logup_pairs", 9),
                                      ("logup_single", 11)])
def test_constraint_eval_kernel_matches_plain(device, kind, log,
                                              rows_per_thread):
    """Tile edges (fewer rows than a tile), offset -1 masks, secure
    parameters and every rows-per-thread variant, added into a random
    accumulator."""
    rng = np.random.default_rng(log)
    program, code, stacks, scalars = _program_case(kind, log, device, rng)
    acc = _rand(rng, (4, 1 << log), device)
    want = constraint_eval.evaluate(
        code.cpu(), program.device_loads(torch.device("cpu")),
        program.n_slots, [None if s is None else s.cpu() for s in stacks],
        scalars.cpu(), program.denom_off, log - 1, log, acc.cpu())
    constraint_eval.evaluate_cuda(code, program.device_loads(device),
                                  program.n_slots, stacks, scalars,
                                  program.denom_off, log - 1, log, acc,
                                  rows_per_thread)
    _exact(acc, want)


@pytest.mark.parametrize("rows_per_thread", [0, 1, 2])
def test_constraint_eval_kernel_streams_a_long_program(device,
                                                       rows_per_thread):
    """Poseidon2's program, 19,899 instructions (more than a block's shared
    memory holds, so the kernel takes it in chunks), with offset -1 masks
    and 272 secure parameters, at 2^7 rows of a 2^5-row trace."""
    from tstwo_tpu_torch.constraint_framework import InfoEvaluator
    from tstwo_tpu_torch.constraint_framework.logup import LookupElements
    from tstwo_tpu_torch.constraint_framework.program import lower
    from tstwo_tpu_torch.examples.poseidon2 import Poseidon2Eval
    from tstwo_tpu_torch.fields import QM31

    rng = np.random.default_rng(7)
    z, alpha = (QM31.from_ints([int(v) for v in rng.integers(0, P, 4)])
                for _ in range(2))
    ev = Poseidon2Eval(5, LookupElements(z, alpha, 16))
    info = InfoEvaluator(5)
    ev.evaluate(info)
    program = lower(ev, 5, 7)
    assert len(program.code) == 19899
    stacks = [_rand(rng, (c, 1 << 7), device) if c else None
              for c in program.columns]
    coeffs = [QM31.from_ints([int(v) for v in rng.integers(0, P, 4)])
              for _ in range(program.n_constraints)]
    scalars = to_torch_u32(program.scalars(
        coeffs, info.secure_params, z).view(np.uint32), device)
    code = program.device_code(device)
    acc = _rand(rng, (4, 1 << 7), device)
    want = constraint_eval.evaluate(
        code.cpu(), program.device_loads(torch.device("cpu")),
        program.n_slots, [None if s is None else s.cpu() for s in stacks],
        scalars.cpu(), program.denom_off, 5, 7, acc.cpu())
    constraint_eval.evaluate_cuda(code, program.device_loads(device),
                                  program.n_slots, stacks, scalars,
                                  program.denom_off, 5, 7, acc,
                                  rows_per_thread)
    _exact(acc, want)


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
    leaves = pos.merkle_layer(None, [x])
    pos.merkle_layer(leaves, [])
    pos.poseidon_hash_many([leaves, leaves, leaves])  # two sponge steps
    blake2s.grind_batch(blake2s.digest_bytes_to_words(b"\x00" * 32), 0, 64,
                        1, device)
    blake2s.transcript(_rand(rng, (8,), device, 1 << 32),
                       msg=_rand(rng, (8,), device, 1 << 32), k=1)
    program, code, stacks, scalars = _program_case("wide_fib", 6, device, rng)
    constraint_eval.evaluate(code, program.device_loads(device),
                             program.n_slots, stacks, scalars,
                             program.denom_off, 5, 6,
                             _rand(rng, (4, 1 << 6), device))
    from tstwo_tpu_torch.circle import CanonicCoset
    from tstwo_tpu_torch.pcs import quotients

    cols, batches, alpha = _quotient_case(7, 2, 6, 1, device)
    quotients.quotient_rows(CanonicCoset.new(6).circle_domain(), list(cols),
                            alpha, batches)
    assert kernels.LAUNCHES == {"cfft_forward": 1, "cfft_inverse": 1,
                                "blake2s": 2, "merkle_layer": 1,
                                "merkle_tail": 1, "blake2s_grind": 1,
                                "blake2s_transcript": 1, "deinterleave": 1,
                                "m31_mul": 1, "m31_mul_chain": 1,
                                "hades_permutation": 2,
                                "poseidon_merkle_layer": 2,
                                "constraint_eval": 1,
                                "accumulate_quotients": 1}


def _grind_digests():
    """Channel digests of a few transcript states."""
    import hashlib

    return [b"\x00" * 32] + [hashlib.blake2s(bytes([i])).digest()
                              for i in range(3)]


@pytest.mark.parametrize("pow_bits", [0, 1, 8, 10, 12, 14, 16, 60])
def test_grind_kernel_matches_plain(device, pow_bits):
    """The least hit of a launch of 2^16 nonces (or -1), from several
    digests; at small pow_bits many blocks hit and the least must win."""
    for digest in _grind_digests():
        words = blake2s.digest_bytes_to_words(digest)
        want = blake2s.grind_batch_plain(words, 0, 1 << 16, pow_bits, device)
        assert blake2s.grind_batch_cuda(words, 0, 1 << 16, pow_bits,
                                        device) == want
        # a start that is no multiple of the block
        want = blake2s.grind_batch_plain(words, 1000, 3000, pow_bits, device)
        assert blake2s.grind_batch_cuda(words, 1000, 3000, pow_bits,
                                        device) == want


@pytest.mark.parametrize("start,count,pow_bits", [
    ((1 << 32) - 3, 1 << 14, 8), ((1 << 32) - 3, 2, 0),
    ((1 << 32) - 3, 1 << 16, 14), ((7 << 40) + 5, 1 << 12, 9)])
def test_grind_kernel_near_2_32_matches_plain(device, start, count, pow_bits):
    words = blake2s.digest_bytes_to_words(_grind_digests()[1])
    want = blake2s.grind_batch_plain(words, start, count, pow_bits, device)
    assert want >= 0
    assert blake2s.grind_batch_cuda(words, start, count, pow_bits,
                                    device) == want


def test_grind_on_the_card_equals_the_host(device):
    from tstwo_tpu_torch.channel.blake2s import Blake2sChannel
    from tstwo_tpu_torch.proof_of_work import grind, grind_device, grind_host

    for pow_bits in (12, 16):
        ch = Blake2sChannel()
        ch.mix_u64(pow_bits)
        before = ch.clone()
        want = grind_host(ch, pow_bits)
        kernels.reset_launches()
        assert grind(ch, pow_bits, device=device) == want
        assert kernels.LAUNCHES["blake2s_grind"] >= 1
        assert grind_device(ch, pow_bits, device, batch=1 << 10) == want
        assert ch == before


def test_grind_wrapper_guards(device):
    words = blake2s.digest_bytes_to_words(b"\x00" * 32)
    with pytest.raises(ValueError):
        blake2s.grind_batch_cuda(words, 0, 0, 1, device)
    with pytest.raises(ValueError):
        blake2s.grind_batch_cuda(words, 0, 8, 1, "cpu")


def test_prove_with_grinding_on_the_card_equals_the_cpu_prove(device):
    from tstwo_tpu_torch.examples.wide_fibonacci import prove_wide_fibonacci
    from tstwo_tpu_torch.fri import FriConfig
    from tstwo_tpu_torch.pcs import PcsConfig
    from tstwo_tpu_torch.serialize import proof_to_dict

    config = PcsConfig(16, FriConfig(0, 1, 8))
    kernels.reset_launches()
    card = proof_to_dict(prove_wide_fibonacci(8, 8, config, device=device)[0])
    assert kernels.LAUNCHES["blake2s_grind"] >= 1
    assert card == proof_to_dict(prove_wide_fibonacci(8, 8, config,
                                                      device="cpu")[0])


P252 = (1 << 251) + 17 * (1 << 192) + 1
FELT_EDGE = [0, 1, 2, P252 - 1, P252 - 2, 1 << 251, (1 << 251) - 1,
             17 << 192, (1 << 224) - 1, (1 << 32) - 1, (1 << 192) - 1,
             ((1 << 251) - 1) - (17 << 192)]


def _rand_felts(rng, n, device):
    """n felts below 2^251 (so below p) with every word random."""
    words = rng.integers(0, 1 << 32, size=(8, n), dtype=np.uint64)
    words[7] &= (1 << 19) - 1
    return to_torch_u32(words.astype(np.uint32), device)


@pytest.mark.parametrize("n", [1, 31, 1000, 4097, 1 << 16])
def test_hades_kernel_matches_plain_and_host(device, n):
    """Any batch size; the edge felts in every position of the state; a few
    states against the host's Python-int Hades as well."""
    from tstwo_tpu_torch.channel.poseidon import hades_permutation as host

    rng = np.random.default_rng(n)
    state = [_rand_felts(rng, n, device) for _ in range(3)]
    edge = pos.ints_to_felts(FELT_EDGE, device)
    for k in range(3):
        m = min(n, len(FELT_EDGE))
        state[k][:, :m] = edge.roll(k, dims=1)[:, :m]
    before = [s.clone() for s in state]
    got = pos.hades_permutation_cuda(state)
    small = [s[:, :2048] for s in state]  # the plain version is slow
    for g, w in zip(got, pos.hades_permutation_plain(small)):
        _exact(g[:, :2048], w)
    for s, b in zip(state, before):
        _exact(s, b)
    ints = [pos.felts_to_ints(s[:, :12]) for s in state]
    outs = [pos.felts_to_ints(g[:, :12]) for g in got]
    for i in range(min(n, 12)):
        assert [o[i] for o in outs] == host([v[i] for v in ints])
    # one [3, 8, n] tensor, and a view of one, are taken as well
    stacked = torch.stack(state)
    for g, w in zip(pos.hades_permutation(stacked), got):
        _exact(g, w)
    if n > 4:
        for g, w in zip(pos.hades_permutation(stacked[:, :, 1:n - 2]), got):
            _exact(g, w[:, 1:n - 2])


def test_hades_kernel_on_every_triple_of_edge_felts(device):
    """2^12 states: every ordered triple of the edge felts (1728), the rest
    seeded random felts; kernel == plain over all of them."""
    rng = np.random.default_rng(12)
    n = 1 << 12
    state = [_rand_felts(rng, n, device) for _ in range(3)]
    edge = pos.ints_to_felts(FELT_EDGE, device)
    k = len(FELT_EDGE)
    idx = torch.arange(k ** 3, device=device)
    for slot, div in enumerate((k * k, k, 1)):
        state[slot][:, :k ** 3] = edge[:, (idx // div) % k]
    got = pos.hades_permutation_cuda(state)
    for g, w in zip(got, pos.hades_permutation_plain(state)):
        _exact(g, w)


@pytest.mark.parametrize("log,n_cols,with_prev,layout", [
    (10, 3, False, "stack"), (10, 9, False, "single"), (10, 8, False, "stack"),
    (11, 0, True, "stack"), (10, 4, True, "stack"), (9, 17, True, "single"),
    (10, 40, False, "mixed"), (0, 3, False, "single"), (0, 0, True, "stack"),
    (3, 0, False, "stack"), (12, 16, True, "strided")])
def test_poseidon_layer_kernel_matches_plain(device, log, n_cols, with_prev,
                                             layout):
    """Leaves of one to five blocks, inner nodes with and without joining
    columns, the layer that hashes no value, one node; columns as one
    stack, as single columns (more than 16: concatenated by the wrapper),
    mixed, and as rows a stride apart."""
    rng = np.random.default_rng(100 * log + n_cols)
    n = 1 << log
    prev = _rand_felts(rng, 2 * n, device) if with_prev else None
    cols = _rand(rng, (n_cols, n), device)
    if layout == "stack":
        entries = [cols] if n_cols else []
    elif layout == "single":
        entries = list(cols)
    elif layout == "mixed":
        entries = [cols[:7], cols[7], cols[8:30], *cols[30:]]
    else:
        wide = _rand(rng, (n_cols, 2 * n + 6), device)
        entries = [wide[:, 3:n + 3], wide[::2, n + 5:2 * n + 5]]
    kernels.reset_launches()
    got = pos.merkle_layer_cuda(prev, entries, n, device)
    assert kernels.LAUNCHES["poseidon_merkle_layer"] == 1
    _exact(got, pos.merkle_layer_plain(prev, entries, n, device))
    _exact(pos.merkle_layer(prev, entries, n, device), got)


def test_poseidon_layer_kernel_takes_a_strided_child_layer(device):
    rng = np.random.default_rng(4)
    wide = _rand_felts(rng, 70, device)
    prev = wide[:, 3:67]
    assert not prev.is_contiguous()
    _exact(pos.merkle_layer_cuda(prev, []),
           pos.merkle_layer_plain(prev.contiguous(), []))


@pytest.mark.parametrize("size", [2, 4, 8])
def test_poseidon_tree_top_takes_the_gathered_subroot_view(device, size):
    """The top of a sharded Poseidon252 tree: the D subroots as an
    all_gather returns them ([D, 8, 1]), seen transposed ([8, D], not
    contiguous), with a whole column joining at the root, through the
    kernel and through the plain version."""
    from tstwo_tpu_torch.parallel.merkle import _commit_top
    from tstwo_tpu_torch.vcs.ops import Poseidon252MerkleOps

    rng = np.random.default_rng(size)
    view = _rand_felts(rng, size, device).t().contiguous()[:, :, None][
        :, :, 0].t()
    assert not view.is_contiguous()
    cols, logs = [_rand(rng, (3, 1), device)], [0]
    kernels.reset_launches()
    top = _commit_top(Poseidon252MerkleOps, view, cols, logs, device)
    k = size.bit_length() - 1
    assert kernels.LAUNCHES["poseidon_merkle_layer"] == k
    prev, want = view.cpu().contiguous(), []
    for log in range(k - 1, -1, -1):
        prev = pos.merkle_layer_plain(
            prev, [c.cpu() for c in cols] if log == 0 else [])
        want.append(prev)
    for got, ref in zip(top, want[::-1]):
        _exact(got, ref)


def test_poseidon_wrappers_refuse_what_the_kernels_do_not_take(device):
    x = _rand(np.random.default_rng(5), (3, 8), device)
    with pytest.raises(ValueError, match="expected \\[8\\]"):
        pos.merkle_layer_cuda(None, [x, x[:, :4]])
    with pytest.raises(TypeError, match="int32"):
        pos.merkle_layer_cuda(None, [x.to(torch.int64)])
    with pytest.raises(ValueError, match="three"):
        pos.hades_permutation_cuda([x, x])
    with pytest.raises(ValueError, match="\\[8, 2n\\]"):
        pos.merkle_layer_cuda(_rand_felts(np.random.default_rng(6), 7, device),
                              [])


@pytest.mark.parametrize("sizes", [
    [(0, 3)], [(1, 0)], [(10, 2)], [(12, 9)],
    [(11, 2), (10, 0), (6, 4), (11, 0), (2, 0), (0, 0)], [(11, 1), (3, 17)]],
    ids=str)
def test_poseidon_commit_on_the_card_equals_the_cpu_tree(device, sizes):
    """Every layer through the kernel on the card and through the plain
    version on the CPU; the openings too.  No Blake2s launch."""
    from tstwo_tpu_torch.vcs.poseidon252_merkle import Poseidon252MerkleProver

    rng = np.random.default_rng(len(sizes))
    cols = [_rand(rng, ((1 << log) if c == 0 else (c, 1 << log)), "cpu")
            for log, c in sizes]
    kernels.reset_launches()
    on_card = Poseidon252MerkleProver.commit([c.to(device) for c in cols])
    launched = {k: v for k, v in kernels.LAUNCHES.items() if v}
    assert launched == {"poseidon_merkle_layer": len(on_card.layers)}
    on_cpu = Poseidon252MerkleProver.commit(cols)
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


def test_empty_poseidon_commit_on_the_card(device):
    from tstwo_tpu_torch.vcs.poseidon252_merkle import (
        Poseidon252MerkleProver, hash_node)

    tree = Poseidon252MerkleProver.commit([], device)
    assert tree.layers[0].device.type == "cuda"
    assert tree.root() == hash_node(None, [])


def test_poseidon_prove_on_the_card_equals_the_cpu_prove(device):
    from tstwo_tpu_torch.examples.basic_air import (prove_basic_air,
                                                    verify_basic_air)

    kernels.reset_launches()
    proof, component, config = prove_basic_air(5, device=device,
                                               flavor="poseidon252")
    assert kernels.LAUNCHES["poseidon_merkle_layer"] > 0
    assert kernels.LAUNCHES["blake2s"] == kernels.LAUNCHES["merkle_layer"] \
        == kernels.LAUNCHES["merkle_tail"] == 0
    verify_basic_air(proof, component, config, 5, flavor="poseidon252")
    cpu = prove_basic_air(5, device="cpu", flavor="poseidon252")[0]
    a, b = proof.commitment_scheme_proof, cpu.commitment_scheme_proof
    assert list(a.commitments) == list(b.commitments)
    assert [d.hash_witness for d in a.decommitments] == \
        [d.hash_witness for d in b.decommitments]
    assert a.proof_of_work == b.proof_of_work
    assert a.fri_proof.first_layer.commitment == \
        b.fri_proof.first_layer.commitment
    assert [l.commitment for l in a.fri_proof.inner_layers] == \
        [l.commitment for l in b.fri_proof.inner_layers]


# -- the device transcript ----------------------------------------------------

def _transcript_case(seed, msg_words, device):
    rng = np.random.default_rng(seed)
    digest = _rand(rng, (8,), device, 1 << 32)
    n_sent = _rand(rng, (2,), device, 1 << 32)
    msg = None if msg_words is None else _rand(rng, (msg_words,), device,
                                               1 << 32)
    return digest, n_sent, msg


def _cpu(t):
    return None if t is None else t.cpu()


@pytest.mark.parametrize("msg_bytes", [None, 0, 3, 8, 32, 33, 64, 100])
@pytest.mark.parametrize("k", [0, 1, 2, 5])
def test_transcript_kernel_matches_plain(device, msg_bytes, k):
    digest, n_sent, msg = _transcript_case(
        10 * k + (msg_bytes or 0), None if msg_bytes is None
        else -(-msg_bytes // 4) + 1, device)
    got = blake2s.transcript_cuda(digest, n_sent, msg, msg_bytes, k)
    want = blake2s.transcript_plain(_cpu(digest), _cpu(n_sent), _cpu(msg),
                                    msg_bytes, k)
    for g, w in zip(got, want):
        _exact(g, w)


@pytest.mark.parametrize("k", [1, 3])
def test_transcript_kernel_rejects_the_rejecting_state(device, k):
    """Zero digest, n_sent 238,210,102: word 3 of that draw is 0xFFFFFFFE."""
    digest = torch.zeros(8, dtype=torch.int32, device=device)
    n_sent = torch.tensor([238_210_102, 0], dtype=torch.int32, device=device)
    got = blake2s.transcript_cuda(digest, n_sent, k=k)
    want = blake2s.transcript_plain(digest.cpu(), n_sent.cpu(), k=k)
    for g, w in zip(got, want):
        _exact(g, w)
    assert got[1].cpu().tolist() == [238_210_102 + 1 + k, 0]


def test_transcript_kernel_reads_a_root_in_its_layer(device):
    """The root of a tree whose top came from merkle_tail: a column of a
    wider buffer, its words a stride apart."""
    rng = np.random.default_rng(4)
    digest = _rand(rng, (8,), device, 1 << 32)
    layer = _rand(rng, (8, 7), device, 1 << 32)
    root = layer[:, 0]
    assert not root.is_contiguous()
    got = blake2s.transcript_cuda(digest, msg=root, k=1)
    want = blake2s.transcript_plain(digest.cpu(), msg=root.cpu(), k=1)
    for g, w in zip(got, want):
        _exact(g, w)


def test_transcript_wrapper_guards(device):
    digest = torch.zeros(8, dtype=torch.int32, device=device)
    with pytest.raises(ValueError):
        blake2s.transcript_cuda(digest)  # neither a message nor n_sent
    with pytest.raises(ValueError):
        blake2s.transcript_cuda(digest, msg=digest, msg_bytes=33)
    with pytest.raises(ValueError):
        blake2s.transcript_cuda(digest, msg=digest.cpu())


def test_device_channel_on_the_card_equals_the_cpu(device):
    from tstwo_tpu_torch.channel import device as dev

    rng = np.random.default_rng(5)
    digest, n_sent, root = _transcript_case(5, 8, device)
    felts = _rand(rng, (3, 4), device)
    cases = [
        lambda d, n, r, f: dev.mix_root(d, r),
        lambda d, n, r, f: dev.mix_root_and_draw_felt(d, r),
        lambda d, n, r, f: dev.mix_u64(d, (1 << 40) + 9),
        lambda d, n, r, f: dev.mix_u64(d, r[:2]),
        lambda d, n, r, f: dev.mix_felts(d, f),
        lambda d, n, r, f: dev.draw_base_felts(d, n),
        lambda d, n, r, f: dev.draw_felt(d, n),
        lambda d, n, r, f: dev.draw_felts(d, n, 5)]
    for case in cases:
        got = case(digest, n_sent, root, felts)
        want = case(digest.cpu(), n_sent.cpu(), root.cpu(), felts.cpu())
        for g, w in zip(got, want):
            _exact(g, w)


def test_lazy_device_digest_on_the_card(device):
    from tstwo_tpu_torch.channel.blake2s import Blake2sChannel

    root = _rand(np.random.default_rng(6), (8,), device, 1 << 32)
    lazy, host = Blake2sChannel(), Blake2sChannel()
    kernels.reset_launches()
    lazy.mix_root_device(root)
    assert kernels.LAUNCHES["blake2s_transcript"] == 1
    assert lazy._device_digest.device.type == "cuda"
    host.mix_root(blake2s.digest_words_to_bytes(root.cpu().numpy()))
    assert lazy == host
    assert lazy.draw_felt() == host.draw_felt()


@pytest.mark.parametrize("log_degrees", [[9, 8], [12]])
def test_fri_commit_on_the_card_equals_commit_host_without_a_sync(
        device, log_degrees):
    """`commit` == `commit_host` on the card, and its dispatch part makes
    no synchronising call: launches only, under sync debug mode "error"."""
    from tstwo_tpu_torch import fri
    from tstwo_tpu_torch.channel.blake2s import Blake2sChannel
    from tstwo_tpu_torch.circle import CanonicCoset
    from tstwo_tpu_torch.poly.circle_poly import SecureCirclePoly
    from tstwo_tpu_torch.poly.twiddles import precompute_twiddles

    rng = np.random.default_rng(sum(log_degrees))
    cols = [SecureCirclePoly(_rand(rng, (4, 1 << d), device)).evaluate(
        CanonicCoset.new(d + 1).circle_domain()) for d in log_degrees]
    tree = precompute_twiddles(cols[0].domain.half_coset)
    config = fri.FriConfig(0, 1, 3)
    host_ch, ch = Blake2sChannel(), Blake2sChannel()
    host = fri.FriProver.commit_host(host_ch, config, cols, tree)
    fri.FriProver.commit(Blake2sChannel(), config, cols, tree)  # warm
    torch.cuda.synchronize()
    kernels.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        finish = fri.FriProver.commit_dispatch(ch, config, cols, tree)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    prover = finish()
    assert kernels.LAUNCHES["blake2s_transcript"] == 1 + len(
        prover.inner_layers)
    assert ch == host_ch
    assert [l.merkle_tree.root() for l in prover.inner_layers] == [
        l.merkle_tree.root() for l in host.inner_layers]
    assert prover.first_layer.merkle_tree.root() == \
        host.first_layer.merkle_tree.root()
    assert prover.last_layer_poly.coeffs == host.last_layer_poly.coeffs


def _quotient_case(seed, k, log, n_batches, device, every=3, shuffle=False,
                   base_point=False):
    """k random card columns of 2^log values and their sample batches:
    every column at z, every `every`-th column also at z - g, and for
    each further batch every column at z + b g; `base_point`: the last
    batch at a point of the base field (all its denominators 0)."""
    from tstwo_tpu_torch.channel.blake2s import Blake2sChannel
    from tstwo_tpu_torch.circle import CanonicCoset, CirclePoint
    from tstwo_tpu_torch.fields import QM31
    from tstwo_tpu_torch.pcs.quotients import ColumnSampleBatch, PointSample

    rng = np.random.default_rng(seed)
    gen = torch.Generator(device).manual_seed(seed)
    cols = torch.randint(0, P, (k, 1 << log), dtype=torch.int32,
                         device=device, generator=gen)
    z = CirclePoint.get_random_point(Blake2sChannel())
    g = CanonicCoset.new(log).step().into_ef(QM31.from_base)
    points = [z, z - g]
    for _ in range(n_batches - 2):
        points.append(points[-1] + g if len(points) > 2 else z + g)
    if base_point:
        points[n_batches - 1] = CanonicCoset.new(log).at(1).into_ef(
            QM31.from_base)

    def value():
        return QM31.from_ints([int(v) for v in rng.integers(0, P, 4)])

    samples = [[PointSample(points[0], value())] for _ in range(k)]
    for b in range(1, n_batches):
        for i in range(k):
            if b > 1 or i % every == 0:
                samples[i].append(PointSample(points[b], value()))
    batches = ColumnSampleBatch.new_vec(samples)
    if shuffle:
        for b in batches:
            order = rng.permutation(len(b.columns_and_values))
            b.columns_and_values = [b.columns_and_values[i] for i in order]
    alpha = value()
    return cols, batches, alpha


def _quotients_plain(cols, batches, alpha, log, device):
    from tstwo_tpu_torch.circle import CanonicCoset
    from tstwo_tpu_torch.pcs import quotients

    xs, ys = quotients.domain_points_bitrev(
        CanonicCoset.new(log).circle_domain(), device)
    return quotients._accumulate_rows(cols, xs, ys, batches, alpha)


@pytest.mark.parametrize("k,log,n_batches,every,shuffle,size", [
    (1, 4, 1, 3, False, 1), (3, 4, 2, 3, False, 1), (3, 5, 6, 2, True, 1),
    (1, 13, 2, 1, False, 2), (3, 16, 2, 3, True, 4), (104, 21, 1, 3, False, 1),
    (104, 22, 2, 3, False, 2), (4, 20, 1, 3, False, 1), (4, 22, 1, 3, False, 1),
    (1300, 18, 2, 325, False, 1), (1300, 18, 2, 1, True, 2),
    (1300, 4, 2, 1, False, 1)])
def test_quotients_kernel_matches_plain(device, k, log, n_batches, every,
                                        shuffle, size):
    """K = 1 to 1300 columns of 2^4 to 2^22 values; one, two and six
    batches (two joint inversions); entries past one chunk of shared
    memory (1300 columns in both batches); each rank's slice of a mesh of
    `size`, told its first row."""
    from tstwo_tpu_torch.circle import CanonicCoset
    from tstwo_tpu_torch.pcs import quotients

    cols, batches, alpha = _quotient_case(100 * log + k, k, log, n_batches,
                                          device, every, shuffle)
    domain = CanonicCoset.new(log).circle_domain()
    want = _quotients_plain(cols, batches, alpha, log, device)
    m = (1 << log) // size
    for rank in range(size):
        before = kernels.LAUNCHES["accumulate_quotients"]
        got = quotients.accumulate_quotients_cuda(
            domain, list(cols[:, rank * m:(rank + 1) * m]), alpha, batches,
            row0=rank * m)
        assert kernels.LAUNCHES["accumulate_quotients"] == before + 1
        _exact(got, want[:, rank * m:(rank + 1) * m])


def test_quotients_kernel_takes_zero_denominators(device):
    """A batch at a point of the base field: every denominator 0, its
    inverse 0 (the plain version's convention), beside a sound batch in
    the same joint inversion."""
    from tstwo_tpu_torch.circle import CanonicCoset
    from tstwo_tpu_torch.pcs import quotients

    cols, batches, alpha = _quotient_case(5, 3, 8, 3, device,
                                          base_point=True)
    got = quotients.accumulate_quotients_cuda(
        CanonicCoset.new(8).circle_domain(), list(cols), alpha, batches)
    _exact(got, _quotients_plain(cols, batches, alpha, 8, device))


def test_quotients_wrapper_refuses_what_the_kernel_does_not_take(device):
    from tstwo_tpu_torch.circle import CanonicCoset
    from tstwo_tpu_torch.pcs import quotients

    cols, batches, alpha = _quotient_case(6, 2, 6, 1, device)
    domain = CanonicCoset.new(6).circle_domain()

    def call(columns, bs=batches, row0=0, dom=domain):
        quotients.accumulate_quotients_cuda(dom, columns, alpha, bs, row0)

    with pytest.raises(ValueError, match="CUDA"):
        call([cols[0].cpu(), cols[1]])
    with pytest.raises(ValueError, match="contiguous"):
        call([cols[0], torch.stack([cols[1], cols[1]], 1).reshape(-1)[::2]])
    wide = torch.zeros(65, dtype=torch.int32, device=device)
    with pytest.raises(ValueError, match="16-byte"):
        call([cols[0], wide[1:]])
    with pytest.raises(ValueError, match="expected \\[64\\]"):
        call([cols[0], cols[1, :32]])
    with pytest.raises(ValueError, match="power of two"):
        call([cols[0, 16:48], cols[1, 16:48]], row0=16)
    many = batches * 65
    with pytest.raises(ValueError, match="sample batches"):
        call(list(cols), bs=many)
