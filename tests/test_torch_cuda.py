"""The CUDA kernels against their plain PyTorch versions on the card
(tolerance 0): at edge shapes the main path does not reach, and at every
shape of chip_smoke.py's kernel table (tests/torch_cuda_cases.py builds
the inputs of both).

Needs a CUDA GPU and skips without one.  The GPU machine has no JAX, so
run this file there without the suite's conftest (which imports jax) and
its xdist options:

    python -m pytest -o addopts="" --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch
import torch_cuda_cases as cases

from tstwo_tpu_torch import kernels
from tstwo_tpu_torch.lookups import gkr_kernels
from tstwo_tpu_torch.ops import (blake2s, constraint_eval, fft, fri_ops,
                                 m31_kernels)
from tstwo_tpu_torch.ops import poseidon252 as pos

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda", 0)


def _exact(got, want):
    assert cases.max_abs_err(got, want) == 0


@pytest.mark.parametrize("row", cases.ROWS,
                         ids=lambda row: f"{row.name} {row.shape}")
def test_kernel_matches_plain_at_a_timed_shape(device, row):
    """The shapes the proves give the kernels, which chip_smoke.py times,
    and the cost its bound reads (a CFFT's passes: `cfft_passes`)."""
    case = row.build(device)
    want = case.plain()
    _exact(case.kernel(), want)
    case.cost(want)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("log_n", [1, 2, 3, 5, 10, 11, 12, 13, 15])
def test_cfft_kernel_matches_plain(device, log_n, inverse):
    """Any twiddles: the kernel's windows, its contiguous/strided split
    and buffer offsets against the layered plain version."""
    case = cases.cfft_case(3, log_n, device, inverse=inverse, seed=log_n)
    _exact(case.kernel(), case.plain())


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("batch,log_n", [
    (2, 16), (2, 18), (2, 20), (1, 21), (1, 22), (1, 24),
    (1, 12), (3, 12), (5, 12), (65, 12), (1, 14), (3, 14), (5, 14), (65, 14),
    (1, 4), (5, 7), (65, 9), (300, 3)])
def test_cfft_kernel_matches_plain_at_every_pass_count(device, batch, log_n,
                                                       inverse):
    """One, two and three passes (at most 1 / 2 / 3 up to 2^11 / 2^22 /
    2^30 points); odd batches (a block walks over several columns, the
    last block over fewer); tiles that hold whole columns.  The input is
    left as it was."""
    case = cases.cfft_case(batch, log_n, device, inverse=inverse,
                           seed=100 * log_n + batch)
    before = case.x.clone()
    cases.cfft_passes(case)
    _exact(case.kernel(), case.plain())
    _exact(case.x, before)


@pytest.mark.parametrize("shrink", [0, 1, 2, 3])
@pytest.mark.parametrize("batch,log_n", [(3, 3), (3, 8), (5, 12), (3, 14),
                                         (2, 17), (1, 21), (1, 23)])
def test_cfft_forward_zero_extends_inside_the_kernel(device, batch, log_n,
                                                     shrink):
    """Coefficient lengths n, n/2, n/4, n/8 against the padded plain
    version; the short input is read, never written."""
    case = cases.cfft_case(batch, log_n, device, log_n - shrink,
                           seed=10 * log_n + shrink)
    before = case.x.clone()
    got = case.kernel()
    _exact(got, case.plain())
    _exact(case.x, before)
    # the dispatching function infers the length from the tensor
    _exact(fft.fft_natural_to_bitrev(case.x, case.line, case.circle), got)


@pytest.mark.parametrize("scale", [1, cases.P - 1, 0x12345678])
@pytest.mark.parametrize("batch,log_n", [(3, 2), (3, 9), (5, 12), (3, 15),
                                         (2, 20), (1, 23)])
def test_cfft_inverse_scales_inside_the_kernel(device, batch, log_n, scale):
    case = cases.cfft_case(batch, log_n, device, inverse=True, scale=scale,
                           seed=log_n + scale % 97)
    before = case.x.clone()
    got = case.kernel()
    _exact(got, case.plain())
    _exact(case.x, before)
    _exact(fft.ifft_bitrev_to_natural(case.x, case.line, case.circle,
                                      scale=scale), got)


def test_cfft_kernel_takes_views(device):
    """A contiguous view that is not 16-byte aligned (scalar loads), and a
    strided one (copied by the dispatching function)."""
    log_n = 13
    case = cases.cfft_case(2, log_n, device, seed=77)
    x, line, circle, buf = case.x, case.line, case.circle, case.buf
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
    case = cases.cfft_case(2, 6, device, seed=5)
    x, buf = case.x, case.buf
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
    total = max(1, -(-byte_len // 64)) * 16
    case = cases.blake2s_case(total, n, byte_len, device, seed=n + byte_len,
                              random_tail=True)
    _exact(case.kernel(), case.plain())


@pytest.mark.parametrize("words,byte_len", [(1, 4), (15, 60), (17, 128),
                                            (0, 0), (5, 64)])
def test_blake2s_kernel_takes_fewer_words_than_its_blocks(device, words,
                                                          byte_len):
    """Words past those given are zero constants in the kernel."""
    case = cases.blake2s_case(words, 300, byte_len, device, seed=words,
                              random_tail=True)
    _exact(case.kernel(), case.plain())
    with pytest.raises(ValueError, match="more words"):
        blake2s.hash_words_major_cuda(
            cases.rand(np.random.default_rng(0), (17, 4), device), 64)


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
    case = cases.merkle_layer_case(n, entries, with_prev, device,
                                   seed=n + len(entries))
    _exact(case.kernel(), case.plain())


def test_merkle_layer_kernel_reads_views_where_they_lie(device):
    rng = np.random.default_rng(21)
    n = 512
    flat = cases.rand(rng, (1 + 16 * n,), device, 1 << 32)
    prev = flat[1:].view(8, 2 * n)  # 4-byte but not 8-byte aligned
    assert prev.data_ptr() % 8
    big = cases.rand(rng, (9, 3 * n + 1), device)
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
    for offset in (0, 1):
        case = cases.merkle_tail_case(log, device, offset, seed=log)
        got, want = case.kernel(), case.plain()
        assert len(got) == len(want) == log
        _exact(got, want)


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
    cols = [cases.rand(rng, ((1 << log) if c == 0 else (c, 1 << log)), "cpu")
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
    case = cases.deinterleave_case(shape, device, seed=len(shape))
    got = case.kernel()
    assert all(g.is_contiguous() for g in got)
    _exact(got, case.plain())


@pytest.mark.parametrize("offset", [1, 2, 3, 4])
@pytest.mark.parametrize("n", [64, 66, 1 << 14])
def test_deinterleave_kernel_takes_a_view_at_any_offset(device, offset, n):
    """Contiguous views 4, 8 and 16-byte aligned: the kernel's 16-byte and
    8-byte paths and the wrapper's copy."""
    base = cases.rand(np.random.default_rng(9), (offset + n,), device)
    x = base[offset:]
    assert x.data_ptr() % 16 == 4 * offset % 16
    for got, want in zip(fri_ops.deinterleave_cuda(x),
                         fri_ops.deinterleave_plain(x)):
        _exact(got, want.contiguous())


@pytest.mark.parametrize("reps", [0, 1, 5, 8])
@pytest.mark.parametrize("n", [1, 1000, 1024, 4097])
def test_m31_kernels_match_plain_on_edge_values(device, n, reps):
    """Any N (no N % 1024 tiling), the edge values of the Pallas tests."""
    for r in (None, reps):
        case = cases.m31_case(n, device, r, edge=True)
        _exact(case.kernel(), case.plain())


def test_m31_kernels_match_plain_on_random_values(device):
    for reps in (None, 8):
        case = cases.m31_case((1 << 20) + 3, device, reps, seed=12)
        _exact(case.kernel(), case.plain())


@pytest.mark.parametrize("rows_per_thread", [0, 1, 2, 4, 8])
@pytest.mark.parametrize("kind,log", [("wide_fib", 2), ("wide_fib", 5),
                                      ("wide_fib", 10), ("logup_pairs", 9),
                                      ("logup_single", 11), ("offsets", 2),
                                      ("offsets", 5), ("offsets", 9)])
def test_constraint_eval_kernel_matches_plain(device, kind, log,
                                              rows_per_thread):
    """Tile edges (fewer rows than a tile), offset -1 masks (and 1, 2:
    `offsets`), secure parameters, constants and every rows-per-thread
    variant, added into a random accumulator."""
    case = cases.program_case(kind, log - 1, device, seed=log)
    _exact(case.kernel(rows_per_thread), case.plain())


@pytest.mark.parametrize("rows_per_thread", [1, 2, 4, 8])
@pytest.mark.parametrize("row", cases.LOGUP_PROGRAMS
                         + (cases.WIDE_FIB_PROGRAM,),
                         ids=lambda row: row.shape)
def test_constraint_eval_kernel_matches_plain_at_every_rows_per_thread(
        device, row, rows_per_thread):
    """The timed programs (chip_smoke.py times each variant)."""
    case = row.build(device)
    _exact(case.kernel(rows_per_thread), case.plain())


@pytest.mark.parametrize("rows_per_thread", [0, 1, 2])
def test_constraint_eval_kernel_streams_a_long_program(device,
                                                       rows_per_thread):
    """Poseidon2's program, 19,899 instructions (more than a block's shared
    memory holds, so the kernel takes it in chunks), with offset -1 masks
    and 272 secure parameters, at 2^7 rows of a 2^5-row trace."""
    case = cases.program_case("poseidon2", 5, device, expand=2, seed=7)
    assert len(case.code) == 19899
    _exact(case.kernel(rows_per_thread), case.plain())


def test_dispatch_sends_cuda_tensors_to_the_kernels(device):
    rng = np.random.default_rng(3)
    kernels.reset_launches()
    x = cases.rand(rng, (2, 1 << 6), device)
    line = [cases.rand(rng, (64 >> (l + 1),), device) for l in range(1, 6)]
    fft.fft_natural_to_bitrev(x, line, cases.rand(rng, (32,), device))
    fft.ifft_bitrev_to_natural(x, line, cases.rand(rng, (32,), device))
    blake2s.hash_words_major(cases.rand(rng, (8, 16), device, 1 << 32), 32)
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
    pos.poseidon_grind_batch(5, 0, 64, 1, device)
    blake2s.transcript(cases.rand(rng, (8,), device, 1 << 32),
                       msg=cases.rand(rng, (8,), device, 1 << 32), k=1)
    c = cases.program_case("wide_fib", 5, device)
    constraint_eval.evaluate(c.code, c.program.device_loads(device),
                             c.program.n_slots, c.stacks, c.scalars,
                             c.program.denom_off, 5, 6, c.acc)
    from tstwo_tpu_torch.pcs import quotients

    q = cases.quotient_case(2, 6, 1, device, seed=7)
    quotients.quotient_rows(q.domain, list(q.cols), q.alpha, q.batches)
    g = cases.gkr_round_sums_case("LogUpGeneric", 4, device, seed=8)
    gkr_kernels.round_sums(g.kind, g.eq_arr, g.cols, g.lam)
    gkr_kernels.fold(g.cols[0], g.lam)
    gkr_kernels.fold(x[0], g.lam)  # base-field values
    assert kernels.LAUNCHES == {"cfft_forward": 1, "cfft_inverse": 1,
                                "blake2s": 2, "merkle_layer": 1,
                                "merkle_tail": 1, "blake2s_grind": 1,
                                "blake2s_transcript": 1, "deinterleave": 1,
                                "m31_mul": 1, "m31_mul_chain": 1,
                                "hades_permutation": 2,
                                "poseidon_merkle_layer": 2,
                                "poseidon_grind": 1, "constraint_eval": 1,
                                "accumulate_quotients": 1,
                                "gkr_round_sums": 1, "mle_fold": 2}


@pytest.mark.parametrize("pow_bits", [0, 1, 8, 10, 12, 14, 16, 60])
def test_grind_kernel_matches_plain(device, pow_bits):
    """The least hit of a launch of 2^16 nonces (or -1), from several
    channel states; at small pow_bits many blocks hit and the least must
    win; and from a start that is no multiple of the block."""
    for label, _ in cases.grind_digests():
        for start, count in ((0, 1 << 16), (1000, 3000)):
            case = cases.grind_case(label, pow_bits, start, count, device)
            _exact(case.kernel(), case.plain())


@pytest.mark.parametrize("start,count,pow_bits", [
    ((1 << 32) - 3, 1 << 14, 8), ((1 << 32) - 3, 2, 0),
    ((1 << 32) - 3, 1 << 16, 14), ((7 << 40) + 5, 1 << 12, 9)])
def test_grind_kernel_near_2_32_matches_plain(device, start, count, pow_bits):
    case = cases.grind_case("mix_u64", pow_bits, start, count, device)
    want = case.plain()
    assert int(want) >= 0
    _exact(case.kernel(), want)


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


@pytest.mark.parametrize("label,pow_bits,start,count", [
    ("mix_u64", 6, 0, 1 << 12),           # the hit in the first block
    ("mix_root", 3, 0, 1 << 12),          # hits in every block: the least
    ("fresh", 12, (1 << 32) - 3, 1 << 12),  # the hit past nonce 2^32
    ("mix_u64", 12, 1000, 3000),          # a start no multiple of a block
    ("fresh", 40, 0, 1 << 10),            # no hit: -1
])
def test_poseidon_grind_kernel_matches_plain(device, label, pow_bits, start,
                                             count):
    case = cases.poseidon_grind_case(label, pow_bits, start, count, device)
    want = case.plain()
    assert (int(want) >= 1 << 32) == (start > 1 << 31)
    assert (int(want) < 0) == (pow_bits == 40)
    _exact(case.kernel(), want)


def test_poseidon_grind_on_the_card_equals_the_host(device):
    from tstwo_tpu_torch.channel.poseidon import (FieldElement252,
                                                  Poseidon252Channel)
    from tstwo_tpu_torch.proof_of_work import grind, grind_device, grind_host

    for label, digest in cases.poseidon_grind_digests():
        for pow_bits in (12, 16):
            ch = Poseidon252Channel(FieldElement252(digest))
            before = ch.clone()
            want = grind_host(ch, pow_bits)
            kernels.reset_launches()
            assert grind(ch, pow_bits, device=device) == want
            assert kernels.LAUNCHES["poseidon_grind"] == 1
            assert grind_device(ch, pow_bits, device, batch=1 << 8) == want
            assert kernels.LAUNCHES["poseidon_grind"] == 1 + want // 256 + 1
            assert ch == before


def test_poseidon_grind_wrapper_guards(device):
    with pytest.raises(ValueError):
        pos.poseidon_grind_hit_cuda(5, 0, 0, 1, device)
    with pytest.raises(ValueError):
        pos.poseidon_grind_hit_cuda(cases.P252, 0, 8, 1, device)
    with pytest.raises(ValueError):
        pos.poseidon_grind_hit_cuda(5, 0, 8, 1, "cpu")


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


@pytest.mark.parametrize("n", [1, 31, 1000, 4097, 1 << 16])
def test_hades_kernel_matches_plain_and_host(device, n):
    """Any batch size; the edge felts in every position of the state; a few
    states against the host's Python-int Hades as well."""
    from tstwo_tpu_torch.channel.poseidon import hades_permutation as host

    case = cases.hades_case(n, device, seed=n)
    state = case.state
    before = [s.clone() for s in state]
    got = case.kernel()
    _exact(got, case.plain())
    _exact(state, before)
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
    state = [cases.rand_felts(rng, n, device) for _ in range(3)]
    edge = pos.ints_to_felts(cases.FELT_EDGE, device)
    k = len(cases.FELT_EDGE)
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
    case = cases.poseidon_layer_case(log, n_cols, with_prev, device, layout,
                                     seed=100 * log + n_cols)
    kernels.reset_launches()
    got = case.kernel()
    assert kernels.LAUNCHES["poseidon_merkle_layer"] == 1
    _exact(got, case.plain())
    _exact(pos.merkle_layer(case.prev, case.entries, case.n, device), got)


def test_poseidon_layer_kernel_takes_a_strided_child_layer(device):
    rng = np.random.default_rng(4)
    wide = cases.rand_felts(rng, 70, device)
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
    view = cases.rand_felts(rng, size, device).t().contiguous()[:, :, None][
        :, :, 0].t()
    assert not view.is_contiguous()
    cols, logs = [cases.rand(rng, (3, 1), device)], [0]
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
    x = cases.rand(np.random.default_rng(5), (3, 8), device)
    with pytest.raises(ValueError, match="expected \\[8\\]"):
        pos.merkle_layer_cuda(None, [x, x[:, :4]])
    with pytest.raises(TypeError, match="int32"):
        pos.merkle_layer_cuda(None, [x.to(torch.int64)])
    with pytest.raises(ValueError, match="three"):
        pos.hades_permutation_cuda([x, x])
    with pytest.raises(ValueError, match="\\[8, 2n\\]"):
        pos.merkle_layer_cuda(
            cases.rand_felts(np.random.default_rng(6), 7, device), [])


@pytest.mark.parametrize("sizes", [
    [(0, 3)], [(1, 0)], [(10, 2)], [(12, 9)],
    [(11, 2), (10, 0), (6, 4), (11, 0), (2, 0), (0, 0)], [(11, 1), (3, 17)]],
    ids=str)
def test_poseidon_commit_on_the_card_equals_the_cpu_tree(device, sizes):
    """Every layer through the kernel on the card and through the plain
    version on the CPU; the openings too.  No Blake2s launch."""
    from tstwo_tpu_torch.vcs.poseidon252_merkle import Poseidon252MerkleProver

    rng = np.random.default_rng(len(sizes))
    cols = [cases.rand(rng, ((1 << log) if c == 0 else (c, 1 << log)), "cpu")
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

@pytest.mark.parametrize("msg_bytes", [None, 0, 3, 8, 32, 33, 64, 100])
@pytest.mark.parametrize("k", [0, 1, 2, 5])
def test_transcript_kernel_matches_plain(device, msg_bytes, k):
    """Draws from a random 64-bit n_sent, or a mix of 0 to 100 bytes."""
    case = cases.transcript_case(
        None if msg_bytes is None else -(-msg_bytes // 4) + 1, msg_bytes, k,
        device, seed=10 * k + (msg_bytes or 0))
    _exact(case.kernel(), case.plain())


@pytest.mark.parametrize("k", [1, 3])
def test_transcript_kernel_rejects_the_rejecting_state(device, k):
    """Zero digest, n_sent 238,210,102: word 3 of that draw is 0xFFFFFFFE."""
    case = cases.transcript_case(None, None, k, device, rejecting=True)
    got = case.kernel()
    _exact(got, case.plain())
    assert got[1].cpu().tolist() == [cases.REJECTING_N_SENT + 1 + k, 0]


def test_transcript_kernel_reads_a_root_in_its_layer(device):
    """The root of a tree whose top came from merkle_tail: a column of a
    wider buffer, its words a stride apart."""
    case = cases.transcript_case(8, None, 1, device, seed=4, strided=True)
    assert not case.msg.is_contiguous()
    _exact(case.kernel(), case.plain())


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

    case = cases.transcript_case(8, None, 0, device, seed=5)
    digest, n_sent, root = case.digest, case.n_sent, case.msg
    felts = cases.rand(np.random.default_rng(5), (3, 4), device)
    steps = [
        lambda d, n, r, f: dev.mix_root(d, r),
        lambda d, n, r, f: dev.mix_root_and_draw_felt(d, r),
        lambda d, n, r, f: dev.mix_u64(d, (1 << 40) + 9),
        lambda d, n, r, f: dev.mix_u64(d, r[:2]),
        lambda d, n, r, f: dev.mix_felts(d, f),
        lambda d, n, r, f: dev.draw_base_felts(d, n),
        lambda d, n, r, f: dev.draw_felt(d, n),
        lambda d, n, r, f: dev.draw_felts(d, n, 5)]
    for step in steps:
        got = step(digest, n_sent, root, felts)
        want = step(digest.cpu(), n_sent.cpu(), root.cpu(), felts.cpu())
        for g, w in zip(got, want):
            _exact(g, w)


def test_lazy_device_digest_on_the_card(device):
    from tstwo_tpu_torch.channel.blake2s import Blake2sChannel

    root = cases.rand(np.random.default_rng(6), (8,), device, 1 << 32)
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
    cols = [SecureCirclePoly(cases.rand(rng, (4, 1 << d), device)).evaluate(
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
    from tstwo_tpu_torch.pcs import quotients

    case = cases.quotient_case(k, log, n_batches, device, every, shuffle,
                               seed=100 * log + k)
    want = case.plain()
    m = (1 << log) // size
    for rank in range(size):
        before = kernels.LAUNCHES["accumulate_quotients"]
        got = quotients.accumulate_quotients_cuda(
            case.domain, list(case.cols[:, rank * m:(rank + 1) * m]),
            case.alpha, case.batches, row0=rank * m)
        assert kernels.LAUNCHES["accumulate_quotients"] == before + 1
        _exact(got, want[:, rank * m:(rank + 1) * m])


def test_quotients_kernel_takes_zero_denominators(device):
    """A batch at a point of the base field: every denominator 0, its
    inverse 0 (the plain version's convention), beside a sound batch in
    the same joint inversion."""
    case = cases.quotient_case(3, 8, 3, device, base_point=True, seed=5)
    _exact(case.kernel(), case.plain())


def test_quotients_wrapper_refuses_what_the_kernel_does_not_take(device):
    from tstwo_tpu_torch.pcs import quotients

    case = cases.quotient_case(2, 6, 1, device, seed=6)
    cols, batches, alpha, domain = (case.cols, case.batches, case.alpha,
                                    case.domain)

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


# -- GKR sum-check rounds (csrc/gkr.cu) ----------------------------------------

GKR_KINDS = list(cases.GKR_COLUMNS)


@pytest.mark.parametrize("longer_eq", [False, True])
@pytest.mark.parametrize("n_terms", [1, 2, 1 << 10, 1 << 18])
@pytest.mark.parametrize("kind", GKR_KINDS)
def test_gkr_round_sums_kernel_matches_plain(device, kind, n_terms,
                                             longer_eq):
    """Every layer kind at 1, 2, 2^10 and 2^18 terms (one block to the
    whole grid), over an eq table of n_terms entries or over the prefix
    of one four times as long (a view whose rows lie 4 n_terms apart)."""
    case = cases.gkr_round_sums_case(kind, n_terms, device,
                                     eq_len=4 * n_terms if longer_eq else None,
                                     seed=n_terms + GKR_KINDS.index(kind))
    _exact(case.kernel(), case.plain())


@pytest.mark.parametrize("kind", GKR_KINDS)
def test_gkr_round_sums_kernel_at_the_largest_values(device, kind):
    """Every value P - 1, lambda too: the largest products and sums."""
    from tstwo_tpu_torch.fields import QM31

    lam = QM31.from_ints([cases.P - 1] * 4)
    case = cases.gkr_round_sums_case(kind, 1 << 12, device, lam=lam)
    for t in (case.eq_arr, *case.cols):
        t.fill_(cases.P - 1)
    _exact(case.kernel(), case.plain())


def test_gkr_round_sums_kernel_reads_layers_where_they_lie(device):
    """Layer columns that are row slices of a wider buffer (read in
    place) and columns whose points lie two words apart (copied)."""
    n = 1 << 9
    case = cases.gkr_round_sums_case("LogUpGeneric", n, device, seed=3)
    want = case.plain()
    wide = torch.zeros((4, 8 * n + 5), dtype=torch.int32, device=device)
    wide[:, 3:4 * n + 3] = case.cols[0]
    spread = torch.stack([case.cols[1], case.cols[1]], dim=-1)[..., 0]
    assert not spread.is_contiguous()
    cols = (wide[:, 3:4 * n + 3], spread)
    _exact(gkr_kernels.round_sums_cuda(case.kind, case.eq_arr, cols,
                                       case.lam), want)


def test_gkr_round_sums_kernel_leaves_its_counter_at_zero(device):
    """Launches of every grid size in turn, each exact: the last block
    of each resets the counter of finished blocks for the next (a count
    left over would make no block of the next launch the last, and its
    result never written)."""
    for n_terms in (1 << 18, 1, 1 << 12, 3 << 10, 1 << 18, 7):
        case = cases.gkr_round_sums_case("GrandProduct", n_terms, device,
                                         seed=n_terms)
        _exact(case.kernel(), case.plain())


@pytest.mark.parametrize("base", [False, True])
@pytest.mark.parametrize("n", [2, 4, 1 << 11, 1 << 19])
def test_mle_fold_kernel_matches_plain(device, n, base):
    case = cases.mle_fold_case(n, device, base=base, seed=n + base)
    before = case.arr.clone()
    _exact(case.kernel(), case.plain())
    _exact(case.arr, before)


def test_mle_fold_kernel_at_the_largest_values_and_views(device):
    """Every value and the challenge P - 1; a [4, n] view of a wider
    buffer, read in place."""
    from tstwo_tpu_torch.fields import QM31

    c = QM31.from_ints([cases.P - 1] * 4)
    case = cases.mle_fold_case(1 << 10, device, c=c)
    case.arr.fill_(cases.P - 1)
    _exact(case.kernel(), case.plain())
    wide = cases.rand(np.random.default_rng(4), (4, 3000), device)
    view = wide[:, 7:7 + 2048]
    _exact(gkr_kernels.fold_cuda(view, c),
           gkr_kernels.fold_plain(view.cpu(), c))


def test_gkr_wrappers_refuse_what_the_kernels_do_not_take(device):
    case = cases.gkr_round_sums_case("LogUpGeneric", 8, device, seed=9)
    eq_arr, (nums, dens), lam = case.eq_arr, case.cols, case.lam

    def call(kind="LogUpGeneric", eq=eq_arr, cols=(nums, dens)):
        gkr_kernels.round_sums_cuda(kind, eq, cols, lam)

    with pytest.raises(ValueError, match="unknown layer kind"):
        call(kind="LogUpFancy")
    with pytest.raises(ValueError, match="2 column"):
        call(cols=(dens,))
    with pytest.raises(ValueError, match="CUDA"):
        call(cols=(nums.cpu(), dens))
    with pytest.raises(ValueError, match="expected \\[4, 32\\]"):
        call(cols=(nums[:, :16], dens))
    with pytest.raises(ValueError, match="expected \\[32\\]"):
        call(kind="LogUpMultiplicities", cols=(nums[0, :16], dens))
    with pytest.raises(ValueError, match="n_terms >= 1"):
        call(eq=eq_arr[:, :0])
    with pytest.raises(ValueError, match="even number"):
        gkr_kernels.fold_cuda(nums[:, :3], lam)
    with pytest.raises(ValueError, match="even number"):
        gkr_kernels.fold_cuda(nums[0, :1], lam)
    with pytest.raises(ValueError, match="CUDA"):
        gkr_kernels.fold_cuda(nums.cpu(), lam)


@pytest.mark.parametrize("kinds", [["GrandProduct"], ["LogUpGeneric"],
                                   ["LogUpMultiplicities"], ["LogUpSingles"],
                                   ["GrandProduct", "LogUpGeneric"]])
def test_gkr_prove_on_the_card_equals_the_cpu_prove(device, kinds):
    """A batch of 2^7-point instances proved on the card and on the CPU:
    the same proof; on the card one round-sum launch an oracle a round
    (`gkr_round_sums_on_card`, two a round for two instances), and no
    round on the CPU."""
    from tstwo_tpu_torch import tracing
    from tstwo_tpu_torch.channel.blake2s import Blake2sChannel
    from tstwo_tpu_torch.lookups.gkr import prove_batch

    proofs, counts = [], []
    for where in (device, "cpu"):
        layers = [cases.gkr_layer(kind, 7, i, where)
                  for i, kind in enumerate(kinds)]
        tracing.reset()
        tracing.enable(sync=False)
        try:
            with tracing.request(0):
                proofs.append(prove_batch(Blake2sChannel(), layers)[0])
            counts.append(tracing.counts()[0])
        finally:
            tracing.disable()
            tracing.reset()
    assert cases.flat_gkr_proof(proofs[0]) == \
        cases.flat_gkr_proof(proofs[1])
    rounds = sum(range(7))
    assert counts[0]["sumcheck_rounds"] == counts[1]["sumcheck_rounds"] \
        == rounds
    assert counts[0]["gkr_round_sums_on_card"] == len(kinds) * rounds
    assert "gkr_round_sums_on_card" not in counts[1]
