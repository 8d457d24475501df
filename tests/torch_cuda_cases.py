"""The CUDA kernels' cases on the card, written once for the card tests
(tests/test_torch_cuda.py) and for the kernel table of chip_smoke.py.

Each `*_case` function takes a kernel's shape and a device and returns a
`Case`: the random inputs it made (seeded, so the same on every run) and
its shape as attributes, `kernel()`, one call of the CUDA kernel, and
`plain()`, the same function by its plain PyTorch version on the same
inputs, and `cost(want)`, what the function needs of these inputs (a
`Cost`; `want` is plain()'s result).  The two calls agree exactly
(`max_abs_err` 0).  The card tests call both and compare; chip_smoke.py
compares them too, times them, and sets their times beside the bound of
`cost`.  A case may also have `launch()`, the kernel alone without the
host's preparation of its call, which chip_smoke.py times as the kernel.

`KERNEL_ROWS`, `PROGRAM_ROWS`, `QUOTIENT_ROWS`, `GKR_ROWS` and
`POSEIDON_GRIND_ROWS` are the shapes the proves give the kernels: the rows
of chip_smoke.py's kernel table (its phase 3; 8b-8c; 8d; the GKR phase; the
Poseidon252 grind phase).  `tests/test_torch_cuda.py`
holds every one.

Imports numpy, torch and tstwo_tpu_torch only: the GPU machine has no JAX.
"""
from __future__ import annotations

from functools import cache, partial
from types import SimpleNamespace as Case
from typing import Callable, NamedTuple

import numpy as np
import torch

from tstwo_tpu_torch.lookups import gkr_kernels
from tstwo_tpu_torch.ops import blake2s, fft, fri_ops, m31_kernels, qm31
from tstwo_tpu_torch.ops import constraint_eval as ce
from tstwo_tpu_torch.ops import poseidon252 as pos
from tstwo_tpu_torch.utils import to_torch_u32

P = (1 << 31) - 1
# the edge values of the Pallas tests of the M31 kernels
M31_EDGE = np.array([0, 1, 2, P - 1, P - 2, 1 << 16, (1 << 16) - 1,
                     (1 << 30) + 12345], dtype=np.uint32)
P252 = (1 << 251) + 17 * (1 << 192) + 1
# felts that stress the carries and the reduction: the ends of the field,
# the words of p, runs of set words and their neighbours
FELT_EDGE = [0, 1, 2, P252 - 1, P252 - 2, 1 << 251, (1 << 251) - 1,
             17 << 192, (1 << 224) - 1, (1 << 32) - 1, (1 << 192) - 1,
             ((1 << 251) - 1) - (17 << 192)]
# A zero digest at n_sent 238,210,102: word 3 of that draw is 0xFFFFFFFE >=
# 2P, so the draw is rejected whole and the hash at 238,210,103 is drawn.
REJECTING_N_SENT = 238_210_102

# What the functions need, counted for the bounds of chip_smoke.py's
# kernel table (integer operations; the card's rates are there).
# One Blake2s compress of a 64-byte block is 80 G-mixes of 12 operations
# (4 adds, two of them of three inputs, 4 xors, 4 funnel shifts) and 16 xors
# to fold the state: 976.  Only the xors and shifts are bound to the integer
# lanes: an add can issue as a multiply-add on the float lanes beside them
# (the kernel retires more than 1.675e13 of the 976 a second, which shows
# it), so the bound counts the 8 xors and shifts of a G-mix and the fold.
B2S_OPS_PER_BLOCK = 80 * 8 + 16
# One M31 butterfly: a product (a wide multiply, two folds and a conditional
# subtract: 9), a modular add (3) and a modular subtract (4).
BUTTERFLY_OPS = 16
M31_MUL_OPS = 9
# Felt252 arithmetic, counted as the function needs it and not as
# csrc/felt252.cuh writes it.  A 32 x 32 product added into a 64-bit sum is
# one instruction (a wide multiply-add): a product of two felts of eight
# words is 64 of them, a square 36 (the 28 cross products once, doubled, and
# the 8 squares).  Reducing the 16-word result modulo p = 2^251 + 17 * 2^192
# + 1 is 8 steps of about 3 operations (p == 1 mod 2^32 makes the Montgomery
# factor a negation and m * p a product by 17 and two shifted adds).  A
# modular add or subtract is 8 adds with carry and 8 for the conditional
# subtraction.  A Hades permutation: 8 full rounds of three cubes and 83
# partial rounds of one, each cube a square and a product (107 of each), and
# a round's 3 constant adds and 9 adds and subtracts of the MDS.
# `source_count` is a second bound of the Poseidon rows: the kernel's own
# count from its source, which says how far the kernel's body is from what
# the function needs, and how close the kernel runs to its own body.  It
# counts the primitives of csrc/felt252.cuh, one PTX instruction each
# (tests/test_torch_felt252_source_count.py counts them on the host): a
# product is 128 for the 16-word product (a mad.wide and an add with carry
# a term) and 54 for the reduction (m read off the words, m * p as products
# by 17 and shifts by 27 in two subtractions, and p added back to a
# negative result): 182; a square is 92 (the 28 cross products, a one-bit
# shift to double them, the 8 squares) and the same 54: 146.  A modular add
# or subtract is written in plain C++ and counted as 24 (8 adds with carry
# and 16 for the conditional subtraction).
FELT_REDUCE_OPS = 8 * 3
FELT_MUL_OPS = 64 + FELT_REDUCE_OPS
FELT_SQR_OPS = 36 + FELT_REDUCE_OPS
FELT_ADD_OPS = 16
HADES_OPS = 107 * (FELT_MUL_OPS + FELT_SQR_OPS) + 91 * 12 * FELT_ADD_OPS
FELT_MUL_SOURCE_OPS = 128 + 54
FELT_SQR_SOURCE_OPS = 92 + 54
FELT_ADD_SOURCE_OPS = 24
HADES_SOURCE_OPS = (107 * (FELT_MUL_SOURCE_OPS + FELT_SQR_SOURCE_OPS)
                    + 91 * 12 * FELT_ADD_SOURCE_OPS)


class Cost(NamedTuple):
    """What a case's function needs, for its row's bound: the kernel's
    source under tstwo_tpu_torch/csrc, the bytes it must move once and the
    integer operations it must do.  `bounds`: further (bytes, operations)
    pairs, each a `<name>_ms` beside the bound; `extra`: columns of the row
    as they are; `library`: the PyTorch call for the same function, where
    one exists; `suffix`: the end of the row's shape (a grind's hit)."""
    source: str
    n_bytes: int
    n_ops: int
    bounds: dict = {}
    extra: dict = {}
    library: Callable = None
    suffix: str = ""


def rand(rng, shape, device, high=P) -> torch.Tensor:
    return to_torch_u32(rng.integers(0, high, size=shape, dtype=np.uint64)
                        .astype(np.uint32), device)


def rand_felts(rng, n, device) -> torch.Tensor:
    """n felts below 2^251 (so below p) with every word random."""
    words = rng.integers(0, 1 << 32, size=(8, n), dtype=np.uint64)
    words[7] &= (1 << 19) - 1
    return to_torch_u32(words.astype(np.uint32), device)


def max_abs_err(got, want) -> int:
    """The largest |got - want| over the results of a kernel and its plain
    version (a tensor, or a sequence of them); raises if the two differ
    in count or shape."""
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    if len(got) != len(want):
        raise ValueError(f"{len(got)} results, plain {len(want)}")
    err = 0
    for g, w in zip(got, want):
        if g.shape != w.shape:
            raise ValueError(f"shape {tuple(g.shape)}, plain "
                             f"{tuple(w.shape)}")
        if g.numel():
            err = max(err, int((g.to(torch.int64) - w.to(g.device,
                                                          torch.int64))
                               .abs().max()))
    return err


# -- the cases ---------------------------------------------------------------

def cfft_pass_limit(log_n) -> int:
    """The most kernel launches a transform of 2^log_n points may take."""
    return 1 if log_n <= 11 else 2 if log_n <= 22 else 3


def cfft_passes(case) -> int:
    """The kernel launches of one call of a cfft case, as the library
    counts them; asserts they are `fft.cfft_plan`'s passes, which are the
    built library's own plan, and within `cfft_pass_limit`."""
    plan = fft.cfft_plan(case.log_n, case.inverse)
    before = fft.cfft_kernel_launches()
    case.kernel()
    made = fft.cfft_kernel_launches() - before
    built = fft.cfft_kernel_plan(case.x.shape[0], case.log_n, case.inverse)
    assert made == len(plan) <= cfft_pass_limit(case.log_n), \
        f"{made} kernel launches, cfft_plan {plan}"
    assert [p[:4] for p in built] == plan, \
        f"library plan {built}, cfft_plan {plan}"
    return made


def cfft_case(batch, log_n, device, log_m=None, inverse=False, scale=None,
              seed=0) -> Case:
    """[batch, 2^log_m] random values (2^log_n without log_m; the forward
    zero-extends them to 2^log_n inside the kernel) and random twiddles;
    the inverse multiplies its result by `scale`.  A forward from m < n
    is bound by what that function needs: m words read a column and
    log2(m) layers of butterflies (the layers above only copy); the bound
    of the full transform of n points is beside it (`bound_full_n`).  Its
    cost counts the launches of one more call (`passes`)."""
    rng = np.random.default_rng(seed)
    n = 1 << log_n
    m = n if log_m is None else 1 << log_m
    x = rand(rng, (batch, m), device)
    circle = rand(rng, (n // 2,), device)
    line = [rand(rng, (n >> (l + 1),), device) for l in range(1, log_n)]
    buf = fft.twiddle_buffer(line, circle)

    def plain():
        full = x if m == n else torch.nn.functional.pad(x, (0, n - m))
        return fft.fft_plain(full, line, circle, inverse, scale)

    def cost(want):
        butterflies = batch * (n >> 1)
        plan = fft.cfft_kernel_plan(batch, log_n, inverse)
        return Cost("cfft.cu", 4 * (batch * m + batch * n + n),
                    BUTTERFLY_OPS * butterflies * (m.bit_length() - 1),
                    bounds={"bound_full_n": (4 * (2 * batch * n + n),
                                             BUTTERFLY_OPS * butterflies
                                             * log_n)},
                    extra={"passes": cfft_passes(case),
                           "columns_per_block": [p[4] for p in plan]})

    case = Case(x=x, line=line, circle=circle, buf=buf, log_n=log_n,
                inverse=inverse, plain=plain, cost=cost,
                kernel=lambda: fft.cfft_cuda(x, buf, log_n, inverse, scale,
                                             m))
    return case


def _hash_cost(n, byte_len, words) -> Cost:
    """n Blake2s hashes of byte_len-byte messages that read `words` words
    each and write 8."""
    blocks = max(1, -(-byte_len // 64))
    return Cost("blake2s.cu", 4 * n * (words + 8),
                B2S_OPS_PER_BLOCK * blocks * n)


def blake2s_case(n_words, n, byte_len, device, seed=0,
                 random_tail=False) -> Case:
    """n messages of byte_len bytes in word-major [n_words, n]: random
    words, those past the message zero as a leaf's padding gives them
    (`random_tail`: random too; the kernel hashes every word it is
    given, as the plain version does)."""
    w = rand(np.random.default_rng(seed), (n_words, n), device, 1 << 32)
    if not random_tail:
        w[-(-byte_len // 4):] = 0
    return Case(w=w, n=n, words=n_words, byte_len=byte_len,
                kernel=lambda: blake2s.hash_words_major_cuda(w, byte_len),
                plain=lambda: blake2s.hash_words_major_plain(w, byte_len),
                cost=lambda want: _hash_cost(n, byte_len, n_words))


def merkle_layer_case(n, entries, with_prev, device, seed=0) -> Case:
    """A Blake2s layer of n nodes: the child pairs of a random [8, 2n]
    layer if `with_prev`, then the columns of `entries` (0 for a column
    [n], C for a stack [C, n])."""
    rng = np.random.default_rng(seed)
    prev = rand(rng, (8, 2 * n), device, 1 << 32) if with_prev else None
    cols = [rand(rng, (n,) if c == 0 else (c, n), device) for c in entries]
    words = sum(max(c, 1) for c in entries) + (16 if with_prev else 0)
    return Case(prev=prev, cols=cols, n=n, words=words, byte_len=4 * words,
                kernel=lambda: blake2s.merkle_layer_cuda(prev, cols, n,
                                                         device),
                plain=lambda: blake2s.merkle_layer_plain(prev, cols, n,
                                                         device),
                cost=lambda want: _hash_cost(n, 4 * words, words))


def merkle_tail_case(log, device, offset=0, seed=0) -> Case:
    """The log layers above a random [8, 2^log] layer, read `offset`
    words into its buffer."""
    flat = rand(np.random.default_rng(seed), (1 + (8 << log),), device,
                1 << 32)
    prev = flat[offset:offset + (8 << log)].view(8, 1 << log)
    nodes = (1 << log) - 1
    return Case(prev=prev, log=log,
                kernel=lambda: blake2s.merkle_tail_cuda(prev),
                plain=lambda: blake2s.merkle_tail_plain(prev),
                cost=lambda want: Cost("blake2s.cu",
                                       4 * 8 * ((1 << log) + nodes),
                                       B2S_OPS_PER_BLOCK * nodes))


def grind_digests() -> list:
    """(label, digest words) of three channel states: fresh (the zero
    digest), after a u64, after a root."""
    from tstwo_tpu_torch.channel.blake2s import Blake2sChannel

    fresh, mixed, rooted = Blake2sChannel(), Blake2sChannel(), \
        Blake2sChannel()
    mixed.mix_u64(0x123456789)
    rooted.mix_root(bytes(range(32)))
    return [(label, blake2s.digest_bytes_to_words(ch.digest)) for label, ch
            in (("fresh", fresh), ("mix_u64", mixed), ("mix_root", rooted))]


def grind_case(label, pow_bits, start, count, device) -> Case:
    """The least nonce in [start, start + count) of the channel state
    `label` with pow_bits trailing zeros (-1: none), as an int64 [1].  Its
    cost is the nonces up to the hit, all the function needs (the kernel's
    blocks past a hit return at once)."""
    words = dict(grind_digests())[label]

    def cost(want):
        hit = int(want)
        needed = count if hit < 0 else hit - start + 1
        return Cost("blake2s.cu", 4 * 8 + 8, B2S_OPS_PER_BLOCK * needed,
                    extra={"nonces_needed": needed},
                    suffix=f": hit {hit}" if pow_bits < 128 else "")

    return Case(start=start, count=count, pow_bits=pow_bits, cost=cost,
                kernel=lambda: blake2s.grind_hit_cuda(words, start, count,
                                                      pow_bits, device),
                plain=lambda: blake2s.grind_hit_plain(words, start, count,
                                                      pow_bits, device))


def poseidon_grind_digests() -> list:
    """(label, digest) of three Poseidon252 channel states: fresh (the zero
    felt), after a u64, after a root."""
    from tstwo_tpu_torch.channel.poseidon import (FieldElement252,
                                                  Poseidon252Channel)

    fresh, mixed, rooted = Poseidon252Channel(), Poseidon252Channel(), \
        Poseidon252Channel()
    mixed.mix_u64(0x123456789)
    rooted.mix_root(FieldElement252(P252 - 2))
    return [(label, ch.digest.value) for label, ch
            in (("fresh", fresh), ("mix_u64", mixed), ("mix_root", rooted))]


def poseidon_grind_case(label, pow_bits, start, count, device) -> Case:
    """The least nonce in [start, start + count) whose Poseidon252
    mix_u64 digest from the channel state `label` has pow_bits trailing
    zeros (-1: none), as an int64 [1].  Its cost is two permutations for
    each nonce up to the hit (the kernel's blocks past a hit return at
    once), beside the source count of their body."""
    digest = dict(poseidon_grind_digests())[label]

    def cost(want):
        hit = int(want)
        needed = count if hit < 0 else hit - start + 1
        return Cost("poseidon252.cu", 4 * 8 + 8, 2 * HADES_OPS * needed,
                    bounds={"source_count": (4 * 8 + 8, 2 * HADES_SOURCE_OPS
                                             * needed)},
                    extra={"nonces_needed": needed},
                    suffix=f": hit {hit}" if pow_bits < 128 else "")

    return Case(digest=digest, start=start, count=count, pow_bits=pow_bits,
                cost=cost,
                kernel=lambda: pos.poseidon_grind_hit_cuda(
                    digest, start, count, pow_bits, device),
                plain=lambda: pos.poseidon_grind_hit_plain(
                    digest, start, count, pow_bits, device))


def transcript_case(msg_words, msg_bytes, k, device, seed=0, strided=False,
                    rejecting=False) -> Case:
    """One transcript step from a random digest and 64-bit n_sent: a mix
    of msg_bytes of `msg_words` random words (none: None), then k draws.
    `strided`: the message is a column of a wider layer (a root in its
    tree's top layer); `rejecting`: the zero digest at REJECTING_N_SENT.
    Its cost is the compressions this data needs (a rejected draw is one
    more)."""
    rng = np.random.default_rng(seed)
    digest = rand(rng, (8,), device, 1 << 32)
    n_sent = rand(rng, (2,), device, 1 << 32)
    msg = None if msg_words is None else rand(
        rng, (msg_words, 3) if strided else (msg_words,), device, 1 << 32)
    if strided:
        msg = msg[:, 0]
    if rejecting:
        digest = torch.zeros(8, dtype=torch.int32, device=device)
        n_sent = torch.tensor([REJECTING_N_SENT, 0], dtype=torch.int32,
                              device=device)
    def count(words):
        lo, hi = (int(w) & 0xFFFFFFFF for w in words.tolist())
        return lo | hi << 32

    def cost(want):
        blocks = 0 if msg is None else -(-(32 + msg_bytes) // 64)
        hashes = blocks + count(want[1]) - (count(n_sent) if msg is None
                                            else 0)
        words = 8 + (2 if msg is None else -(-msg_bytes // 4)) + 10 + 8 * k
        return Cost("blake2s.cu", 4 * words, B2S_OPS_PER_BLOCK * hashes,
                    extra={"compressions": hashes})

    return Case(digest=digest, n_sent=n_sent, msg=msg, msg_bytes=msg_bytes,
                k=k, cost=cost,
                kernel=lambda: blake2s.transcript_cuda(digest, n_sent, msg,
                                                       msg_bytes, k),
                plain=lambda: blake2s.transcript_plain(digest, n_sent, msg,
                                                       msg_bytes, k))


def deinterleave_case(shape, device, seed=0) -> Case:
    """Random values of `shape`; the plain version is the two strided
    copies (`deinterleave_plain`'s views, made contiguous)."""
    x = rand(np.random.default_rng(seed), shape, device)

    def plain():
        return tuple(t.contiguous() for t in fri_ops.deinterleave_plain(x))

    # the PyTorch call for the same function: the two strided copies
    return Case(x=x, kernel=lambda: fri_ops.deinterleave_cuda(x),
                plain=plain,
                cost=lambda want: Cost("deinterleave.cu", 8 * x.numel(), 0,
                                       library=plain))


def m31_case(n, device, reps=None, edge=False, seed=0) -> Case:
    """The product (reps None) or `reps` dependent products of n values:
    random, or `edge`: M31_EDGE repeated against itself reversed."""
    if edge:
        a = np.resize(M31_EDGE, n)
        a, b = to_torch_u32(a, device), to_torch_u32(a[::-1].copy(), device)
    else:
        rng = np.random.default_rng(seed)
        a, b = rand(rng, n, device), rand(rng, n, device)
    def cost(want):
        return Cost("m31_kernels.cu", 12 * n, (reps or 1) * M31_MUL_OPS * n)

    if reps is None:
        return Case(a=a, b=b, kernel=lambda: m31_kernels.mul_cuda(a, b),
                    plain=lambda: m31_kernels.mul_plain(a, b), cost=cost)
    return Case(a=a, b=b, reps=reps, cost=cost,
                kernel=lambda: m31_kernels.mul_chain_cuda(a, b, reps),
                plain=lambda: m31_kernels.mul_chain_plain(a, b, reps))


def _hades_cost(n_perms, n_bytes) -> Cost:
    """n_perms Hades permutations that move n_bytes, beside the source
    count of their body."""
    return Cost("poseidon252.cu", n_bytes, HADES_OPS * n_perms,
                bounds={"source_count": (n_bytes,
                                         HADES_SOURCE_OPS * n_perms)})


def hades_case(n, device, seed=0) -> Case:
    """The Hades permutation of n states of three random felts, the edge
    felts in every position of the first states."""
    rng = np.random.default_rng(seed)
    state = [rand_felts(rng, n, device) for _ in range(3)]
    edge = pos.ints_to_felts(FELT_EDGE, device)
    m = min(n, len(FELT_EDGE))
    for k in range(3):
        state[k][:, :m] = edge.roll(k, dims=1)[:, :m]
    return Case(state=state, n=n,
                kernel=lambda: pos.hades_permutation_cuda(state),
                plain=lambda: pos.hades_permutation_plain(state),
                cost=lambda want: _hades_cost(n, 2 * 96 * n))


def poseidon_layer_case(log, n_cols, with_prev, device, layout="stack",
                        seed=0) -> Case:
    """A Poseidon252 layer of 2^log nodes: the child pairs of a random
    felt layer if `with_prev` (the edge felts as the first children), then
    n_cols random columns as one stack, as single columns (more than 16:
    concatenated by the wrapper), mixed, or as rows a stride apart."""
    rng = np.random.default_rng(seed)
    n = 1 << log
    prev = rand_felts(rng, 2 * n, device) if with_prev else None
    cols = rand(rng, (n_cols, n), device)
    if with_prev:
        m = min(2 * n, len(FELT_EDGE))
        prev[:, :m] = pos.ints_to_felts(FELT_EDGE, device)[:, :m]
    if layout == "stack":
        entries = [cols] if n_cols else []
    elif layout == "single":
        entries = list(cols)
    elif layout == "mixed":
        entries = [cols[:7], cols[7], cols[8:30], *cols[30:]]
    else:
        wide = rand(rng, (n_cols, 2 * n + 6), device)
        entries = [wide[:, 3:n + 3], wide[::2, n + 5:2 * n + 5]]
    # a node hashes its children's 2 felts, its columns packed 8 to a
    # felt and the padding felt, two felts a permutation
    n_felts = (2 if with_prev else 0) + -(-n_cols // 8) + 1
    return Case(prev=prev, entries=entries, n=n, n_cols=n_cols,
                kernel=lambda: pos.merkle_layer_cuda(prev, entries, n,
                                                     device),
                plain=lambda: pos.merkle_layer_plain(prev, entries, n,
                                                     device),
                cost=lambda want: _hades_cost(
                    n * -(-n_felts // 2),
                    4 * n * (n_cols + (16 if with_prev else 0) + 8)))


class Offsets:
    """An AIR of masks at offsets -1, 1 and 2, constants and a QM31
    product, on a domain twice the trace's."""

    def __init__(self, log: int):
        self.log = log

    def log_size(self):
        return self.log

    def max_constraint_log_degree_bound(self):
        return self.log + 1

    def kernel_cache_key(self):
        return None

    def evaluate(self, ev):
        from tstwo_tpu_torch.fields import QM31

        a, b, c, d = ev.next_interaction_mask(1, [0, -1, 1, 2])
        e = ev.next_trace_mask()
        ev.add_constraint(a * b - c + d * e)
        ev.add_constraint((a - 5) * QM31.from_ints([1, 2, 3, 4]) + e)
        ev.add_constraint(-(c * c) + 7)


def program_case(kind, trace_log, device, expand=1, columns=12, seed=0,
                 equation_ops=None) -> Case:
    """The constraint program of `kind` (wide_fib of `columns` columns,
    logup_pairs, logup_single, poseidon2, offsets) over 2^(trace_log +
    expand) rows of a 2^trace_log-row trace: random columns, scalars and
    accumulator.  `kernel(rows_per_thread=0)` adds the quotients into the
    accumulator in place and returns it; `plain()` adds the plain
    executor's into a copy of the accumulator as it was built.  Its cost
    is the program's operations, or `equation_ops` where given (what the
    AIR's equations need); the program's size and the launch shape the
    kernel takes for it are beside them."""
    from tstwo_tpu_torch.constraint_framework import InfoEvaluator
    from tstwo_tpu_torch.constraint_framework.logup import LookupElements
    from tstwo_tpu_torch.constraint_framework.program import lower
    from tstwo_tpu_torch.examples.logup_lookup import LookupEval
    from tstwo_tpu_torch.examples.poseidon2 import N_STATE, Poseidon2Eval
    from tstwo_tpu_torch.examples.wide_fibonacci import WideFibonacciEval
    from tstwo_tpu_torch.fields import QM31

    rng = np.random.default_rng(seed)
    gen = torch.Generator(device).manual_seed(seed)

    def qm31s(k):
        return [QM31.from_ints([int(v) for v in rng.integers(0, P, 4)])
                for _ in range(k)]

    if kind == "wide_fib":
        ev = WideFibonacciEval(trace_log, columns)
    elif kind == "poseidon2":
        ev = Poseidon2Eval(trace_log, LookupElements(*qm31s(2), N_STATE))
    elif kind == "offsets":
        ev = Offsets(trace_log)
    else:
        ev = LookupEval(trace_log, LookupElements(*qm31s(2), 1),
                        kind == "logup_pairs")
    info = InfoEvaluator(trace_log)
    ev.evaluate(info)
    t, e = trace_log, trace_log + expand
    program = lower(ev, t, e)

    def randint(shape):
        return torch.randint(0, P, shape, dtype=torch.int32, device=device,
                             generator=gen)

    stacks = [randint((c, 1 << e)) if c else None for c in program.columns]
    scalars = to_torch_u32(program.scalars(
        qm31s(program.n_constraints), info.secure_params, qm31s(1)[0])
        .view(np.uint32), device)
    code, loads = program.device_code(device), program.device_loads(device)
    acc = randint((4, 1 << e))
    acc0 = acc.clone()

    def kernel(rows_per_thread=0):
        ce.evaluate_cuda(code, loads, program.n_slots, stacks, scalars,
                         program.denom_off, t, e, acc, rows_per_thread)
        return acc

    def cost(want):
        rows_pt, chunk = ce.launch_shape(len(program.code),
                                         program.count(ce.LOAD),
                                         scalars.numel(), program.n_slots)
        n_ops = (program.ops_per_row() << e if equation_ops is None
                 else equation_ops)
        return Cost("constraint_eval.cu",
                    (4 * sum(program.columns) + 2 * 16) << e, n_ops,
                    extra={"ops_per_row": n_ops >> e,
                           "program_ops_per_row": program.ops_per_row(),
                           "instructions": len(program.code),
                           "loads": int(program.count(ce.LOAD)),
                           "slots": program.n_slots,
                           "rows_per_thread": rows_pt, "chunk": chunk})

    return Case(ev=ev, program=program, code=code, stacks=stacks,
                scalars=scalars, acc=acc, acc0=acc0, trace_log=t,
                eval_log=e, kernel=kernel, cost=cost,
                plain=lambda: qm31.add(acc0, ce.evaluate_plain(
                    code, program.n_slots, stacks, scalars,
                    program.denom_off, t, e)))


def quotient_case(k, log, n_batches, device, every=3, shuffle=False,
                  base_point=False, seed=0) -> Case:
    """k random card columns of 2^log values and their sample batches:
    every column at z, every `every`-th column also at z - g, and for
    each further batch every column at z + b g; `base_point`: the last
    batch at a point of the base field (all its denominators 0);
    `shuffle`: each batch lists its columns out of index order.
    `kernel()` is the whole call (the constants packed on the host, the
    column table uploaded, the launch), `launch()` the launch alone, its
    table uploaded at the first call.  Its cost: each column value read
    once, the [4, n] result written once."""
    from tstwo_tpu_torch.channel.blake2s import Blake2sChannel
    from tstwo_tpu_torch.circle import CanonicCoset, CirclePoint
    from tstwo_tpu_torch.fields import QM31
    from tstwo_tpu_torch.pcs import quotients
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
    domain = CanonicCoset.new(log).circle_domain()

    def plain():
        xs, ys = quotients.domain_points_bitrev(domain, device)
        return quotients._accumulate_rows(cols, xs, ys, batches, alpha)

    @cache
    def table():
        pack = quotients.pack_quotient_constants(batches, alpha)
        ptrs = [c.data_ptr() for c in cols]
        return (pack, quotients._device_table(pack, ptrs, device),
                torch.empty((4, 1 << log), dtype=torch.int32, device=device))

    def launch():
        pack, device_table, out = table()
        quotients._launch(device_table, k, pack, domain, 0, out)
        return out

    return Case(cols=cols, batches=batches, alpha=alpha, domain=domain,
                plain=plain, launch=launch,
                kernel=lambda: quotients.accumulate_quotients_cuda(
                    domain, list(cols), alpha, batches),
                cost=lambda want: Cost("quotients.cu",
                                       4 * k * (1 << log) + 16 * (1 << log),
                                       0))


def _edged(rng, shape, device) -> torch.Tensor:
    """Random canonical values with M31_EDGE (0, P - 1, ...) as the first
    points, rolled by one a row (so that no point is zero in every row)."""
    x = rand(rng, shape, device)
    m = min(shape[-1], len(M31_EDGE))
    rows = x.view(-1, shape[-1])
    for k in range(rows.shape[0]):
        rows[k, :m] = to_torch_u32(np.roll(M31_EDGE, k)[:m], device)
    return x


def _qm31(rng):
    from tstwo_tpu_torch.fields import QM31

    return QM31.from_ints([int(v) for v in rng.integers(0, P, 4)])


# the layer columns a round reads, [4, 4 n] each but LogUpMultiplicities'
# base numerators [4 n]: (columns, bytes a term)
GKR_COLUMNS = {gkr_kernels.GRAND_PRODUCT: ((4,), 64),
               gkr_kernels.LOGUP_GENERIC: ((4, 4), 128),
               gkr_kernels.LOGUP_MULTIPLICITIES: ((1, 4), 80),
               gkr_kernels.LOGUP_SINGLES: ((4,), 64)}


def gkr_round_sums_case(kind, n_terms, device, eq_len=None, lam=None,
                        seed=0) -> Case:
    """The two round sums of an oracle of `kind` over n_terms terms: the
    first n_terms of a random eq table of eq_len entries (a view, as a
    round reads its table's prefix), random layer columns whose first
    points are M31_EDGE, lambda random unless given.  Its cost: the eq
    prefix and the layer read once, the 8 words written."""
    rng = np.random.default_rng(seed)
    eq_len = eq_len or n_terms
    eq_arr = _edged(rng, (4, eq_len), device)[:, :n_terms]
    rows, per_term = GKR_COLUMNS[kind]
    cols = tuple(_edged(rng, (r, 4 * n_terms) if r == 4 else (4 * n_terms,),
                        device) for r in rows)
    lam = lam or _qm31(rng)
    return Case(kind=kind, eq_arr=eq_arr, cols=cols, lam=lam,
                n_terms=n_terms,
                kernel=lambda: gkr_kernels.round_sums_cuda(kind, eq_arr, cols,
                                                           lam),
                plain=lambda: gkr_kernels.round_sums_plain(kind, eq_arr, cols,
                                                           lam),
                cost=lambda want: Cost("gkr.cu", (16 + per_term) * n_terms
                                       + 32, 0))


def mle_fold_case(n, device, base=False, c=None, seed=0) -> Case:
    """An MLE of n points folded by its first variable at c (random
    unless given): [4, n] random QM31 values, or [n] base values (`base`),
    M31_EDGE first.  Its cost: the MLE read once, [4, n / 2] written."""
    rng = np.random.default_rng(seed)
    arr = _edged(rng, (n,) if base else (4, n), device)
    c = c or _qm31(rng)
    return Case(arr=arr, c=c, n=n, base=base,
                kernel=lambda: gkr_kernels.fold_cuda(arr, c),
                plain=lambda: gkr_kernels.fold_plain(arr, c),
                cost=lambda want: Cost("gkr.cu", (4 if base else 16) * n
                                       + 8 * n, 0))


def gkr_layer(kind: str, n_vars: int, seed: int, device):
    """A GKR input layer of `kind` over 2^n_vars points, from numpy (the
    same values on every device)."""
    from tstwo_tpu_torch.lookups.gkr import Layer
    from tstwo_tpu_torch.lookups.mle import BaseMle, Mle

    rng = np.random.default_rng(seed)
    n = 1 << n_vars
    num = to_torch_u32(rng.integers(0, P, size=(4, n), dtype=np.uint32),
                       device)
    den = to_torch_u32(rng.integers(1, P, size=(4, n), dtype=np.uint32),
                       device)
    if kind == gkr_kernels.GRAND_PRODUCT:
        return Layer(kind, data=Mle(num))
    if kind == gkr_kernels.LOGUP_GENERIC:
        return Layer(kind, numerators=Mle(num), denominators=Mle(den))
    if kind == gkr_kernels.LOGUP_MULTIPLICITIES:
        base = to_torch_u32(rng.integers(0, P, size=n, dtype=np.uint32),
                            device)
        return Layer(kind, numerators=BaseMle(base), denominators=Mle(den))
    return Layer(kind, denominators=Mle(den))


def flat_gkr_proof(proof) -> list:
    """A GkrBatchProof as a flat list of ints."""
    out = []
    for sc in proof.sumcheck_proofs:
        for rp in sc.round_polys:
            out.append(len(rp.coeffs))
            for c in rp.coeffs:
                out.extend(c.to_ints())
    for masks in proof.layer_masks_by_instance:
        out.append(len(masks))
        for mask in masks:
            for a, b in mask.columns_:
                out.extend(a.to_ints() + b.to_ints())
    for claims in proof.output_claims_by_instance:
        for c in claims:
            out.extend(c.to_ints())
    return out


# -- the rows of chip_smoke.py's kernel table ---------------------------------

class Row(NamedTuple):
    """A kernel-table row: the kernel's name, the shape as the table
    prints it, and `build(device)`, its Case."""
    name: str
    shape: str
    build: Callable


def _cfft_row(name, batch, log_n, log_m, scaled):
    return Row(name, f"[{batch},2^{log_n}]"
               + (f" from m=2^{log_m}" if log_m != log_n else "")
               + (" scaled" if scaled else ""),
               partial(cfft_case, batch, log_n, log_m=log_m,
                       inverse=name == "cfft_inverse",
                       scale=pow(1 << log_n, P - 2, P) if scaled else None))


def _layer_row(name, log, n_cols, with_prev):
    words = n_cols + (16 if with_prev else 0)
    return Row(name, (f"2^{log} nodes of [8,2^{log + 1}]" if with_prev
                      else "")
               + (" + " if with_prev and n_cols else "")
               + (f"[{n_cols},2^{log}]" if n_cols else "")
               + f" {4 * words} B",
               partial(merkle_layer_case, 1 << log,
                       (n_cols,) if n_cols else (), with_prev))


def _poseidon_layer_row(log, n_cols, with_prev):
    return Row("poseidon_merkle_layer",
               (f"2^{log} nodes of [8,2^{log + 1}]" if with_prev
                else f"2^{log} leaves")
               + (f" + [{n_cols},2^{log}]" if n_cols else ""),
               partial(poseidon_layer_case, log, n_cols, with_prev))


def _pow2(d):
    return f"2^{d.bit_length() - 1}" if d > 8 else str(d)


KERNEL_ROWS = (
    # wide Fibonacci 2^16 x 32: extension, composition, interpolation; the
    # one-pass transform alone, at 10 and at 6 layers.  LogUp 2^20:
    # extensions of 1, 2 and 4 columns, the composition, interpolations of
    # the trace and the composition.  Then the calls as the proves make
    # them, with the coefficient length m (zero-extended inside the
    # kernel) and the 1/N scale: wide Fibonacci 2^18 x 64 (trace
    # interpolation, extension, the composition's pair) and LogUp 2^20.
    # Last the three-pass plan, at 2^24 points.
    *(_cfft_row(*args) for args in [
        ("cfft_forward", 32, 17, 17, False),
        ("cfft_forward", 4, 18, 18, False),
        ("cfft_inverse", 32, 16, 16, False),
        ("cfft_block_resident", 32, 10, 10, False),
        ("cfft_block_resident", 32, 6, 6, False),
        ("cfft_forward", 1, 21, 21, False), ("cfft_forward", 4, 21, 21, False),
        ("cfft_forward", 4, 22, 22, False), ("cfft_inverse", 4, 20, 20, False),
        ("cfft_inverse", 4, 21, 21, False), ("cfft_inverse", 64, 18, 18, True),
        ("cfft_forward", 64, 19, 18, False), ("cfft_inverse", 4, 19, 19, True),
        ("cfft_forward", 4, 20, 19, False), ("cfft_inverse", 4, 20, 20, True),
        ("cfft_forward", 1, 21, 20, False), ("cfft_forward", 4, 21, 20, False),
        ("cfft_inverse", 4, 21, 21, True), ("cfft_forward", 4, 22, 21, False),
        ("cfft_forward", 2, 24, 24, False),
        ("cfft_inverse", 2, 24, 24, True)]),
    # wide Fibonacci: 128-byte leaves (32 columns), 64-byte nodes.  LogUp
    # 2^20: leaves of 1, 2 and 4 columns, and the 80-byte two-block hashes
    # of a node level that takes in columns.
    *(Row("blake2s", f"[{words},2^{log}] {byte_len} B",
          partial(blake2s_case, words, 1 << log, byte_len))
      for (words, log), byte_len in [
          ((32, 17), 128), ((16, 16), 64), ((16, 21), 4), ((16, 21), 8),
          ((16, 21), 16), ((16, 22), 16), ((32, 21), 80)]),
    # Merkle layers as the commits give them to the kernel, columns read
    # where they lie.  Leaf layers (counted as blake2s): the 64 columns of
    # the 2^18 x 64 trace tree (256 B, four blocks), a FRI layer's [4, n]
    # (16 B), LogUp 2^20's interaction stack.  Node layers (merkle_layer):
    # 64 B from the child pairs alone; 80 B where 4 columns join (LogUp).
    *(_layer_row(*args) for args in [
        ("blake2s", 19, 64, False), ("blake2s", 18, 4, False),
        ("blake2s", 21, 4, False), ("merkle_layer", 18, 0, True),
        ("merkle_layer", 16, 0, True), ("merkle_layer", 21, 0, True),
        ("merkle_layer", 20, 4, True)]),
    # the top of every tree (the layers of at most 2^TAIL_LOG nodes, one
    # launch), and the top of a tree of 2^3 leaves
    *(Row("merkle_tail", f"{log} layers above [8,2^{log}]",
          partial(merkle_tail_case, log))
      for log in (blake2s.TAIL_LOG + 1, 3)),
    # the proof-of-work grind from three channel states at pow_bits 12, 16
    # and 20 over 2^20 nonces, and across nonce 2^32; then a launch as a
    # pow_bits-26 grind makes it, 2^24 nonces, at a pow_bits no digest
    # reaches (128: all of words 0-3 zero), so that every nonce is hashed
    *(Row("blake2s_grind", f"{label} pow_bits {pow_bits}, [{start}, +2^20)",
          partial(grind_case, label, pow_bits, start, 1 << 20))
      for label in ("fresh", "mix_u64", "mix_root")
      for pow_bits, start in [(12, 0), (16, 0), (20, 0), (16, (1 << 32) - 3)]
      if not start or label == "fresh"),
    Row("blake2s_grind", "fresh pow_bits 128, 2^24 nonces, all hashed",
        partial(grind_case, "fresh", 128, 0, 1 << 24)),
    # the mixes the channel makes -- a root (64 bytes hashed, read in its
    # layer), a u64 (40 bytes) and four QM31s (96 bytes, two blocks) -- an
    # FRI layer's step (a root's mix and one draw), k draws, and the
    # rejecting state
    Row("blake2s_transcript", "mix_root: 64 B hashed",
        partial(transcript_case, 8, 32, 0, strided=True)),
    Row("blake2s_transcript", "mix_u64: 40 B",
        partial(transcript_case, 2, 8, 0)),
    Row("blake2s_transcript", "mix_felts of 4 QM31: 96 B, two blocks",
        partial(transcript_case, 16, 64, 0)),
    Row("blake2s_transcript", "FRI layer: mix_root + 1 draw",
        partial(transcript_case, 8, 32, 1, strided=True)),
    *(Row("blake2s_transcript", f"{k} draw(s)",
          partial(transcript_case, None, None, k)) for k in (1, 2, 5)),
    Row("blake2s_transcript", "rejecting state: zero digest, n_sent "
        f"{REJECTING_N_SENT}, 1 draw",
        partial(transcript_case, None, None, 1, rejecting=True)),
    # wide Fibonacci 2^16 FRI layer; the LogUp 2^20 prove's largest
    # deinterleaves; the first halving of a GKR 2^20 layer
    *(Row("deinterleave", "[" + ",".join(map(_pow2, shape)) + "]",
          partial(deinterleave_case, shape))
      for shape in [(4, 1 << 18), (8, 1 << 22), (4, 4, 1 << 21),
                    (4, 1 << 20)]),
    Row("m31_mul", "[2^24]", partial(m31_case, 1 << 24)),
    Row("m31_mul_chain", "[2^24] reps 8", partial(m31_case, 1 << 24, reps=8)),
    # a Hades permutation of 1, 1000 and 2^16 states
    *(Row("hades_permutation", f"[3,8,{n}]", partial(hades_case, n))
      for n in (1, 1000, 1 << 16)),
    # Poseidon252 Merkle layers as the commits give them to the kernel: a
    # leaf layer of 3 columns (the basic AIR's trace) and of 9 (two
    # blocks), an inner layer without columns, an inner layer where a
    # [4, n] stack joins (the FRI first layer); then the 2^20 prove's
    # largest layers
    *(_poseidon_layer_row(*args) for args in [
        (14, 3, False), (12, 9, False), (13, 0, True), (10, 4, True),
        (21, 3, False), (21, 0, True), (22, 4, False), (21, 4, True)]),
)

# the composition's programs of the cells' AIRs: wide Fibonacci 2^20 x 100
# on its 2^21 domain, Poseidon2 2^17 on its 2^19 domain; and LogUp 2^20 in
# both `pairs` modes
WIDE_FIB_PROGRAM = Row("constraint_eval", "[100,2^21] wide_fib",
                       partial(program_case, "wide_fib", 20, columns=100))
POSEIDON2_PROGRAM = Row("constraint_eval", "[1296,2^19] poseidon2",
                        partial(program_case, "poseidon2", 17, expand=2))
LOGUP_PROGRAMS = tuple(
    Row("constraint_eval", f"[2^21] logup {kind}",
        partial(program_case, f"logup_{kind}", 20)) for kind in
    ("pairs", "single"))
PROGRAM_ROWS = (WIDE_FIB_PROGRAM, POSEIDON2_PROGRAM, *LOGUP_PROGRAMS)

# the quotient groups of the benchmark's cells: wf100_b2s.2e20, the 100
# trace columns at 2^21 and the composition's 4 at 2^22; p2_b2s.2e17, 1264
# trace and 32 interaction columns at 2^18, 4 of them also at z - g, and
# the composition's 4 at 2^20
QUOTIENT_ROWS = tuple(
    Row("accumulate_quotients", f"[{k},2^{log}], {n} batch(es)",
        partial(quotient_case, k, log, n, every=every))
    for k, log, n, every in [(100, 21, 1, 3), (4, 22, 1, 3),
                             (1296, 18, 2, 324), (4, 20, 1, 3)])

# the GKR cell's rounds (gkr_b2s.2e20: a GrandProduct and a LogUpGeneric
# instance of 2^20 points): each layer kind's first round at 2^18 terms
# (a 2^20-point layer, its eq table as long), LogUpGeneric at 2^10 terms
# and at 1 (the last round: a launch); the first folds of a 2^20-point
# layer ([4, 2^20], and [2^20] base numerators), one at 2^11 and one of 2
# points
GKR_ROWS = (
    *(Row("gkr_round_sums", f"{kind} 2^18 terms",
          partial(gkr_round_sums_case, kind, 1 << 18))
      for kind in GKR_COLUMNS),
    *(Row("gkr_round_sums", f"LogUpGeneric {_pow2(n)} term(s) of a 2^19 eq",
          partial(gkr_round_sums_case, gkr_kernels.LOGUP_GENERIC, n,
                  eq_len=1 << 19)) for n in (1 << 10, 1)),
    *(Row("mle_fold", ("[2^20] base" if base else f"[4,{_pow2(n)}]"),
          partial(mle_fold_case, n, base=base))
      for n, base in [(1 << 20, False), (1 << 20, True), (1 << 11, False),
                      (2, False)]),
)

# the Poseidon252 grind (chip_smoke.py `--only poseidon_grind`): a launch as
# a pow_bits-26 grind makes it, 2^20 nonces, at a pow_bits no digest
# reaches, so that every nonce is hashed; a hit in the first block; hits at
# pow_bits 12 and 16 from each state; a hit past nonce 2^32
POSEIDON_GRIND_ROWS = (
    Row("poseidon_grind", "fresh pow_bits 128, 2^20 nonces, all hashed",
        partial(poseidon_grind_case, "fresh", 128, 0, 1 << 20)),
    Row("poseidon_grind", "mix_u64 pow_bits 6, [0, +2^20)",
        partial(poseidon_grind_case, "mix_u64", 6, 0, 1 << 20)),
    *(Row("poseidon_grind", f"{label} pow_bits {pow_bits}, [0, +2^16)",
          partial(poseidon_grind_case, label, pow_bits, 0, 1 << 16))
      for label in ("fresh", "mix_u64", "mix_root") for pow_bits in (12, 16)),
    Row("poseidon_grind", "fresh pow_bits 12, [2^32 - 3, +2^16)",
        partial(poseidon_grind_case, "fresh", 12, (1 << 32) - 3, 1 << 16)),
)

ROWS = (KERNEL_ROWS + PROGRAM_ROWS + QUOTIENT_ROWS + GKR_ROWS
        + POSEIDON_GRIND_ROWS)
