#!/usr/bin/env python3
"""Smoke run of tstwo_tpu_torch on one CUDA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from tstwo_tpu_torch/csrc, holds each against its
plain PyTorch version on the card at the shapes its path gives it, then
drives ten paths, each with the launch counts set to 0 just before it and
read just after:

  * wide Fibonacci (the main path): the golden 2^8 x 8 proof against the
    committed JAX proof, a 2^12 x 32 CUDA proof against the CPU one, then
    proves and verifies 2^16 x 32 and 2^18 x 64 (pow_bits 5: the grind
    stays on the host, and the grind kernel must not launch; every tree's
    root and every FRI layer goes through the transcript kernel); then the
    FRI commit of a 2^18 x 64 prove's quotients with the transcript on the
    host (`commit_host`) and on the card (`commit`): the same result, the
    host round trips of each counted, `commit`'s dispatch free of any
    synchronising call;
  * the public API with no device named (phase `defaults`): every callable
    of tests/test_torch_defaults.py's CREATORS puts its result on cuda:0;
    the README's custom-AIR recipe at wide Fibonacci 2^18 x 64, from a
    host trace, from a card trace and resumed from a checkpoint, gives
    `prove_wide_fibonacci(18, 64)`'s proof and launches what it launches;
    LogUp 2^12 and a GKR batch built without a device equal their
    device="cuda" twins;
  * the proof-of-work grind, host against card at pow_bits 12, 16, 20
    and 26, then wide Fibonacci 2^18 x 64 at 96 bits of security
    (stwo-cairo's secure_pcs_config: pow_bits 26, 70 queries), which must
    launch the grind kernel, its nonce held against the plain scan on the
    card;
  * the DEEP quotients (phase 8d, `--only quotients` alone): the kernel
    against its plain version at the benchmark cells' quotient groups,
    timed beside its byte bound, then a 96-bit prove of each cell's
    recipe, which must launch it once a group (twice a proof) over the
    committed columns (`quotient_columns` 104 and 1300);
  * the roofline probes (tstwo_tpu_torch/measure_roofline.py), which run
    the M31 probe kernels;
  * LogUp: the golden 2^8 proof against the committed JAX proof, 2^12 CUDA
    proofs against CPU ones for both `pairs` modes, then proves and
    verifies 2^16 and 2^20;
  * GKR: 2^12 batch proofs of each layer kind against CPU ones, then a
    GrandProduct + LogUpGeneric batch at 2^20, verified, with its claims
    checked against the input MLEs;
  * the Poseidon252 flavour of the basic AIR (`prove_basic_air(...,
    flavor="poseidon252")`): the golden 2^4 proof against the committed JAX
    proof, a 2^6 CUDA proof against the CPU one, then proves at 2^16 and
    2^20 rows, each verified on the host by Python-int Hades; the path
    must launch the Poseidon layer kernel and no Blake2s kernel;
  * the Poseidon sponge (`ops.poseidon252.poseidon_hash_many`) over 2^16
    rows, which runs the Hades permutation kernel, against the host's
    hash (the Poseidon252 path must not launch the Blake2s transcript
    kernel either: its transcript stays on the host channel);
  * the mesh prove (`prove_wide_fibonacci(..., mesh=)` and
    `prove_basic_air(..., flavor="poseidon252", mesh=)`, tstwo_tpu_torch/
    parallel): ranks started as processes of this script (`--mesh-rank`),
    each under a timeout, every one on the one card -- wide Fibonacci on
    one NCCL rank at 2^18 x 64, two gloo ranks at 2^16 x 32 and four gloo
    ranks at 2^18 x 64; the Poseidon252 basic AIR on one NCCL rank at
    2^20, two gloo ranks at 2^16 and four gloo ranks at 2^20.  Every
    rank's proof must equal the single-device proof of the same size and
    flavour (byte for byte; field by field for Poseidon252), every
    Blake2s rank must launch the CFFT, Merkle layer, Merkle tail,
    deinterleave and transcript kernels, every Poseidon252 rank the
    Poseidon layer kernel, both CFFTs and deinterleave and no Blake2s
    kernel, and every rank's Merkle leaves must cover n/D rows of each
    sharded column.  Its walls are those of ranks sharing one card, not
    of a multi-GPU run.

Each phase prints one line (name, seconds, result); any failure exits
non-zero.  The second-to-last line is the kernel table as JSON, the last
line the result JSON.  Imports nothing of JAX.

A row of the kernel table: `ms` is the kernel's device time over a run of
many launches between two CUDA events (warm L2), `cold_ms` its time after
64 MiB were written, `host_us` what one call costs the enqueueing thread
(tstwo_tpu_torch/measure_roofline.py::time_call); `plain_ms` the plain
PyTorch version and `library_ms` (`library_host_us`) the PyTorch call for
the same function, where one exists, timed the same way; `bound_ms` the least time the card
could take, the larger of the bytes moved once over HBM_BYTES_PER_S and
the integer operations over INT32_OPS_PER_S, and `bound_by` which of the
two; `launches` the count from the path that runs the kernel.  A CFFT row
also has `passes`, the kernel launches of one transform (checked against
`ops.fft.cfft_plan` and the limits 1 / 2 / 3 up to 2^11 / 2^22 / 2^30
points), and `columns_per_block`, the columns of the batch a block of each
pass walks over with its twiddles in registers.  A forward CFFT from a
coefficient length m < n is bound by what that function needs: m words
read a column and log2(m) layers of butterflies (the layers above only
copy); `bound_full_n_ms` is the bound of the full transform of n points
beside it, the same whatever implements the zero-extension.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
FIXTURE = ROOT / "tests" / "data" / "torch_port_wide_fib_log8x8_seed0.json"
LOGUP_FIXTURE = ROOT / "tests" / "data" / "torch_port_logup_log8_seed0.json"
POSEIDON_FIXTURE = (ROOT / "tests" / "data"
                    / "torch_port_basic_air_poseidon_log4.json")
CSRC = "tstwo_tpu_torch/csrc/"
REPLACES = {
    "cfft_forward": "tstwo_tpu/ops/pallas/fft_kernels.py:545",
    "cfft_inverse": "tstwo_tpu/ops/pallas/fft_kernels.py:380",
    "cfft_block_resident": "tstwo_tpu/ops/pallas/fft_kernels.py:147",
    "blake2s": "tstwo_tpu/ops/blake2s.py:262",
    "merkle_layer": "tstwo_tpu/ops/blake2s.py:262, "
                    "tstwo_tpu/ops/pallas/interleave.py:50",
    "merkle_tail": "tstwo_tpu/ops/blake2s.py:262, "
                   "tstwo_tpu/ops/pallas/interleave.py:50",
    "blake2s_grind": "tstwo_tpu/ops/blake2s.py:262 (via "
                     "tstwo_tpu/proof_of_work.py:29)",
    # no Pallas kernel: the jitted device transcript of the JAX package
    "blake2s_transcript": "tstwo_tpu/channel/device.py:89 draw_base_felts, "
                          ":59 mix_root (jitted program)",
    "deinterleave": "tstwo_tpu/ops/pallas/interleave.py:50",
    "m31_mul": "tstwo_tpu/ops/pallas/m31_kernels.py:58",
    "m31_mul_chain": "tstwo_tpu/ops/pallas/m31_kernels.py:90",
    # no Pallas kernel: the jitted programs these two are the counterparts of
    "hades_permutation": "tstwo_tpu/ops/poseidon252.py:198 (jitted program)",
    "poseidon_merkle_layer": "tstwo_tpu/vcs/poseidon252_merkle.py:55 "
                             "(jitted program)",
    "constraint_eval": "tstwo_tpu/constraint_framework/__init__.py:545 "
                       "_domain_kernel (jitted program)",
    "accumulate_quotients": "tstwo_tpu/pcs/quotients.py:149 "
                            "_accumulate_quotients_kernel (jitted program)",
}
# One H100 SXM (NVIDIA's data sheet): 3.35 TB/s of device memory; 67
# TFLOP/s of float32 outside the tensor cores = 132 SMs x 128 lanes x 2 (a
# fused multiply-add) x 1.98 GHz.  An SM issues int32 operations on half
# of those lanes and an add, xor or shift is one operation, so the integer
# peak is taken as a quarter of that figure: 1.675e13 operations/s.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 4
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
# `source_count_ms` is beside the bound in a row: the kernel's own count from
# its source over the same rate, which says how far the kernel's body is
# from what the function needs, and how close the kernel runs to its own
# body.  It counts the primitives of csrc/felt252.cuh, one PTX instruction
# each (tests/test_torch_felt252_source_count.py counts them on the host):
# a product is 128 for the 16-word product (a mad.wide and an add with
# carry a term) and 54 for the reduction (m read off the words, m * p as
# products by 17 and shifts by 27 in two subtractions, and p added back to
# a negative result): 182; a square is 92 (the 28 cross products, a one-bit
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
P252 = (1 << 251) + 17 * (1 << 192) + 1
# felts that stress the carries and the reduction: the ends of the field,
# the words of p, runs of set words and their neighbours
FELT_EDGE = [0, 1, 2, P252 - 1, P252 - 2, 1 << 251, (1 << 251) - 1, 17 << 192,
             (1 << 192) - 1, (1 << 224) - 1, ((1 << 251) - 1) - (17 << 192),
             (1 << 32) - 1]
P = (1 << 31) - 1
M31_EDGE = [0, 1, 2, P - 1, P - 2, 1 << 16, (1 << 16) - 1, (1 << 30) + 12345]


def phase(name: str, seconds: float, result: str) -> None:
    print(f"phase {name}: {seconds:.3f} s: {result}", flush=True)


def fail(msg: str) -> None:
    print(f"FAILED: {msg}", flush=True)
    sys.exit(1)


def max_abs_err(a, b) -> int:
    import torch

    if a.shape != b.shape:
        fail(f"shape mismatch {tuple(a.shape)} vs {tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())


def row_checker(rows: list):
    """`check(name, shape, kernel, plain, source, n_bytes, n_ops, ...)`,
    which holds kernel() against plain() (exact), times both and appends a
    row of the kernel table to `rows`."""
    import torch

    from tstwo_tpu_torch.measure_roofline import time_call, time_ms

    def check(name, shape, kernel, plain, source, n_bytes, n_ops,
              library=None, extra=None):
        """One row: `kernel` against `plain` (exact), both timed; the
        bound from the bytes the function must move and the integer
        operations it must do."""
        t0 = time.perf_counter()
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        got_t = got if isinstance(got, (tuple, list)) else (got,)
        want_t = want if isinstance(want, (tuple, list)) else (want,)
        if len(got_t) != len(want_t):
            fail(f"{name} {shape}: {len(got_t)} results, plain {len(want_t)}")
        err = max(max_abs_err(g, w) for g, w in zip(got_t, want_t))
        timing, plain_ms = time_call(kernel), time_ms(plain)
        lib_t = {"ms": None, "host_us": None} if library is None \
            else time_call(library, cold=False)
        library_ms = lib_t["ms"]
        by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
        by_ops = n_ops / INT32_OPS_PER_S * 1e3
        bound_ms = max(by_bytes, by_ops)
        phase(f"kernel {name} {shape}", time.perf_counter() - t0,
              f"max_abs_err {err} (tolerance 0), kernel {timing['ms']:.4f} ms"
              f" (cold {timing['cold_ms']:.4f} ms, host "
              f"{timing['host_us']:.1f} us), plain {plain_ms:.4f} ms"
              + (f", library {library_ms:.4f} ms (host "
                 f"{lib_t['host_us']:.1f} us)" if library else "")
              + f", bound {bound_ms:.4f} ms"
              + "".join(f", {k} {v}" for k, v in (extra or {}).items()))
        if err != 0:
            fail(f"{name} {shape} disagrees with its plain version")
        rows.append({"name": name, "shape": shape, "route": "cuda",
                     "source": CSRC + source, "replaces": REPLACES[name],
                     "max_abs_err": err, "ms": timing["ms"],
                     "cold_ms": timing["cold_ms"],
                     "host_us": timing["host_us"], "plain_ms": plain_ms,
                     "bound_ms": bound_ms,
                     "bound_by": "bytes" if by_bytes >= by_ops
                     else "operations",
                     "library_ms": library_ms,
                     "library_host_us": lib_t["host_us"], **(extra or {})})

    return check


def compare_kernels(device):
    """Phase 3: every kernel against its plain version at the shapes its
    paths give it (exact: tolerance 0).  Returns the kernel-table rows."""
    import numpy as np
    import torch

    from tstwo_tpu_torch.circle import CanonicCoset
    from tstwo_tpu_torch.ops import blake2s, fft, fri_ops, m31_kernels
    from tstwo_tpu_torch.ops import poseidon252 as pos
    from tstwo_tpu_torch.poly.twiddles import precompute_twiddles
    from tstwo_tpu_torch.utils import to_torch_u32

    rng = np.random.default_rng(1)
    # the twiddle trees of the 2^16 x 32 wide-Fibonacci prove and of the
    # LogUp 2^20 prove (root cosets of log 18 and 22)
    tree = precompute_twiddles(CanonicCoset.new(18).circle_domain().half_coset)
    tree22 = precompute_twiddles(
        CanonicCoset.new(22).circle_domain().half_coset)

    def rand(shape, high=P):
        return to_torch_u32(rng.integers(0, high, size=shape, dtype=np.uint64)
                            .astype(np.uint32), device)

    rows = []
    check = row_checker(rows)

    # wide Fibonacci 2^16 x 32: extension, composition, interpolation; the
    # one-pass transform alone, at 10 and at 6 layers.  LogUp 2^20:
    # extensions of 1, 2 and 4 columns, the composition, interpolations of
    # the trace and the composition.  Then the calls as the proves really
    # make them, with the coefficient length m (zero-extended inside the
    # kernel) and the 1/N scale: wide Fibonacci 2^18 x 64 (trace
    # interpolation, extension, the composition's pair) and LogUp 2^20.
    # Last the three-pass plan, at 2^24 points under random twiddles.
    for name, (batch, log_n), log_m, scaled, twiddles in [
            ("cfft_forward", (32, 17), 17, False, tree),
            ("cfft_forward", (4, 18), 18, False, tree),
            ("cfft_inverse", (32, 16), 16, False, tree),
            ("cfft_block_resident", (32, 10), 10, False, tree),
            ("cfft_block_resident", (32, 6), 6, False, tree),
            ("cfft_forward", (1, 21), 21, False, tree22),
            ("cfft_forward", (4, 21), 21, False, tree22),
            ("cfft_forward", (4, 22), 22, False, tree22),
            ("cfft_inverse", (4, 20), 20, False, tree22),
            ("cfft_inverse", (4, 21), 21, False, tree22),
            ("cfft_inverse", (64, 18), 18, True, tree22),
            ("cfft_forward", (64, 19), 18, False, tree22),
            ("cfft_inverse", (4, 19), 19, True, tree22),
            ("cfft_forward", (4, 20), 19, False, tree22),
            ("cfft_inverse", (4, 20), 20, True, tree22),
            ("cfft_forward", (1, 21), 20, False, tree22),
            ("cfft_forward", (4, 21), 20, False, tree22),
            ("cfft_inverse", (4, 21), 21, True, tree22),
            ("cfft_forward", (4, 22), 21, False, tree22),
            ("cfft_forward", (2, 24), 24, False, None),
            ("cfft_inverse", (2, 24), 24, True, None)]:
        inverse = name == "cfft_inverse"
        n, m = 1 << log_n, 1 << log_m
        x = rand((batch, m))
        scale = pow(n, P - 2, P) if scaled else None
        if twiddles is None:
            circle = rand(n // 2)
            line = [rand(n >> (l + 1)) for l in range(1, log_n)]
            buf = fft.twiddle_buffer(line, circle)
        else:
            line, circle, buf = twiddles.fft_twiddles(log_n, inverse, device)
        # the passes the library launches against the plan the tests pin,
        # and the kernel launches one call really makes
        passes = fft.cfft_kernel_plan(batch, log_n, inverse)
        before = fft.cfft_kernel_launches()
        fft.cfft_cuda(x, buf, log_n, inverse, scale, m)
        made = fft.cfft_kernel_launches() - before
        want = fft.cfft_plan(log_n, inverse)
        limit = 1 if log_n <= 11 else 2 if log_n <= 22 else 3
        if [p[:4] for p in passes] != want or made != len(want) \
                or made > limit:
            fail(f"{name} [{batch},2^{log_n}]: {made} kernel launches, "
                 f"library plan {passes}, cfft_plan {want}")
        cols = [p[4] for p in passes]

        def plain():
            full = x if m == n else torch.nn.functional.pad(x, (0, n - m))
            return fft.fft_plain(full, line, circle, inverse, scale)

        check(name, f"[{batch},2^{log_n}]"
              + (f" from m=2^{log_m}" if m != n else "")
              + (" scaled" if scaled else ""),
              lambda: fft.cfft_cuda(x, buf, log_n, inverse, scale, m),
              plain, "cfft.cu",
              n_bytes=4 * (batch * m + batch * n + n),
              n_ops=BUTTERFLY_OPS * batch * (n >> 1) * log_m,
              extra={"passes": made, "columns_per_block": cols,
                     "bound_full_n_ms": max(
                         4 * (2 * batch * n + n) / HBM_BYTES_PER_S,
                         BUTTERFLY_OPS * batch * (n >> 1) * log_n
                         / INT32_OPS_PER_S) * 1e3})
        del x, line, circle, buf

    def hash_cost(n, byte_len, words_read):
        """(bytes, operations) of n hashes of byte_len-byte messages that
        read `words_read` words each and write 8."""
        n_blocks = max(1, -(-byte_len // 64))
        return (4 * n * (words_read + 8), B2S_OPS_PER_BLOCK * n_blocks * n)

    # wide Fibonacci: 128-byte leaves (32 columns), 64-byte nodes.  LogUp
    # 2^20: leaves of 1, 2 and 4 columns, and the 80-byte two-block hashes
    # of a node level that takes in columns.  Here every word of the blocks
    # is given and read, those past the message zero.
    for (n_words, log_n), byte_len in [
            ((32, 17), 128), ((16, 16), 64), ((16, 21), 4), ((16, 21), 8),
            ((16, 21), 16), ((16, 22), 16), ((32, 21), 80)]:
        w = rand((n_words, 1 << log_n), 1 << 32)
        w[-(-byte_len // 4):] = 0
        n_bytes, n_ops = hash_cost(1 << log_n, byte_len, n_words)
        check("blake2s", f"[{n_words},2^{log_n}] {byte_len} B",
              lambda: blake2s.hash_words_major_cuda(w, byte_len),
              lambda: blake2s.hash_words_major_plain(w, byte_len),
              "blake2s.cu", n_bytes, n_ops)

    # Merkle layers as the commits give them to the kernel, columns read
    # where they lie.  Leaf layers (counted as blake2s): the 64 columns of
    # the 2^18 x 64 trace tree (256 B, four blocks), a FRI layer's [4, n]
    # (16 B), LogUp 2^20's interaction stack.  Node layers (merkle_layer):
    # 64 B from the child pairs alone; 80 B where 4 columns join (LogUp).
    for name, log_n, n_cols, with_prev in [
            ("blake2s", 19, 64, False), ("blake2s", 18, 4, False),
            ("blake2s", 21, 4, False), ("merkle_layer", 18, 0, True),
            ("merkle_layer", 16, 0, True), ("merkle_layer", 21, 0, True),
            ("merkle_layer", 20, 4, True)]:
        n = 1 << log_n
        prev = rand((8, 2 * n), 1 << 32) if with_prev else None
        cols = [rand((n_cols, n))] if n_cols else []
        words = n_cols + (16 if with_prev else 0)
        n_bytes, n_ops = hash_cost(n, 4 * words, words)
        check(name,
              (f"2^{log_n} nodes of [8,2^{log_n + 1}]" if with_prev else "")
              + (" + " if with_prev and n_cols else "")
              + (f"[{n_cols},2^{log_n}]" if n_cols else "")
              + f" {4 * words} B",
              lambda: blake2s.merkle_layer_cuda(prev, cols),
              lambda: blake2s.merkle_layer_plain(prev, cols),
              "blake2s.cu", n_bytes, n_ops)
        del prev, cols

    # the top of every tree: the layers of at most 2^TAIL_LOG nodes, one
    # launch, each layer held against the plain loop; and the top of a tree
    # of 2^3 leaves
    for log in (blake2s.TAIL_LOG + 1, 3):
        prev = rand((8, 1 << log), 1 << 32)
        nodes = (1 << log) - 1
        check("merkle_tail", f"{log} layers above [8,2^{log}]",
              lambda: blake2s.merkle_tail_cuda(prev),
              lambda: blake2s.merkle_tail_plain(prev), "blake2s.cu",
              n_bytes=4 * 8 * ((1 << log) + nodes),
              n_ops=B2S_OPS_PER_BLOCK * nodes)

    # the proof-of-work grind: the kernel's least hit against the plain
    # scan on the card, from three channel digests at pow_bits 12, 16 and
    # 20 over 2^20 nonces and over a range across nonce 2^32; the bound
    # counts the nonces up to the hit, all the function needs (the kernel's
    # blocks past a hit return at once).  Then a launch as a pow_bits-26
    # grind makes it, 2^24 nonces, at a pow_bits no digest reaches (128:
    # all of words 0-3 zero), so that every nonce is hashed.
    for label, words in grind_digests():
        for pow_bits, start, count in [(12, 0, 1 << 20), (16, 0, 1 << 20),
                                       (20, 0, 1 << 20),
                                       (16, (1 << 32) - 3, 1 << 20)]:
            if start and label != "fresh":
                continue
            hit = blake2s.grind_batch_plain(words, start, count, pow_bits,
                                            device)
            needed = count if hit < 0 else hit - start + 1
            check("blake2s_grind",
                  f"{label} pow_bits {pow_bits}, [{start}, +2^20): hit "
                  f"{hit}",
                  lambda: blake2s.grind_hit_cuda(words, start, count,
                                                 pow_bits, device),
                  lambda: blake2s.grind_hit_plain(words, start, count,
                                                  pow_bits, device),
                  "blake2s.cu", n_bytes=4 * 8 + 8,
                  n_ops=B2S_OPS_PER_BLOCK * needed,
                  extra={"nonces_needed": needed})
    words = grind_digests()[0][1]
    check("blake2s_grind", "fresh pow_bits 128, 2^24 nonces, all hashed",
          lambda: blake2s.grind_hit_cuda(words, 0, 1 << 24, 128, device),
          lambda: blake2s.grind_hit_plain(words, 0, 1 << 24, 128, device),
          "blake2s.cu", n_bytes=4 * 8 + 8,
          n_ops=B2S_OPS_PER_BLOCK * (1 << 24),
          extra={"nonces_needed": 1 << 24})

    transcript_rows(check, rand, device)

    # wide Fibonacci 2^16 FRI layer; the LogUp 2^20 prove's largest
    # deinterleaves; the first halving of a GKR 2^20 layer.  The PyTorch
    # call for the same function is the two strided copies.
    for shape in [(4, 1 << 18), (8, 1 << 22), (4, 4, 1 << 21), (4, 1 << 20)]:
        x = rand(shape)

        def copies():
            return tuple(t.contiguous() for t in fri_ops.deinterleave_plain(x))

        check("deinterleave",
              "[" + ",".join(f"2^{d.bit_length() - 1}" if d > 8 else str(d)
                             for d in shape) + "]",
              lambda: fri_ops.deinterleave_cuda(x), copies,
              "deinterleave.cu", n_bytes=8 * x.numel(), n_ops=0,
              library=copies)

    # the roofline probe's shapes: N = 2^24, 8 dependent products
    a, b = rand(1 << 24), rand(1 << 24)
    check("m31_mul", "[2^24]", lambda: m31_kernels.mul_cuda(a, b),
          lambda: m31_kernels.mul_plain(a, b), "m31_kernels.cu",
          n_bytes=12 * a.numel(), n_ops=M31_MUL_OPS * a.numel())
    check("m31_mul_chain", "[2^24] reps 8",
          lambda: m31_kernels.mul_chain_cuda(a, b, 8),
          lambda: m31_kernels.mul_chain_plain(a, b, 8), "m31_kernels.cu",
          n_bytes=12 * a.numel(), n_ops=8 * M31_MUL_OPS * a.numel())
    # The Hades permutation of a batch: 1, 1000 and 2^16 states, the edge
    # felts in every position of the first states, the rest random.
    def rand_felts(n):
        words = rng.integers(0, 1 << 32, size=(8, n), dtype=np.uint64)
        words[7] &= (1 << 19) - 1  # below 2^251, so below p
        return to_torch_u32(words.astype(np.uint32), device)

    def hades_row(name, shape, n_perms, n_bytes, **kw):
        ops = HADES_OPS * n_perms
        check(name, shape, source="poseidon252.cu", n_bytes=n_bytes,
              n_ops=ops, extra={"source_count_ms": max(
                  n_bytes / HBM_BYTES_PER_S,
                  HADES_SOURCE_OPS * n_perms / INT32_OPS_PER_S) * 1e3}, **kw)

    edge = pos.ints_to_felts(FELT_EDGE, device)
    for n in (1, 1000, 1 << 16):
        state = torch.stack([rand_felts(n) for _ in range(3)])
        m = min(n, len(FELT_EDGE))
        for k in range(3):
            state[k, :, :m] = edge.roll(k, dims=1)[:, :m]
        hades_row("hades_permutation", f"[3,8,{n}]", n, 2 * 96 * n,
                  kernel=lambda: pos.hades_permutation_cuda(state),
                  plain=lambda: pos.hades_permutation_plain(state))
    # Poseidon252 Merkle layers as the commits give them to the kernel: a
    # leaf layer of 3 columns (the basic AIR's trace) and of 9 (two blocks),
    # an inner layer without columns, an inner layer where a [4, n] stack
    # joins (the FRI first layer); then the 2^20 prove's largest layers
    # (there the plain version takes seconds a call: ~40k passes over the
    # batch a permutation).
    for log_n, n_cols, with_prev in [
            (14, 3, False), (12, 9, False), (13, 0, True), (10, 4, True),
            (21, 3, False), (21, 0, True), (22, 4, False), (21, 4, True)]:
        n = 1 << log_n
        prev = rand_felts(2 * n) if with_prev else None
        if with_prev:  # the edge felts as the children of the first nodes
            prev[:, :len(FELT_EDGE)] = edge
        cols = [rand((n_cols, n))] if n_cols else []
        n_felts = (2 if with_prev else 0) + -(-n_cols // 8) + 1
        hades_row("poseidon_merkle_layer",
                  (f"2^{log_n} nodes of [8,2^{log_n + 1}]" if with_prev
                   else f"2^{log_n} leaves")
                  + (f" + [{n_cols},2^{log_n}]" if n_cols else ""),
                  n * -(-n_felts // 2),
                  4 * n * (n_cols + (16 if with_prev else 0) + 8),
                  kernel=lambda: pos.merkle_layer_cuda(prev, cols, n, device),
                  plain=lambda: pos.merkle_layer_plain(prev, cols, n, device))
        del prev, cols
    # the Pallas tests' edge values at lengths the TPU tiling refused
    t0 = time.perf_counter()
    for n in (1, 1000, 4097):
        ea = to_torch_u32(np.resize(np.array(M31_EDGE, np.uint32), n), device)
        eb = ea.flip(0).contiguous()
        for reps in (0, 1, 8):
            if max_abs_err(m31_kernels.mul_chain_cuda(ea, eb, reps),
                           m31_kernels.mul_chain_plain(ea, eb, reps)):
                fail(f"m31_mul_chain edge values N={n} reps={reps}")
        if max_abs_err(m31_kernels.mul_cuda(ea, eb),
                       m31_kernels.mul_plain(ea, eb)):
            fail(f"m31_mul edge values N={n}")
    phase("kernel m31 edge values N=1,1000,4097", time.perf_counter() - t0,
          "m31_mul and m31_mul_chain (reps 0, 1, 8) exact")
    # the proves below share these twiddle trees: drop the device copies
    # the rows above cached on them, so that a prove's peak memory holds
    # only what the prove itself puts on the card
    for twiddles in (tree, tree22):
        twiddles.drop_device_copies()
    return rows


# A zero digest at n_sent 238,210,102: word 3 of that draw is 0xFFFFFFFE >=
# 2P, so the draw is rejected whole and the hash at 238,210,103 is drawn.
REJECTING_N_SENT = 238_210_102


def transcript_rows(check, rand, device) -> None:
    """Phase 3's rows of the transcript kernel (one thread; exact): the
    mixes the channel makes -- a root (64 bytes hashed), a u64 (40 bytes)
    and four QM31s (96 bytes, two blocks) -- an FRI layer's step (a root's
    mix and one draw), k = 1, 2 and 5 draws, and the rejecting state; then
    k = 1, 2 and 5 draws from five random states, unrowed.  The plain
    version runs on the same tensors.  The bound counts the compressions
    this data needs (a rejected draw is one more) at 656 operations each."""
    import torch

    from tstwo_tpu_torch.ops import blake2s

    def count(n_sent):
        lo, hi = (int(w) & 0xFFFFFFFF for w in n_sent.tolist())
        return lo | hi << 32

    def row(label, digest, n_sent, msg, msg_bytes, k):
        _, out, _ = blake2s.transcript_plain(digest, n_sent, msg, msg_bytes,
                                             k)
        blocks = 0 if msg is None else -(-(32 + msg_bytes) // 64)
        hashes = blocks + count(out) - (count(n_sent) if msg is None else 0)
        words = 8 + (2 if msg is None else -(-msg_bytes // 4)) + 10 + 8 * k
        check("blake2s_transcript", label,
              lambda: blake2s.transcript_cuda(digest, n_sent, msg, msg_bytes,
                                              k),
              lambda: blake2s.transcript_plain(digest, n_sent, msg,
                                               msg_bytes, k),
              "blake2s.cu", n_bytes=4 * words,
              n_ops=B2S_OPS_PER_BLOCK * hashes,
              extra={"compressions": hashes})

    digest, n_sent = rand(8, 1 << 32), rand(2, 1 << 20)
    root = rand((8, 3), 1 << 32)[:, 0]  # in place in its layer, strided
    row("mix_root: 64 B hashed", digest, None, root, 32, 0)
    row("mix_u64: 40 B", digest, None, rand(2, 1 << 32), 8, 0)
    row("mix_felts of 4 QM31: 96 B, two blocks", digest, None, rand(16), 64,
        0)
    row("FRI layer: mix_root + 1 draw", digest, None, root, 32, 1)
    for k in (1, 2, 5):
        row(f"{k} draw(s)", digest, n_sent, None, None, k)
    zero = torch.zeros(8, dtype=torch.int32, device=device)
    rejecting = torch.tensor([REJECTING_N_SENT, 0], dtype=torch.int32,
                             device=device)
    row(f"rejecting state: zero digest, n_sent {REJECTING_N_SENT}, 1 draw",
        zero, rejecting, None, None, 1)
    got = blake2s.transcript_cuda(zero, rejecting, k=1)
    if got[1].tolist() != [REJECTING_N_SENT + 2, 0]:
        fail(f"the rejecting state drew at n_sent {got[1].tolist()}")
    t0 = time.perf_counter()
    for _ in range(5):
        digest, n_sent = rand(8, 1 << 32), rand(2, 1 << 32)
        for k in (1, 2, 5):
            for g, w in zip(blake2s.transcript_cuda(digest, n_sent, k=k),
                            blake2s.transcript_plain(digest, n_sent, k=k)):
                if max_abs_err(g, w):
                    fail(f"blake2s_transcript: {k} draws from a random "
                         "state disagree with the plain version")
    phase("kernel blake2s_transcript five random states",
          time.perf_counter() - t0,
          "k = 1, 2, 5 draws from each (64-bit counts) exact")


def grind_digests() -> list:
    """(label, digest words) of three channel states: fresh, after a u64,
    after a root."""
    from tstwo_tpu_torch.channel.blake2s import Blake2sChannel
    from tstwo_tpu_torch.ops.blake2s import digest_bytes_to_words

    fresh, mixed, rooted = Blake2sChannel(), Blake2sChannel(), \
        Blake2sChannel()
    mixed.mix_u64(0x123456789)
    rooted.mix_root(bytes(range(32)))
    return [(label, digest_bytes_to_words(ch.digest)) for label, ch in
            (("fresh", fresh), ("mix_u64", mixed), ("mix_root", rooted))]


def proof_json(proof) -> str:
    from tstwo_tpu_torch.serialize import proof_to_dict

    return json.dumps(proof_to_dict(proof), sort_keys=True)


def main() -> None:
    if not (ROOT / "tstwo_tpu_torch" / "kernels.py").is_file():
        fail("tstwo_tpu_torch is not beside this script")
    for fixture in (FIXTURE, LOGUP_FIXTURE, POSEIDON_FIXTURE):
        if not fixture.is_file():
            fail(f"missing golden fixture {fixture}")
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    sys.path.insert(0, str(ROOT))
    from tstwo_tpu_torch import kernels
    from tstwo_tpu_torch.examples.wide_fibonacci import (
        prove_wide_fibonacci, verify_wide_fibonacci)

    # 1. the card
    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    device = torch.device("cuda", 0)
    phase("card", time.perf_counter() - t0,
          f"{torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} device(s)")

    # 2. build
    t0 = time.perf_counter()
    kernels.lib()
    info = kernels.BUILD_INFO
    phase("build", time.perf_counter() - t0,
          f"nvcc {info['seconds']:.1f} s{' (cached)' if info['cached'] else ''}"
          f" -> {Path(info['path']).relative_to(ROOT)}")
    for line in info.get("ptxas", "").splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}", flush=True)

    # 3. kernels against their plain versions
    t0 = time.perf_counter()
    rows = compare_kernels(device)
    phase("kernels", time.perf_counter() - t0, f"{len(rows)} checks exact")

    # 4. golden proof against the JAX package's
    t0 = time.perf_counter()
    proof, comp, cfg = prove_wide_fibonacci(8, 8, seed=0, device=device)
    if proof_json(proof) != FIXTURE.read_text().strip():
        fail("wide-Fibonacci 8x8 CUDA proof differs from the JAX fixture")
    verify_wide_fibonacci(proof, comp, cfg, 8)
    phase("golden", time.perf_counter() - t0,
          "log 8 x 8 seed 0 proof == JAX fixture; verified")

    # 5. mid-size: CUDA proof == the CPU plain path's proof
    t0 = time.perf_counter()
    cuda_json = proof_json(prove_wide_fibonacci(12, 32, seed=0,
                                                device=device)[0])
    cpu_json = proof_json(prove_wide_fibonacci(12, 32, seed=0,
                                               device="cpu")[0])
    if cuda_json != cpu_json:
        fail("wide-Fibonacci 12x32 CUDA proof differs from the CPU proof")
    phase("mid_size", time.perf_counter() - t0,
          "log 12 x 32 CUDA proof == CPU plain proof")

    # 6. real size, counting the kernels the main path launches.  The
    # first prove at a size also fills the host-side caches of that size
    # (twiddle trees, domain points, vanishing inverses); the second is
    # the warm time.
    t0 = time.perf_counter()
    prove_wide_fibonacci(16, 32, seed=0, device=device)  # warm run
    torch.cuda.synchronize()
    phase("warm", time.perf_counter() - t0, "log 16 x 32 warm prove")
    kernels.reset_launches()
    single_json = {}
    for log_n, seq in [(16, 32), (18, 64)]:
        walls = []
        for _ in range(2):
            torch.cuda.reset_peak_memory_stats(device)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            proof, comp, cfg = prove_wide_fibonacci(log_n, seq, seed=0,
                                                    device=device)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated(device)
        t1 = time.perf_counter()
        verify_wide_fibonacci(proof, comp, cfg, log_n)
        phase(f"prove {log_n}x{seq}", walls[1],
              f"two proves {walls[0]:.3f} s, {walls[1]:.3f} s; verified in "
              f"{time.perf_counter() - t1:.3f} s;"
              f" peak device memory {peak / 2**30:.3f} GiB; proof "
              f"{proof.size_estimate()} bytes")
        single_json[(log_n, seq)] = proof_json(proof)
    launches = launch_counts("wide_fibonacci", MAIN_PATH_KERNELS,
                             forbidden=("blake2s_grind",))
    counts = {
        "cfft_forward": launches["cfft_forward"],
        "cfft_inverse": launches["cfft_inverse"],
        # the contiguous pass (fft_fused's work) runs in every transform
        "cfft_block_resident": launches["cfft_forward"]
        + launches["cfft_inverse"],
        "blake2s": launches["blake2s"],
        "merkle_layer": launches["merkle_layer"],
        "merkle_tail": launches["merkle_tail"],
        "deinterleave": launches["deinterleave"],
        "blake2s_transcript": launches["blake2s_transcript"],
    }

    # 6b. the FRI commit with its transcript on the card against the host's
    fri_transcript(device, card)

    # 6c. the public API with no device named: on the card, the same proofs
    defaults_phase(device, single_json[(18, 64)])

    # 7-8. the grind, host against card; the 96-bit prove, which runs it
    grind_rates(device)
    counts["blake2s_grind"] = secure_prove(device)["blake2s_grind"]

    # 8b. constraint programs: the kernel against the plain executor, and
    # the 96-bit 2^20 prove's composition against the eager evaluator
    counts["constraint_eval"] = constraint_eval_phase(device, rows)[
        "constraint_eval"]
    # 8c. the Poseidon2 AIR: its 19,899-instruction program, a 96-bit prove
    # that launches every kernel of the main path and the grind; its
    # program's row carries that prove's launches, the others the counts
    # below
    poseidon2_phase(device, rows)
    # 8d. the DEEP quotients: the kernel at the benchmark cells' groups
    # against the plain version, and a 96-bit prove of each cell's recipe
    counts["accumulate_quotients"] = quotients_phase(device, rows)[
        "accumulate_quotients"]

    # 9. the roofline probes: the M31 probe kernels' path
    launches = roofline(device)
    counts.update(m31_mul=launches["m31_mul"],
                  m31_mul_chain=launches["m31_mul_chain"])

    # 10-12. LogUp, 13-14. GKR, 15-18. the Poseidon252 flavour and sponge
    logup_phases(device)
    gkr_phases(device)
    launches, poseidon_json = poseidon_phases(device)
    counts["poseidon_merkle_layer"] = launches["poseidon_merkle_layer"]
    counts["hades_permutation"] = poseidon_sponge(device)["hades_permutation"]

    # 19. the mesh prove: ranks sharing the card
    single_json.update({(log_n, None): j for log_n, j in poseidon_json.items()})
    mesh_phase(card, single_json)

    for row in rows:
        row.setdefault("launches", counts[row["name"]])
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


# what a prove through the commitment scheme must launch: both CFFTs, leaf
# hashes, node layers that read their child pairs, the one-launch top of a
# tree, the folds' deinterleave, and the transcript step that mixes each
# tree's root on the card (one a tree commit, one an FRI layer).  The grind kernel (`blake2s_grind`)
# runs only where pow_bits >= 12 (proof_of_work.grind): the pow_bits-5
# proves forbid it, the 96-bit prove requires it beside these.
MAIN_PATH_KERNELS = ("cfft_forward", "cfft_inverse", "blake2s",
                     "merkle_layer", "merkle_tail", "deinterleave",
                     "blake2s_transcript", "constraint_eval",
                     "accumulate_quotients")
SECURE_POW_BITS, SECURE_QUERIES = 26, 70  # stwo-cairo's secure_pcs_config


def launch_counts(path: str, required, forbidden=()) -> dict:
    """The launch counts of `path` (reset just before it ran); fails if a
    kernel in `required` was not launched, or one in `forbidden` was."""
    from tstwo_tpu_torch import kernels

    launches = dict(kernels.LAUNCHES)
    phase(f"launches {path}", 0.0, json.dumps(launches, sort_keys=True))
    for name in required:
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched by the {path} path")
    for name in forbidden:
        if launches[name] != 0:
            fail(f"kernel {name} was launched by the {path} path")
    return launches


def timed(fn):
    """(result, seconds) of fn() ending in a device synchronise."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


FRI_WALL_REPEATS = 5


def fri_transcript(device, card: str, log_n: int = 18, seq: int = 64) -> None:
    """Phase 6b: the FRI commit of a warm wide-Fibonacci 2^18 x 64 prove
    (its quotient columns, log 20 and 19, captured from the prove) run by
    `commit_host` (transcript on the host channel) and by `commit`
    (transcript on the card) from the same channel state, in one call.
    Both must give the same roots, channel state, inner layers and
    last-layer poly.  The host round trips of each are counted under
    torch.cuda.set_sync_debug_mode("warn") (and the copies by the
    profiler); `commit`'s dispatch part, before its one fetch, runs under
    "error": a synchronising call there fails the phase.  Walls are
    medians of FRI_WALL_REPEATS, each ended by a synchronise."""
    import statistics
    import warnings

    import torch

    from tstwo_tpu_torch import kernels
    from tstwo_tpu_torch.examples.wide_fibonacci import prove_wide_fibonacci
    from tstwo_tpu_torch.fri import FriProver

    t0 = time.perf_counter()
    captured = {}
    original = FriProver.commit

    def capture(channel, config, columns, twiddles, **kw):
        captured.update(channel=channel.clone(),
                        args=(config, columns, twiddles), kw=kw)
        return original(channel, config, columns, twiddles, **kw)

    FriProver.commit = staticmethod(capture)
    try:
        prove_wide_fibonacci(log_n, seq, seed=0, device=device)
    finally:
        FriProver.commit = staticmethod(original)
    config, columns = captured["args"][:2]
    logs = [c.domain.log_size() for c in columns]

    def run(commit):
        channel = captured["channel"].clone()
        return channel, commit(channel, *captured["args"], **captured["kw"])

    def roots(prover):
        return [prover.first_layer.merkle_tree.root()] + [
            l.merkle_tree.root() for l in prover.inner_layers]

    for commit in (FriProver.commit_host, FriProver.commit):  # warm
        run(commit)
    torch.cuda.synchronize()
    kernels.reset_launches()
    (host_ch, host), (dev_ch, prover) = (run(FriProver.commit_host),
                                         run(FriProver.commit))
    launches = kernels.LAUNCHES["blake2s_transcript"]
    if launches != 1 + len(prover.inner_layers):  # commit_host: none
        fail(f"fri transcript: {launches} transcript launches for "
             f"{len(prover.inner_layers)} inner layers")
    if dev_ch != host_ch or roots(prover) != roots(host) or \
            prover.last_layer_poly.coeffs != host.last_layer_poly.coeffs or \
            any(not torch.equal(a.evaluation.values, b.evaluation.values)
                for a, b in zip(prover.inner_layers, host.inner_layers)):
        fail("fri transcript: commit differs from commit_host")

    def syncs(commit) -> int:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                run(commit)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        return sum("synchroniz" in str(w.message) for w in caught)

    def copies(commit) -> dict:
        """Memcpy events of the device in a profiled commit, by kind."""
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run(commit)
            torch.cuda.synchronize()
        out = {}
        for e in prof.events():
            if e.name.startswith("Memcpy"):
                kind = e.name.split(" (")[0]
                out[kind] = out.get(kind, 0) + 1
        return out

    host_syncs, dev_syncs = syncs(FriProver.commit_host), syncs(
        FriProver.commit)
    torch.cuda.synchronize()
    channel = captured["channel"].clone()
    torch.cuda.set_sync_debug_mode("error")
    try:
        finish = FriProver.commit_dispatch(channel, *captured["args"],
                                           **captured["kw"])
    except RuntimeError as exc:
        fail(f"fri transcript: commit's dispatch synchronised: {exc}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    if finish() is None or channel != host_ch:
        fail("fri transcript: the dispatch and its finish differ from "
             "commit_host")
    if dev_syncs != 1:
        fail(f"fri transcript: commit made {dev_syncs} host round trips")
    walls = {}
    for name, commit in (("commit_host", FriProver.commit_host),
                         ("commit", FriProver.commit),
                         ("commit ", FriProver.commit),
                         ("commit_host ", FriProver.commit_host)):
        times = [timed(lambda: run(commit))[1]
                 for _ in range(FRI_WALL_REPEATS)]
        walls.setdefault(name.strip(), []).append(statistics.median(times))
    host_copies, dev_copies = copies(FriProver.commit_host), copies(
        FriProver.commit)
    phase("fri transcript", time.perf_counter() - t0,
          f"wide Fibonacci 2^{log_n} x {seq} quotients (log {logs}), "
          f"{len(prover.inner_layers)} inner layers, on {card}: commit == "
          f"commit_host (roots, channel, inner layers, last layer); host "
          f"round trips (sync debug warnings) commit {dev_syncs}, "
          f"commit_host {host_syncs}; commit's dispatch clean under "
          f"\"error\"; device copies (profiler) commit "
          f"{json.dumps(dev_copies, sort_keys=True)}, commit_host "
          f"{json.dumps(host_copies, sort_keys=True)}; transcript launches "
          f"{launches} a commit; walls (median of {FRI_WALL_REPEATS}, "
          f"synchronised, in turns host, card, card, host) commit "
          f"{', '.join(f'{w * 1e3:.3f}' for w in walls['commit'])} ms, "
          f"commit_host "
          f"{', '.join(f'{w * 1e3:.3f}' for w in walls['commit_host'])} ms")


def recipe_prove(columns, log_n: int, seq: int, checkpoint=None):
    """The README's custom-AIR recipe at wide Fibonacci's width: the
    commitment scheme, its two trees and `prove` assembled from the public
    classes as examples/wide_fibonacci.py does, naming no device.  With
    `checkpoint` (a path) the scheme and channel are saved after the trace
    commit and the prove goes on from the loaded copy, which must lie on
    cuda:0."""
    import torch

    from tstwo_tpu_torch.channel.blake2s import Blake2sChannel
    from tstwo_tpu_torch.circle import CanonicCoset
    from tstwo_tpu_torch.constraint_framework import (FrameworkComponent,
                                                      TraceLocationAllocator)
    from tstwo_tpu_torch.examples.wide_fibonacci import WideFibonacciEval
    from tstwo_tpu_torch.fields import QM31
    from tstwo_tpu_torch.pcs import PcsConfig
    from tstwo_tpu_torch.pcs.prover import CommitmentSchemeProver
    from tstwo_tpu_torch.poly.circle_poly import CircleEvaluation
    from tstwo_tpu_torch.poly.twiddles import precompute_twiddles
    from tstwo_tpu_torch.prover import prove
    from tstwo_tpu_torch.serialize import (load_prover_checkpoint,
                                           save_prover_checkpoint)

    cuda0 = torch.device("cuda", 0)
    config = PcsConfig()
    domain = CanonicCoset.new(log_n).circle_domain()
    trace = [CircleEvaluation(domain, c) for c in columns]
    twiddles = precompute_twiddles(CanonicCoset.new(
        log_n + 1 + config.fri_config.log_blowup_factor)
        .circle_domain().half_coset)
    channel = Blake2sChannel()
    scheme = CommitmentSchemeProver(config, twiddles)
    if scheme.device != cuda0:
        fail(f"defaults: CommitmentSchemeProver chose {scheme.device}")
    tb = scheme.tree_builder()
    tb.extend_evals([])
    tb.commit(channel)
    channel.mix_u64(log_n)
    tb = scheme.tree_builder()
    tb.extend_evals(trace)
    tb.commit(channel)
    if any(ev.values.device != cuda0 for ev in scheme.trees[1].evaluations):
        fail("defaults: the trace was not extended on cuda:0")
    if checkpoint is not None:
        save_prover_checkpoint(checkpoint, scheme, channel)
        scheme, channel = load_prover_checkpoint(checkpoint, twiddles)
        if scheme.device != cuda0 or any(
                ev.values.device != cuda0
                for tree in scheme.trees for ev in tree.evaluations):
            fail(f"defaults: load_prover_checkpoint chose {scheme.device}")
    component = FrameworkComponent(TraceLocationAllocator(),
                                   WideFibonacciEval(log_n, seq), QM31.zero())
    return prove([component], channel, scheme), component, config


def logup_recipe(log_n: int):
    """The LogUp lookup prove of examples/logup_lookup.py assembled by
    hand with no device named: its preprocessed column from
    `Seq(log_n).gen_column()`, its interaction trace from
    `LogupTraceGenerator(log_n)`."""
    import torch

    from tstwo_tpu_torch.channel.blake2s import Blake2sChannel
    from tstwo_tpu_torch.circle import CanonicCoset
    from tstwo_tpu_torch.constraint_framework import (FrameworkComponent,
                                                      TraceLocationAllocator)
    from tstwo_tpu_torch.constraint_framework.logup import (
        LogupTraceGenerator, LookupElements)
    from tstwo_tpu_torch.constraint_framework.preprocessed import Seq
    from tstwo_tpu_torch.examples import logup_lookup as ll
    from tstwo_tpu_torch.fields import QM31
    from tstwo_tpu_torch.ops import m31
    from tstwo_tpu_torch.pcs import PcsConfig
    from tstwo_tpu_torch.pcs.prover import CommitmentSchemeProver
    from tstwo_tpu_torch.poly.circle_poly import CircleEvaluation
    from tstwo_tpu_torch.poly.twiddles import precompute_twiddles
    from tstwo_tpu_torch.prover import prove

    config = PcsConfig()
    val, mult = ll.generate_trace(log_n, seed=0)
    domain = CanonicCoset.new(log_n).circle_domain()
    twiddles = precompute_twiddles(CanonicCoset.new(
        log_n + 1 + config.fri_config.log_blowup_factor)
        .circle_domain().half_coset)
    channel = Blake2sChannel()
    scheme = CommitmentSchemeProver(config, twiddles)
    tb = scheme.tree_builder()
    tb.extend_evals([Seq(log_n).gen_column()])
    tb.commit(channel)
    channel.mix_u64(log_n)
    tb = scheme.tree_builder()
    tb.extend_evals([CircleEvaluation(domain, val),
                     CircleEvaluation(domain, mult)])
    tb.commit(channel)
    elements = LookupElements.draw(channel, ll.RELATION_SIZE)
    seq = Seq(log_n).gen_column().values
    gen = LogupTraceGenerator(log_n)
    col = gen.new_col()
    col.write_frac(QM31.one(), elements.combine_cols([val]))
    col.write_frac(m31.neg(mult), elements.combine_cols([seq]))
    col.finalize_col()
    interaction, claimed = gen.finalize_last()
    cuda0 = torch.device("cuda", 0)
    if gen.device != cuda0 or seq.device != cuda0 or any(
            ev.values.device != cuda0 for ev in interaction):
        fail("defaults: the LogUp builders did not choose cuda:0")
    tb = scheme.tree_builder()
    tb.extend_evals(interaction)
    tb.commit(channel)
    allocator = TraceLocationAllocator.new_with_preprocessed_columns(
        [Seq(log_n).id()])
    component = FrameworkComponent(
        allocator, ll.LookupEval(log_n, elements, True), claimed)
    return prove([component], channel, scheme), config, claimed


def defaults_phase(device, example_json: str, log_n: int = 18,
                   seq: int = 64) -> None:
    """Phase 6c: the public API with no device named.  (1) every callable
    of tests/test_torch_defaults.py's CREATORS, called without a device,
    must put its result on cuda:0 (and launch its kernel where the list
    names one), and the scan of the package must find no `device` that
    defaults to anything but None (the numpy bridge apart); (2) the
    README recipe at wide Fibonacci 2^18 x 64 from a trace made on the
    host (numpy, `to_torch_u32`) and from `generate_trace` on the card:
    both proofs must equal `prove_wide_fibonacci(18, 64)`'s (phase 6) byte
    for byte, verify, and launch what the example's prove launches;
    (3) a checkpoint saved after the trace commit and loaded with no
    device finishes on cuda:0 to the same proof; (4) the LogUp prove at
    2^12 built by hand from `LogupTraceGenerator(log)` and
    `Seq(log).gen_column()`, and a GKR GrandProduct batch at 2^12 from a
    numpy `Mle`, each equal to its twin with device="cuda"."""
    import tempfile

    import numpy as np
    import torch

    from tstwo_tpu_torch import kernels
    from tstwo_tpu_torch.channel.blake2s import Blake2sChannel
    from tstwo_tpu_torch.examples.logup_lookup import (prove_logup_lookup,
                                                       verify_logup_lookup)
    from tstwo_tpu_torch.examples.wide_fibonacci import (
        generate_trace, prove_wide_fibonacci, verify_wide_fibonacci)
    from tstwo_tpu_torch.lookups.gkr import GRAND_PRODUCT, Layer, prove_batch
    from tstwo_tpu_torch.lookups.mle import Mle
    from tstwo_tpu_torch.utils import to_torch_u32

    sys.path.insert(0, str(ROOT / "tests"))
    import test_torch_defaults as rule

    cuda0 = torch.device("cuda", 0)
    t0 = time.perf_counter()
    wrong = {name: default for name, default in
             rule.DEVICE_PARAMETERS.items()
             if default is not None and default != rule.inspect.Parameter.empty
             and name not in rule.ALLOWED_CPU_DEFAULT}
    if wrong:
        fail(f"defaults: device parameters that are not None: {wrong}")
    for creator in rule.CREATORS:
        before = dict(kernels.LAUNCHES)
        out = creator.make()
        torch.cuda.synchronize()
        placed = [t.device for t in out if isinstance(t, torch.Tensor)]
        if any(d != cuda0 for d in placed):
            fail(f"defaults: {creator.id} put its result on {placed}")
        if creator.kernel and \
                kernels.LAUNCHES[creator.kernel] <= before[creator.kernel]:
            fail(f"defaults: {creator.id} launched no {creator.kernel}")
    names = {c.name for c in rule.CREATORS}
    phase("defaults callables", time.perf_counter() - t0,
          f"{len(rule.CREATORS)} calls of {len(names)} callables with no "
          f"device: every result on cuda:0, every named kernel launched; "
          f"{len(rule.DEVICE_PARAMETERS)} device parameters scanned, only "
          f"{sorted(rule.ALLOWED_CPU_DEFAULT)} defaults to the CPU")

    def counted(fn):
        torch.cuda.synchronize()
        kernels.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        return out, dict(kernels.LAUNCHES)

    t0 = time.perf_counter()
    (example, _, _), example_launches = counted(
        lambda: prove_wide_fibonacci(log_n, seq))
    if proof_json(example) != example_json:
        fail("defaults: prove_wide_fibonacci with no device differs from "
             "phase 6's proof")
    rng = np.random.default_rng(0)
    a = rng.integers(0, P, size=1 << log_n).astype(np.uint64)
    b = rng.integers(0, P, size=1 << log_n).astype(np.uint64)
    host = [a, b]
    for _ in range(2, seq):
        a, b = b, (a * a + b * b) % P
        host.append(b)
    host_columns = [to_torch_u32(c.astype(np.uint32)) for c in host]
    card_columns = generate_trace(log_n, seq, seed=0)
    if any(c.device.type != "cpu" for c in host_columns) or \
            any(c.device != cuda0 for c in card_columns):
        fail("defaults: the two traces are not on the CPU and the card")
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        checkpoint = str(Path(tmp) / "trace_commit.npz")
        for label, columns, path in (("host trace", host_columns, None),
                                     ("card trace", card_columns, None),
                                     ("checkpoint", card_columns,
                                      checkpoint)):
            (proof, comp, cfg), launches = counted(
                lambda: recipe_prove(columns, log_n, seq, path))
            if proof_json(proof) != example_json:
                fail(f"defaults: the recipe's proof ({label}) differs from "
                     "prove_wide_fibonacci's")
            verify_wide_fibonacci(proof, comp, cfg, log_n)
            if launches != example_launches:
                fail(f"defaults: the recipe ({label}) launched {launches}, "
                     f"the example {example_launches}")
    counts = {k: example_launches[k] for k in MAIN_PATH_KERNELS}
    if min(counts.values()) <= 0:
        fail(f"defaults: a main-path kernel was not launched: {counts}")
    phase(f"defaults recipe {log_n}x{seq}", time.perf_counter() - t0,
          f"README recipe at 2^{log_n} x {seq}, no device named: proofs from "
          f"a host trace, a card trace and a checkpoint resumed on cuda:0 == "
          f"prove_wide_fibonacci({log_n}, {seq}) (no device) == phase 6, "
          f"byte for byte, all verified; launches of each == the "
          f"example's {json.dumps(counts, sort_keys=True)}")

    t0 = time.perf_counter()
    (proof, cfg, claimed), logup_launches = counted(lambda: logup_recipe(12))
    twin = prove_logup_lookup(12, seed=0, device="cuda")[0]
    if proof_json(proof) != proof_json(twin):
        fail("defaults: the LogUp prove with no device differs from "
             "device=\"cuda\"")
    verify_logup_lookup(proof, cfg, 12, claimed)
    logup_counts = {k: logup_launches[k] for k in MAIN_PATH_KERNELS}
    if min(logup_counts.values()) <= 0:
        fail(f"defaults: the LogUp prove left a kernel out: {logup_counts}")
    values = np.random.default_rng(3).integers(0, P, size=(4, 1 << 12),
                                               dtype=np.uint32)
    layer = Layer(GRAND_PRODUCT, data=Mle(values))
    if layer.data.evals.device != cuda0:
        fail(f"defaults: Mle(numpy) chose {layer.data.evals.device}")
    (gkr, _), gkr_launches = counted(
        lambda: prove_batch(Blake2sChannel(), [layer]))
    gkr_twin, _ = prove_batch(Blake2sChannel(), [Layer(
        GRAND_PRODUCT, data=Mle(to_torch_u32(values, "cuda")))])
    if flat_gkr_proof(gkr) != flat_gkr_proof(gkr_twin):
        fail("defaults: the GKR proof with no device differs from "
             "device=\"cuda\"")
    if gkr_launches["deinterleave"] <= 0:
        fail("defaults: the GKR batch launched no deinterleave")
    phase("defaults logup gkr", time.perf_counter() - t0,
          "LogUp 2^12 from LogupTraceGenerator(12), Seq(12).gen_column() "
          "with no device == prove_logup_lookup(12, device=\"cuda\"), "
          f"verified, launches {json.dumps(logup_counts, sort_keys=True)}; "
          "GKR GrandProduct 2^12 from Mle(numpy) == Mle(to_torch_u32(.., "
          f"\"cuda\")), deinterleave launches {gkr_launches['deinterleave']}")


def grind_rates(device) -> None:
    """Phase 7: `grind` on the card against `grind_host` on this machine's
    host, from the channel after mix_u64(pow_bits), at pow_bits 12, 16, 20
    (the same nonce; host us a nonce) and 26 (the card alone: ~2^26 host
    hashes would take minutes, so the host's time there is its rate at 20
    times the nonces)."""
    from tstwo_tpu_torch.channel.blake2s import Blake2sChannel
    from tstwo_tpu_torch.proof_of_work import grind, grind_host

    t0 = time.perf_counter()
    host_us = None
    for pow_bits in (12, 16, 20, 26):
        ch = Blake2sChannel()
        ch.mix_u64(pow_bits)
        grind(ch, pow_bits, device=device)  # warm
        walls = []
        for _ in range(3):
            nonce, wall = timed(lambda: grind(ch, pow_bits, device=device))
            walls.append(wall)
        if pow_bits <= 20:
            t1 = time.perf_counter()
            want = grind_host(ch, pow_bits)
            host_s = time.perf_counter() - t1
            host_us = host_s / (want + 1) * 1e6
            if nonce != want:
                fail(f"grind at pow_bits {pow_bits}: card {nonce}, host {want}")
            host = (f"host {host_s * 1e3:.3f} ms ({host_us:.3f} us a "
                    "nonce), the same nonce")
        else:
            host = (f"host not run: ~{host_us * (nonce + 1) / 1e6:.1f} s at "
                    "its pow_bits-20 rate")
        print(f"  grind pow_bits {pow_bits}: nonce {nonce}; card "
              f"{min(walls) * 1e3:.3f} ms (best of 3, synchronised; "
              f"{', '.join(f'{w * 1e3:.3f}' for w in walls)}); {host}",
              flush=True)
    phase("grind", time.perf_counter() - t0,
          "grind on the card == grind_host at pow_bits 12, 16, 20")


def secure_prove(device) -> dict:
    """Phase 8: wide Fibonacci 2^18 x 64 under stwo-cairo's
    secure_pcs_config (pow_bits 26, log blowup 1, 70 queries: 96 bits):
    two proves, a third under synchronised spans (the grind span beside
    the others), the port's verifier, and the nonce held against the plain
    grind scanned on the card over [0, nonce].  Returns the launch counts
    of the proves."""
    import torch

    from tstwo_tpu_torch import kernels, tracing
    from tstwo_tpu_torch.examples.wide_fibonacci import (
        prove_wide_fibonacci, verify_wide_fibonacci)
    from tstwo_tpu_torch.fri import FriConfig
    from tstwo_tpu_torch.ops.blake2s import (digest_bytes_to_words,
                                             grind_batch_plain)
    from tstwo_tpu_torch.pcs import PcsConfig
    from tstwo_tpu_torch.pcs import prover as pcs_prover

    config = PcsConfig(SECURE_POW_BITS, FriConfig(0, 1, SECURE_QUERIES))
    grinds = []  # (digest words, nonce) of every grind of the proves
    grind = pcs_prover.grind

    def recorded(channel, pow_bits, **kw):
        nonce = grind(channel, pow_bits, **kw)
        grinds.append((digest_bytes_to_words(channel.digest), nonce))
        return nonce

    def prove():
        return prove_wide_fibonacci(18, 64, config, seed=0, device=device)

    pcs_prover.grind = recorded
    try:
        kernels.reset_launches()
        walls = []
        for _ in range(2):
            torch.cuda.reset_peak_memory_stats(device)
            (proof, comp, cfg), wall = timed(prove)
            walls.append(wall)
        peak = torch.cuda.max_memory_allocated(device)
        tracing.reset()
        tracing.enable()
        try:
            _, spans_wall = timed(prove)
        finally:
            tracing.disable()
    finally:
        pcs_prover.grind = grind
    launches = launch_counts("wide_fibonacci secure",
                             MAIN_PATH_KERNELS + ("blake2s_grind",))
    spans = tracing.totals()
    _, verify_s = timed(lambda: verify_wide_fibonacci(proof, comp, cfg, 18))
    nonce = proof.commitment_scheme_proof.proof_of_work
    if len({(tuple(w), n) for w, n in grinds}) != 1 or grinds[0][1] != nonce:
        fail(f"secure proves ground {grinds}, proof nonce {nonce}")
    # the plain version on the card, in chunks, from nonce 0 up
    t0, words, found, start = time.perf_counter(), grinds[0][0], -1, 0
    while found < 0 and start <= nonce:
        count = min(1 << 22, nonce + 1 - start)
        found = grind_batch_plain(words, start, count, SECURE_POW_BITS,
                                  device)
        start += count
    scan_s = time.perf_counter() - t0
    if found != nonce:
        fail(f"secure prove nonce {nonce}; the plain scan found {found}")
    grind_s = spans.get("grind", 0.0)
    phase(f"prove 18x64 secure", walls[1],
          f"pow_bits {SECURE_POW_BITS}, {SECURE_QUERIES} queries: two proves "
          f"{walls[0]:.3f} s, {walls[1]:.3f} s; under spans {spans_wall:.3f}"
          f" s, grind span {grind_s * 1e3:.3f} ms "
          f"({100 * grind_s / spans_wall:.2f}% of it); nonce {nonce} == "
          f"plain scan on the card ({scan_s:.2f} s); verified in "
          f"{verify_s:.3f} s; peak device memory {peak / 2**30:.3f} GiB; "
          f"proof {proof.size_estimate()} bytes")
    print("  spans (ms): " + json.dumps(
        {k: round(v * 1e3, 3) for k, v in sorted(spans.items(),
                                                 key=lambda kv: -kv[1])}),
          flush=True)
    return launches


class _Offsets:
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


def constraint_eval_phase(device, rows: list, log_n: int = 20,
                          columns: int = 100, config=None) -> dict:
    """Phase 8b: constraint programs (constraint_framework/program.py) on
    the card.  `constraint_eval` against the plain executor, bit for bit:
    wide Fibonacci 2^21 x 100 (each rows-per-thread variant, timed), the
    LogUp AIR at 2^21 in both `pairs` modes (offset -1 masks, secure
    parameters, a claimed sum), an AIR of masks at -1, 1, 2 and tile edges
    at 2^2-2^9; the wide Fibonacci row of the kernel table beside
    the eager DomainEvaluator's time.  Then wide Fibonacci 2^20 x 100 at 96
    bits, proved twice: the warm prove launches `constraint_eval` once,
    lowers nothing, runs no DomainEvaluator, and its composition
    accumulation equals the eager DomainEvaluator's on the same card
    columns.  Returns the launch counts of the proves.  (`log_n`,
    `columns`, `config`: the prove's trace, and of the wide Fibonacci row
    log_n + 1; smaller only to rehearse the phase off the card.)"""
    import numpy as np
    import torch

    from tstwo_tpu_torch import constraint_framework as cf
    from tstwo_tpu_torch import kernels, tracing
    from tstwo_tpu_torch.constraint_framework.logup import LookupElements
    from tstwo_tpu_torch.constraint_framework.program import lower
    from tstwo_tpu_torch.constraints import \
        coset_vanishing_denominator_inverses_bitrev
    from tstwo_tpu_torch.examples.logup_lookup import LookupEval
    from tstwo_tpu_torch.examples.wide_fibonacci import (
        WideFibonacciEval, prove_wide_fibonacci, verify_wide_fibonacci)
    from tstwo_tpu_torch.fields import M31, QM31
    from tstwo_tpu_torch.fri import FriConfig
    from tstwo_tpu_torch.measure_roofline import time_call, time_ms
    from tstwo_tpu_torch.ops import constraint_eval as ce
    from tstwo_tpu_torch.ops import m31
    from tstwo_tpu_torch.pcs import PcsConfig
    from tstwo_tpu_torch.utils import to_torch_u32

    rng = np.random.default_rng(18)

    def qm31s(k):
        return [QM31.from_ints([int(v) for v in rng.integers(0, P, 4)])
                for _ in range(k)]

    def setup(ev, t, e, params=(), claimed=None):
        """The program, random card columns, its scalars, an accumulator."""
        program = lower(ev, t, e)
        counts = list(program.columns) + [0] * (2 - len(program.columns))
        stacks = [to_torch_u32(rng.integers(0, P, (c, 1 << e), dtype=np.int64)
                               .astype(np.uint32), device) if c else None
                  for c in counts]
        shift = (claimed or QM31.zero()).mul_m31(
            M31.from_int(1 << t).inverse())
        scalars = to_torch_u32(program.scalars(
            qm31s(program.n_constraints), list(params), shift).view(np.uint32),
            device)
        code = program.device_code(device)
        return program, code, stacks, scalars

    def run(program, code, stacks, scalars, acc, rows_per_thread=0):
        ce.evaluate_cuda(code, program.device_loads(device),
                         program.n_slots, stacks, scalars,
                         program.denom_off, program.trace_log,
                         program.eval_log, acc, rows_per_thread)
        return acc

    def plain(program, code, stacks, scalars):
        return ce.evaluate_plain(code, program.n_slots, stacks, scalars,
                                 program.denom_off, program.trace_log,
                                 program.eval_log)

    def exact(name, program, code, stacks, scalars, rows_per_thread=0):
        acc = torch.zeros((4, 1 << program.eval_log), dtype=torch.int32,
                          device=device)
        got = run(program, code, stacks, scalars, acc, rows_per_thread)
        err = max_abs_err(got, plain(program, code, stacks, scalars))
        if err:
            fail(f"constraint_eval {name} differs from the plain executor "
                 f"(max_abs_err {err})")
        return acc

    t0 = time.perf_counter()
    n_checks = 0
    # tile edges and the same-domain offsets
    for log in (2, 5, 9):
        exact(f"offsets 2^{log}", *setup(_Offsets(log - 1), log - 1, log))
        exact(f"wide_fib 2^{log}", *setup(WideFibonacciEval(log - 1, 6),
                                          log - 1, log))
        n_checks += 2
    # LogUp: offset -1 masks, secure parameters, a claimed sum
    for pairs in (True, False):
        z, alpha = qm31s(2)
        ev = LookupEval(log_n, LookupElements(z, alpha, 1), pairs)
        info = cf.InfoEvaluator(log_n)
        ev.evaluate(info)
        args = setup(ev, log_n, log_n + 1, info.secure_params, qm31s(1)[0])
        exact(f"logup pairs={pairs}", *args)
        acc = torch.zeros((4, 2 << log_n), dtype=torch.int32, device=device)
        timing = time_call(lambda: run(*args, acc))
        print(f"  constraint_eval logup 2^{log_n + 1} pairs={pairs}: "
              f"{args[0].n_constraints} constraints, {len(args[0].code)} "
              f"instructions, {args[0].n_slots} slots, "
              f"{timing['ms']:.4f} ms (cold {timing['cold_ms']:.4f} ms)",
              flush=True)
        n_checks += 1
    # wide Fibonacci 2^21 x 100: each rows-per-thread variant
    ev = WideFibonacciEval(log_n, columns)
    program, code, stacks, scalars = args = setup(ev, log_n, log_n + 1)
    variants = {}
    for rpt in (1, 2, 4, 8):
        exact(f"wide_fib rows_per_thread={rpt}", *args, rows_per_thread=rpt)
        acc = torch.zeros((4, 2 << log_n), dtype=torch.int32, device=device)
        variants[rpt] = time_ms(lambda: run(*args, acc, rpt))
        n_checks += 1
    print(f"  constraint_eval wide_fib 2^{log_n + 1} x {columns} ms by rows "
          f"per thread: {json.dumps(variants)}", flush=True)
    acc = torch.zeros((4, 2 << log_n), dtype=torch.int32, device=device)
    timing = time_call(lambda: run(*args, acc))
    plain_ms = time_ms(lambda: plain(*args))
    # the eager path this replaces, on the same card columns
    coeffs = scalars[:program.param_off].view(-1, 4)
    dinv = to_torch_u32(coset_vanishing_denominator_inverses_bitrev(
        log_n, log_n + 1), device)

    def eager():
        dom = cf.DomainEvaluator([[], [c for c in stacks[1]]], log_n,
                                 log_n + 1, coeffs,
                                 scalars[program.shift_off:
                                         program.shift_off + 4], None)
        ev.evaluate(dom)
        return m31.mul(dom.row_res.arr, dinv[None, :])

    acc.zero_()
    if max_abs_err(run(*args, acc), eager()):
        fail(f"constraint_eval wide_fib 2^{log_n + 1} x {columns} differs "
             f"from the eager DomainEvaluator")
    eager_ms = time_ms(eager)
    n_ops = program.ops_per_row() << (log_n + 1)
    n_bytes = (4 * columns + 2 * 16) << (log_n + 1)
    by_ops, by_bytes = n_ops / INT32_OPS_PER_S * 1e3, \
        n_bytes / HBM_BYTES_PER_S * 1e3
    bound_ms = max(by_ops, by_bytes)
    shape = f"[{columns},2^{log_n + 1}] wide_fib"
    rows.append({"name": "constraint_eval", "shape": shape,
                 "route": "cuda", "source": CSRC + "constraint_eval.cu",
                 "replaces": REPLACES["constraint_eval"], "max_abs_err": 0,
                 "ms": timing["ms"], "cold_ms": timing["cold_ms"],
                 "host_us": timing["host_us"], "plain_ms": plain_ms,
                 "bound_ms": bound_ms,
                 "bound_by": "bytes" if by_bytes >= by_ops else "operations",
                 "library_ms": None, "library_host_us": None,
                 "eager_ms": eager_ms, "ops_per_row": program.ops_per_row(),
                 "instructions": len(program.code), "slots": program.n_slots,
                 "rows_per_thread_ms": variants})
    phase(f"kernel constraint_eval {shape}",
          time.perf_counter() - t0,
          f"{n_checks + 1} checks exact against the plain executor and the "
          f"eager DomainEvaluator; kernel {timing['ms']:.4f} ms (cold "
          f"{timing['cold_ms']:.4f} ms, host {timing['host_us']:.1f} us), "
          f"plain {plain_ms:.4f} ms, eager DomainEvaluator {eager_ms:.4f} ms,"
          f" bound {bound_ms:.4f} ms ({program.ops_per_row()} operations a "
          f"row; {100 * bound_ms / timing['ms']:.1f}% of it); "
          f"{len(program.code)} instructions, {program.n_slots} slots")
    del stacks, args, acc

    # the 96-bit prove: one launch a proof, its accumulation == the eager
    t0 = time.perf_counter()
    config = config or PcsConfig(SECURE_POW_BITS,
                                 FriConfig(0, 1, SECURE_QUERIES))
    seen = []
    evaluate = ce.evaluate
    dom_init = cf.DomainEvaluator.__init__

    def recorded(code, loads, n_slots, stacks, scalars, denom_off, t, e, acc):
        before = acc.clone()
        out = evaluate(code, loads, n_slots, stacks, scalars, denom_off, t,
                       e, acc)
        seen.append((stacks, scalars, before, out.clone()))
        return out

    def no_eager(self, trace_evals, *a, **kw):
        if any(c.is_cuda for tree in trace_evals for c in tree):
            fail("the prove ran a DomainEvaluator on CUDA columns")
        dom_init(self, trace_evals, *a, **kw)

    ce.evaluate, cf.DomainEvaluator.__init__ = recorded, no_eager
    try:
        prove_wide_fibonacci(log_n, columns, config, seed=1, device=device)
        seen.clear()
        kernels.reset_launches()
        tracing.reset()
        tracing.enable(sync=False)
        try:
            with tracing.request(0):
                (proof, comp, cfg), wall = timed(lambda: prove_wide_fibonacci(
                    log_n, columns, config, seed=2, device=device))
        finally:
            tracing.disable()
        launches = dict(kernels.LAUNCHES)
        counters = tracing.counts().get(0, {})
        tracing.reset()
        tracing.enable()
        try:
            _, spans_wall = timed(lambda: prove_wide_fibonacci(
                log_n, columns, config, seed=3, device=device))
        finally:
            tracing.disable()
    finally:
        ce.evaluate, cf.DomainEvaluator.__init__ = evaluate, dom_init
    spans = tracing.totals()
    tracing.reset()
    if launches["constraint_eval"] != 1 or len(seen) != 2:
        fail(f"the warm 2^{log_n} x {columns} prove launched constraint_eval "
             f"{launches['constraint_eval']} times ({len(seen)} calls seen)")
    if counters.get("constraint_programs_built", 0) != 0 or \
            counters.get("constraints_fused") != columns - 2:
        fail(f"the warm prove's counters: {counters}")
    stacks, scalars, before, after = seen[0]
    k = comp.n_constraints()
    dom = cf.DomainEvaluator([[], [c for c in stacks[1]]], log_n, log_n + 1,
                             scalars[:4 * k].view(-1, 4),
                             scalars[4 * k:4 * k + 4], None)
    comp.eval.evaluate(dom)
    want = m31.add(before, m31.mul(dom.row_res.arr, dinv[None, :]))
    if max_abs_err(after, want):
        fail(f"the 2^{log_n} x {columns} prove's composition accumulation "
             f"differs from the eager DomainEvaluator on the same columns")
    verify_wide_fibonacci(proof, comp, cfg, log_n)
    phase(f"constraint_eval prove {log_n}x{columns} secure", wall,
          f"warm prove {wall:.3f} s: constraint_eval launched once, "
          f"constraints_fused {counters.get('constraints_fused')}, "
          f"constraint_programs_built "
          f"{counters.get('constraint_programs_built', 0)}, no "
          f"DomainEvaluator on the card; its accumulation == the eager "
          f"DomainEvaluator on the same columns; verified; under synced "
          f"spans {spans_wall:.3f} s, composition "
          f"{1e3 * spans.get('composition', 0.0):.3f} ms; "
          f"{time.perf_counter() - t0:.1f} s in all")
    print("  spans (ms): " + json.dumps(
        {k: round(v * 1e3, 3) for k, v in sorted(spans.items(),
                                                 key=lambda kv: -kv[1])}),
          flush=True)
    return launches


def poseidon2_phase(device, rows: list, log_n: int = 17,
                    config=None) -> dict:
    """Phase 8c: the Poseidon2 AIR (examples/poseidon2.py).  Its constraint
    program (19,899 instructions, more than a block's shared memory holds)
    and wide Fibonacci's (493) through `constraint_eval`, each bit for bit
    against the plain executor and timed warm and cold as phase 8b times
    them: Poseidon2 at 2^(log_n + 2) x 1264 (+ 32 interaction columns),
    bound by the operations its equations need (the benchmark reference's
    `constraint_ops`, the port's instruction count beside it), wide
    Fibonacci at 2^21 x 100, bound by the port's count as in phase 8b.
    Then a 2^log_n-row prove at 96 bits, three times: the warm prove,
    with the launch counts reset just before it, launches `constraint_eval`
    once and every kernel of the main path and the grind, runs no
    DomainEvaluator on the card, fuses 1144 constraints, and verifies.
    The Poseidon2 row's `launches` are that prove's; returns its launch
    counts."""
    import numpy as np
    import torch

    from tstwo_tpu_torch import constraint_framework as cf
    from tstwo_tpu_torch import kernels, tracing
    from tstwo_tpu_torch.constraint_framework.logup import LookupElements
    from tstwo_tpu_torch.constraint_framework.program import lower
    from tstwo_tpu_torch.examples.poseidon2 import (
        N_STATE, Poseidon2Eval, prove_poseidon2, verify_poseidon2)
    from tstwo_tpu_torch.examples.wide_fibonacci import WideFibonacciEval
    from tstwo_tpu_torch.fields import M31, QM31
    from tstwo_tpu_torch.fri import FriConfig
    from tstwo_tpu_torch.measure_roofline import time_call
    from tstwo_tpu_torch.ops import constraint_eval as ce
    from tstwo_tpu_torch.pcs import PcsConfig
    from tstwo_tpu_torch.utils import to_torch_u32

    sys.path.insert(0, str(ROOT))
    from stark_bench.reference.poseidon2 import constraint_ops

    rng = np.random.default_rng(19)

    def qm31s(k):
        return [QM31.from_ints([int(v) for v in rng.integers(0, P, 4)])
                for _ in range(k)]

    def program_row(name, ev, t, e, columns_bytes, equation_ops=None):
        """The kernel-table row of `ev`'s program; its bound counts
        `equation_ops` operations where given, else the program's."""
        t0 = time.perf_counter()
        info = cf.InfoEvaluator(t)
        ev.evaluate(info)
        program = lower(ev, t, e)
        stacks = [to_torch_u32(rng.integers(0, P, (c, 1 << e), dtype=np.int64)
                               .astype(np.uint32), device) if c else None
                  for c in program.columns]
        shift = qm31s(1)[0].mul_m31(M31.from_int(1 << t).inverse())
        scalars = to_torch_u32(program.scalars(
            qm31s(program.n_constraints), info.secure_params, shift
        ).view(np.uint32), device)
        code, loads = program.device_code(device), program.device_loads(device)
        acc = torch.zeros((4, 1 << e), dtype=torch.int32, device=device)

        def run():
            ce.evaluate_cuda(code, loads, program.n_slots, stacks, scalars,
                             program.denom_off, t, e, acc)

        run()
        want = ce.evaluate_plain(code, program.n_slots, stacks, scalars,
                                 program.denom_off, t, e)
        err = max_abs_err(acc, want)
        if err:
            fail(f"constraint_eval {name} differs from the plain executor "
                 f"(max_abs_err {err})")
        del want
        timing = time_call(run)
        rows_pt, chunk = ce.launch_shape(len(program.code),
                                         program.count(ce.LOAD),
                                         scalars.numel(), program.n_slots)
        n_ops = (program.ops_per_row() << e if equation_ops is None
                 else equation_ops)
        n_bytes = (columns_bytes + 2 * 16) << e
        by_ops = n_ops / INT32_OPS_PER_S * 1e3
        by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
        bound_ms = max(by_ops, by_bytes)
        shape = f"[{sum(program.columns)},2^{e}] {name}"
        row = {"name": "constraint_eval", "shape": shape,
                     "route": "cuda", "source": CSRC + "constraint_eval.cu",
                     "replaces": REPLACES["constraint_eval"],
                     "max_abs_err": 0, "ms": timing["ms"],
                     "cold_ms": timing["cold_ms"],
                     "host_us": timing["host_us"], "bound_ms": bound_ms,
                     "bound_by": ("bytes" if by_bytes >= by_ops
                                  else "operations"),
                     "library_ms": None, "library_host_us": None,
                     "ops_per_row": n_ops >> e,
                     "program_ops_per_row": program.ops_per_row(),
                     "instructions": len(program.code),
                     "loads": int(program.count(ce.LOAD)),
                     "slots": program.n_slots, "rows_per_thread": rows_pt,
                     "chunk": chunk}
        rows.append(row)
        source = "the program's" if equation_ops is None else (
            f"the equations'; the program's {program.ops_per_row()}")
        phase(f"kernel constraint_eval {shape}", time.perf_counter() - t0,
              f"exact against the plain executor; kernel "
              f"{timing['ms']:.4f} ms (cold {timing['cold_ms']:.4f} ms, host "
              f"{timing['host_us']:.1f} us), bound {bound_ms:.4f} ms "
              f"({n_ops >> e} operations a row, {source}; "
              f"{100 * bound_ms / timing['ms']:.1f}% of it); "
              f"{len(program.code)} instructions, "
              f"{program.count(ce.LOAD)} loads, {program.n_slots} slots, "
              f"{rows_pt} rows a thread, {chunk} instructions a chunk")
        del stacks, acc
        return row

    p2_row = program_row("poseidon2", Poseidon2Eval(
        log_n, LookupElements(*qm31s(2), N_STATE)), log_n, log_n + 2,
        4 * (1264 + 32), constraint_ops({}, log_n))
    program_row("wide_fib", WideFibonacciEval(20, 100), 20, 21, 4 * 100)

    # the 96-bit prove: one launch a proof, no eager evaluator, verified
    t0 = time.perf_counter()
    config = config or PcsConfig(SECURE_POW_BITS,
                                 FriConfig(0, 1, SECURE_QUERIES))
    dom_init = cf.DomainEvaluator.__init__

    def no_eager(self, trace_evals, *a, **kw):
        if any(c.is_cuda for tree in trace_evals for c in tree):
            fail("the Poseidon2 prove ran a DomainEvaluator on CUDA columns")
        dom_init(self, trace_evals, *a, **kw)

    cf.DomainEvaluator.__init__ = no_eager
    try:
        prove_poseidon2(log_n, config, seed=1, device=device)
        kernels.reset_launches()
        tracing.reset()
        tracing.enable(sync=False)
        try:
            with tracing.request(0):
                (proof, cfg, claimed), wall = timed(lambda: prove_poseidon2(
                    log_n, config, seed=2, device=device))
        finally:
            tracing.disable()
        launches = launch_counts(f"poseidon2 {log_n} secure",
                                 MAIN_PATH_KERNELS + ("blake2s_grind",))
        counters = tracing.counts().get(0, {})
        tracing.reset()
        tracing.enable()
        try:
            _, spans_wall = timed(lambda: prove_poseidon2(
                log_n, config, seed=3, device=device))
        finally:
            tracing.disable()
    finally:
        cf.DomainEvaluator.__init__ = dom_init
    spans = tracing.totals()
    tracing.reset()
    if launches["constraint_eval"] != 1:
        fail(f"the warm Poseidon2 2^{log_n} prove launched constraint_eval "
             f"{launches['constraint_eval']} times")
    p2_row["launches"] = launches["constraint_eval"]
    if counters.get("constraints_fused") != 1144 or \
            counters.get("constraint_programs_built", 0) != 0 or \
            counters.get("logup_columns") != 8 or \
            counters.get("logup_fractions") != 16 << log_n:
        fail(f"the warm Poseidon2 prove's counters: {counters}")
    verify_poseidon2(proof, cfg, log_n, claimed)
    phase(f"poseidon2 prove {log_n} secure", wall,
          f"warm prove {wall:.3f} s: constraint_eval launched once, "
          f"counters {json.dumps(counters)}, no DomainEvaluator on the "
          f"card; verified (claimed sum {claimed}); under synced spans "
          f"{spans_wall:.3f} s, composition "
          f"{1e3 * spans.get('composition', 0.0):.3f} ms, interaction "
          f"{1e3 * spans.get('interaction_trace', 0.0):.3f} ms; "
          f"{time.perf_counter() - t0:.1f} s in all")
    print("  spans (ms): " + json.dumps(
        {k: round(v * 1e3, 3) for k, v in sorted(spans.items(),
                                                 key=lambda kv: -kv[1])}),
          flush=True)
    return launches


# the quotient groups of the benchmark's cells: (columns, log size,
# columns also sampled at z - g).  wf100_b2s.2e20: the 100 trace columns at
# 2^21, the composition's 4 at 2^22; p2_b2s.2e17: 1264 trace and 32
# interaction columns at 2^18, the last 4 also at z - g, the composition's
# 4 at 2^20.
QUOTIENT_GROUPS = ((100, 21, 0), (4, 22, 0), (1296, 18, 4), (4, 20, 0))


def quotients_phase(device, rows: list, config=None) -> dict:
    """Phase 8d: the DEEP quotients (csrc/quotients.cu).  The kernel at
    each group of QUOTIENT_GROUPS against the plain version
    (`_accumulate_rows`, on the card) bit for bit, timed warm and cold
    behind the spin kernel beside its bound (each column value read once,
    the [4, n] result written once) and the plain version's time.  Then
    one 96-bit prove of each cell's recipe, wide Fibonacci 2^20 x 100 and
    Poseidon2 2^17, warm, under the span tree: one launch a group (2 a
    proof) and `quotient_columns` the committed columns (104 and 1300);
    the synchronised `fri_quotients` span of a third prove.  Returns the
    launch counts of the Poseidon2 prove."""
    import numpy as np
    import torch

    from tstwo_tpu_torch import kernels, tracing
    from tstwo_tpu_torch.channel.blake2s import Blake2sChannel
    from tstwo_tpu_torch.circle import CanonicCoset, CirclePoint
    from tstwo_tpu_torch.examples.poseidon2 import prove_poseidon2
    from tstwo_tpu_torch.examples.wide_fibonacci import prove_wide_fibonacci
    from tstwo_tpu_torch.fields import QM31
    from tstwo_tpu_torch.fri import FriConfig
    from tstwo_tpu_torch.measure_roofline import time_call
    from tstwo_tpu_torch.pcs import PcsConfig
    from tstwo_tpu_torch.pcs import quotients as q

    rng = np.random.default_rng(20)
    gen = torch.Generator(device).manual_seed(20)

    def qm31():
        return QM31.from_ints([int(v) for v in rng.integers(0, P, 4)])

    for k, log, shifted in QUOTIENT_GROUPS:
        t0 = time.perf_counter()
        n = 1 << log
        cols = torch.randint(0, P, (k, n), dtype=torch.int32, device=device,
                             generator=gen)
        z = CirclePoint.get_random_point(Blake2sChannel())
        g = CanonicCoset.new(log - 1).step().into_ef(QM31.from_base)
        samples = [[q.PointSample(z, qm31())] for _ in range(k)]
        for col in samples[k - shifted:]:
            col.append(q.PointSample(z - g, qm31()))
        batches = q.ColumnSampleBatch.new_vec(samples)
        alpha = qm31()
        domain = CanonicCoset.new(log).circle_domain()
        columns = list(cols)

        def run():
            return q.accumulate_quotients_cuda(domain, columns, alpha, batches)

        xs, ys = q.domain_points_bitrev(domain, device)
        want, plain_s = timed(lambda: q._accumulate_rows(cols, xs, ys,
                                                         batches, alpha))
        err = max_abs_err(run(), want)
        if err:
            fail(f"accumulate_quotients [{k},2^{log}] differs from the plain "
                 f"version (max_abs_err {err})")
        del want, xs, ys
        # the kernel alone (its table uploaded once), then the whole call:
        # the constants packed on the host, the upload and the launch
        pack = q.pack_quotient_constants(batches, alpha)
        table = q._device_table(pack, [c.data_ptr() for c in columns], device)
        out = torch.empty((4, n), dtype=torch.int32, device=device)
        timing = time_call(lambda: q._launch(table, k, pack, domain, 0, out))
        call = time_call(run, cold=False)
        n_bytes = 4 * k * n + 16 * n
        bound_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        shape = f"[{k},2^{log}], {len(batches)} batch(es)"
        rows.append({"name": "accumulate_quotients", "shape": shape,
                     "route": "cuda", "source": CSRC + "quotients.cu",
                     "replaces": REPLACES["accumulate_quotients"],
                     "max_abs_err": 0, "ms": timing["ms"],
                     "cold_ms": timing["cold_ms"],
                     "host_us": call["host_us"], "call_ms": call["ms"],
                     "bound_ms": bound_ms,
                     "bound_by": "bytes", "plain_ms": plain_s * 1e3,
                     "library_ms": None, "library_host_us": None})
        phase(f"kernel accumulate_quotients {shape}",
              time.perf_counter() - t0,
              f"exact against the plain version; kernel {timing['ms']:.4f} "
              f"ms (cold {timing['cold_ms']:.4f} ms), bound {bound_ms:.4f} "
              f"ms ({n_bytes / 1e6:.1f} MB; "
              f"{100 * bound_ms / timing['ms']:.1f}% of it warm, "
              f"{100 * bound_ms / timing['cold_ms']:.1f}% cold); the whole "
              f"call {call['ms']:.4f} ms, host {call['host_us']:.1f} us; "
              f"plain {plain_s * 1e3:.1f} ms")
        del cols, columns

    config = config or PcsConfig(SECURE_POW_BITS,
                                 FriConfig(0, 1, SECURE_QUERIES))
    recipes = (("wide_fibonacci 20x100", 104, lambda seed:
                prove_wide_fibonacci(20, 100, config, seed=seed,
                                     device=device)),
               ("poseidon2 17", 1300, lambda seed:
                prove_poseidon2(17, config, seed=seed, device=device)))
    for name, n_cols, prove in recipes:
        t0 = time.perf_counter()
        prove(1)
        kernels.reset_launches()
        tracing.reset()
        tracing.enable(sync=False)
        try:
            with tracing.request(0):
                _, wall = timed(lambda: prove(2))
        finally:
            tracing.disable()
        launches = launch_counts(f"quotients {name} secure",
                                 MAIN_PATH_KERNELS + ("blake2s_grind",))
        columns = tracing.counts().get(0, {}).get("quotient_columns")
        tracing.reset()
        tracing.enable()
        try:
            timed(lambda: prove(3))
        finally:
            tracing.disable()
        span_ms = 1e3 * tracing.totals().get("fri_quotients", 0.0)
        tracing.reset()
        if launches["accumulate_quotients"] != 2 or columns != n_cols:
            fail(f"the warm {name} prove launched accumulate_quotients "
                 f"{launches['accumulate_quotients']} times over {columns} "
                 f"columns (2 and {n_cols} expected)")
        phase(f"quotients prove {name} secure", wall,
              f"warm prove {wall:.3f} s: accumulate_quotients launched "
              f"twice, quotient_columns {columns}; synced fri_quotients "
              f"{span_ms:.3f} ms; {time.perf_counter() - t0:.1f} s in all")
    for row in rows:
        if row["name"] == "accumulate_quotients":
            row["launches"] = launches["accumulate_quotients"]
    return launches


def roofline(device) -> dict:
    """Phase 9: tstwo_tpu_torch.measure_roofline on the card, one figure a
    line; returns the launch counts of that path."""
    from tstwo_tpu_torch import kernels
    from tstwo_tpu_torch.measure_roofline import measure

    t0 = time.perf_counter()
    kernels.reset_launches()
    figures = measure(device)
    launches = launch_counts("roofline", ("m31_mul", "m31_mul_chain"))
    for key, value in figures.items():
        print(f"  roofline {key}: {value}", flush=True)
    if not figures["m31_mul_chain_parity"]:
        fail("m31_mul_chain differs from its plain version at 2^24")
    phase("roofline", time.perf_counter() - t0,
          f"m31 mul kernel {figures['m31_mul_kernel_per_s']:.4e}/s, "
          f"mul_chain kernel {figures['m31_mul_chain_kernel_per_s']:.4e}/s, "
          f"stream {figures['stream_gb_per_s']:.1f} GB/s")
    return launches


def logup_phases(device) -> dict:
    """Phases 10-12: the LogUp lookup AIR (three trees, LogUp interaction
    trace).  Golden 2^8 proof, 2^12 CUDA == CPU for both `pairs` modes,
    then two proves each at 2^16 and 2^20 with the launches counted."""
    import torch

    from tstwo_tpu_torch import kernels
    from tstwo_tpu_torch.examples.logup_lookup import (prove_logup_lookup,
                                                       verify_logup_lookup)

    t0 = time.perf_counter()
    proof, cfg, claimed = prove_logup_lookup(8, seed=0, pairs=True,
                                             device=device)
    if proof_json(proof) != LOGUP_FIXTURE.read_text().strip():
        fail("LogUp log 8 CUDA proof differs from the JAX fixture")
    verify_logup_lookup(proof, cfg, 8, claimed, True)
    phase("logup golden", time.perf_counter() - t0,
          "log 8 seed 0 pairs proof == JAX fixture; verified")

    t0 = time.perf_counter()
    for pairs in (True, False):
        cuda_json = proof_json(prove_logup_lookup(12, seed=0, pairs=pairs,
                                                  device=device)[0])
        cpu_json = proof_json(prove_logup_lookup(12, seed=0, pairs=pairs,
                                                 device="cpu")[0])
        if cuda_json != cpu_json:
            fail(f"LogUp log 12 pairs={pairs} CUDA proof differs from CPU")
    phase("logup mid_size", time.perf_counter() - t0,
          "log 12 CUDA proofs == CPU plain proofs (pairs and single)")

    kernels.reset_launches()
    for log_n in (16, 20):
        walls = []
        for _ in range(2):
            torch.cuda.reset_peak_memory_stats(device)
            (proof, cfg, claimed), wall = timed(lambda: prove_logup_lookup(
                log_n, seed=0, device=device))
            walls.append(wall)
        peak = torch.cuda.max_memory_allocated(device)
        _, verify_s = timed(lambda: verify_logup_lookup(proof, cfg, log_n,
                                                        claimed))
        phase(f"logup prove {log_n}", walls[1],
              f"two proves {walls[0]:.3f} s, {walls[1]:.3f} s; verified in "
              f"{verify_s:.3f} s; peak device memory {peak / 2**30:.3f} GiB;"
              f" proof {proof.size_estimate()} bytes")
    return launch_counts("logup", MAIN_PATH_KERNELS,
                         forbidden=("blake2s_grind",))


GKR_KINDS = ("GrandProduct", "LogUpGeneric", "LogUpMultiplicities",
             "LogUpSingles")


def gkr_layer(kind: str, n_vars: int, seed: int, device):
    """A GKR input layer of `kind` over 2^n_vars points, from numpy (the
    same values on every device)."""
    import numpy as np

    from tstwo_tpu_torch.lookups.gkr import Layer
    from tstwo_tpu_torch.lookups.mle import BaseMle, Mle
    from tstwo_tpu_torch.utils import to_torch_u32

    rng = np.random.default_rng(seed)
    n = 1 << n_vars
    num = to_torch_u32(rng.integers(0, P, size=(4, n), dtype=np.uint32),
                       device)
    den = to_torch_u32(rng.integers(1, P, size=(4, n), dtype=np.uint32),
                       device)
    if kind == "GrandProduct":
        return Layer(kind, data=Mle(num))
    if kind == "LogUpGeneric":
        return Layer(kind, numerators=Mle(num), denominators=Mle(den))
    if kind == "LogUpMultiplicities":
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


def gkr_phases(device) -> dict:
    """Phases 13-14: GKR batch proofs.  2^12 CUDA == CPU for each layer
    kind, then a GrandProduct + LogUpGeneric batch at 2^20: two proves,
    the batch verifier, and its claims against the input MLEs."""
    import torch

    from tstwo_tpu_torch import kernels
    from tstwo_tpu_torch.channel.blake2s import Blake2sChannel
    from tstwo_tpu_torch.lookups.gkr import (GATE_GRAND_PRODUCT, GATE_LOGUP,
                                             partially_verify_batch,
                                             prove_batch)

    t0 = time.perf_counter()
    for i, kind in enumerate(GKR_KINDS):
        cuda_proof, _ = prove_batch(Blake2sChannel(),
                                    [gkr_layer(kind, 12, i, device)])
        cpu_proof, _ = prove_batch(Blake2sChannel(),
                                   [gkr_layer(kind, 12, i, "cpu")])
        if flat_gkr_proof(cuda_proof) != flat_gkr_proof(cpu_proof):
            fail(f"GKR {kind} 2^12 CUDA proof differs from the CPU proof")
    phase("gkr mid_size", time.perf_counter() - t0,
          "2^12 CUDA proofs == CPU plain proofs for all four layer kinds")

    log_n = 20
    layers = [gkr_layer("GrandProduct", log_n, 10, device),
              gkr_layer("LogUpGeneric", log_n, 11, device)]
    kernels.reset_launches()
    walls = []
    for _ in range(2):
        torch.cuda.reset_peak_memory_stats(device)
        (proof, artifact), wall = timed(
            lambda: prove_batch(Blake2sChannel(), layers))
        walls.append(wall)
    peak = torch.cuda.max_memory_allocated(device)
    art, verify_s = timed(lambda: partially_verify_batch(
        [GATE_GRAND_PRODUCT, GATE_LOGUP], proof, Blake2sChannel()))
    if art.ood_point != artifact.ood_point or \
            art.claims_to_verify_by_instance != \
            artifact.claims_to_verify_by_instance:
        fail("GKR 2^20 verifier artifact differs from the prover's")
    # the input MLEs at the OOD point, on the card and, as a witness apart
    # from the CUDA path, on CPU copies made from the same numpy values
    cpu_layers = [gkr_layer("GrandProduct", log_n, 10, "cpu"),
                  gkr_layer("LogUpGeneric", log_n, 11, "cpu")]
    for where, (gp, lg) in (("card", layers), ("CPU", cpu_layers)):
        if art.claims_to_verify_by_instance != [
                [gp.data.eval_at_point(art.ood_point)],
                [lg.numerators.eval_at_point(art.ood_point),
                 lg.denominators.eval_at_point(art.ood_point)]]:
            fail(f"GKR 2^20 claims differ from the input MLEs ({where}) at "
                 "the OOD point")
    phase(f"gkr prove 2^{log_n}", walls[1],
          f"GrandProduct + LogUpGeneric batch: two proves {walls[0]:.3f} s, "
          f"{walls[1]:.3f} s; verified in {verify_s:.3f} s; claims == input "
          "MLEs at the OOD point on the card and on the CPU; peak device "
          f"memory {peak / 2**30:.3f} GiB")
    return launch_counts("gkr", ("deinterleave",))


def poseidon_proof_fields(proof) -> dict:
    """A Poseidon252 proof in the layout of `proof_to_dict`, a felt252
    digest as 64 hex digits (the encoding of the committed fixture, which
    tests/test_torch_poseidon_prove.py writes from the JAX proof;
    `proof_to_dict` itself does not take felt digests)."""
    def digest(x):
        return f"{x.value:064x}"

    def decommitment(d):
        return {"hash_witness": [digest(h) for h in d.hash_witness],
                "column_witness": [m.value for m in d.column_witness]}

    def layer(l):
        return {"fri_witness": [list(v.to_ints()) for v in l.fri_witness],
                "decommitment": decommitment(l.decommitment),
                "commitment": digest(l.commitment)}

    p = proof.commitment_scheme_proof
    fri = p.config.fri_config
    return {
        "config": {"pow_bits": p.config.pow_bits, "fri_config": {
            "log_last_layer_degree_bound": fri.log_last_layer_degree_bound,
            "log_blowup_factor": fri.log_blowup_factor,
            "n_queries": fri.n_queries}},
        "commitments": [digest(c) for c in p.commitments],
        "sampled_values": [[[list(v.to_ints()) for v in col] for col in tree]
                           for tree in p.sampled_values],
        "decommitments": [decommitment(d) for d in p.decommitments],
        "queried_values": [[m.value for m in tree]
                           for tree in p.queried_values],
        "proof_of_work": p.proof_of_work,
        "fri_proof": {
            "first_layer": layer(p.fri_proof.first_layer),
            "inner_layers": [layer(l) for l in p.fri_proof.inner_layers],
            "last_layer_poly": [list(c.to_ints())
                                for c in p.fri_proof.last_layer_poly.coeffs]},
    }


POSEIDON_MID_LOG = 6  # the CPU-plain prove there takes about half a minute
# what a Poseidon252 prove must launch, and the Blake2s family it must not
POSEIDON_KERNELS = ("poseidon_merkle_layer", "cfft_forward", "cfft_inverse",
                    "deinterleave", "constraint_eval", "accumulate_quotients")
BLAKE2S_KERNELS = ("blake2s", "merkle_layer", "merkle_tail", "blake2s_grind",
                   "blake2s_transcript")


def poseidon_phases(device) -> dict:
    """Phases 15-17: the basic AIR under the Poseidon252 flavour.  Golden
    2^4 proof, 2^6 CUDA == CPU, then two proves each at 2^16 and 2^20 rows
    with the launches counted; every proof verified on the host, whose
    hash_node is Python-int Hades and shares nothing with the kernel.
    Returns the launch counts and the 2^16 and 2^20 proofs' fields JSON
    by log size (the mesh phase's references)."""
    import torch

    from tstwo_tpu_torch import kernels
    from tstwo_tpu_torch.examples.basic_air import (prove_basic_air,
                                                    verify_basic_air)

    def prove(log_n, where):
        return prove_basic_air(log_n, device=where, flavor="poseidon252")

    def fields_json(proof):
        return json.dumps(poseidon_proof_fields(proof), sort_keys=True)

    t0 = time.perf_counter()
    proof, comp, cfg = prove(4, device)
    if fields_json(proof) != POSEIDON_FIXTURE.read_text().strip():
        fail("Poseidon252 basic-AIR log 4 CUDA proof differs from the JAX "
             "fixture")
    verify_basic_air(proof, comp, cfg, 4, flavor="poseidon252")
    phase("poseidon golden", time.perf_counter() - t0,
          "basic AIR log 4 proof == JAX fixture, field by field; verified")

    t0 = time.perf_counter()
    proof, comp, cfg = prove(POSEIDON_MID_LOG, device)
    cuda_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    cpu_json = fields_json(prove(POSEIDON_MID_LOG, "cpu")[0])
    cpu_s = time.perf_counter() - t1
    if fields_json(proof) != cpu_json:
        fail(f"Poseidon252 log {POSEIDON_MID_LOG} CUDA proof differs from "
             "the CPU proof")
    verify_basic_air(proof, comp, cfg, POSEIDON_MID_LOG,
                     flavor="poseidon252")
    phase("poseidon mid_size", time.perf_counter() - t0,
          f"log {POSEIDON_MID_LOG} CUDA proof ({cuda_s:.3f} s) == CPU plain "
          f"proof ({cpu_s:.3f} s); verified")

    prove(16, device)  # fills the host-side caches of that size
    kernels.reset_launches()
    proofs = {}
    for log_n in (16, 20):
        walls = []
        for _ in range(2):
            torch.cuda.reset_peak_memory_stats(device)
            (proof, comp, cfg), wall = timed(lambda: prove(log_n, device))
            walls.append(wall)
        peak = torch.cuda.max_memory_allocated(device)
        t1 = time.perf_counter()
        verify_basic_air(proof, comp, cfg, log_n, flavor="poseidon252")
        phase(f"poseidon prove {log_n}", walls[1],
              f"two proves {walls[0]:.3f} s, {walls[1]:.3f} s; verified on "
              f"the host in {time.perf_counter() - t1:.3f} s; peak device "
              f"memory {peak / 2**30:.3f} GiB; proof "
              f"{proof.size_estimate()} bytes")
        proofs[log_n] = fields_json(proof)
    return launch_counts("poseidon", POSEIDON_KERNELS,
                         forbidden=BLAKE2S_KERNELS), proofs


def poseidon_sponge(device) -> dict:
    """Phase 18: `poseidon_hash_many` of 2^16 rows of three felts on the
    card (two Hades launches): every row against the same sponge around
    the plain permutation, rows 0-7 against the host's hash."""
    import numpy as np

    from tstwo_tpu_torch import kernels
    from tstwo_tpu_torch.channel.poseidon import poseidon_hash_many
    from tstwo_tpu_torch.ops import poseidon252 as pos
    from tstwo_tpu_torch.utils import to_torch_u32

    rng = np.random.default_rng(16)
    cols = []
    for _ in range(3):
        words = rng.integers(0, 1 << 32, size=(8, 1 << 16), dtype=np.uint64)
        words[7] &= (1 << 19) - 1
        cols.append(to_torch_u32(words.astype(np.uint32), device))
    kernels.reset_launches()
    digests, wall = timed(lambda: pos.poseidon_hash_many(cols))
    launches = launch_counts("poseidon sponge", ("hades_permutation",))
    rows = list(zip(*(pos.felts_to_ints(c[:, :8]) for c in cols)))
    if pos.felts_to_ints(digests[:, :8]) != [poseidon_hash_many(r)
                                             for r in rows]:
        fail("poseidon_hash_many on the card differs from the host's hash")
    plain = pos._sponge(cols, 1 << 16, device, pos.hades_permutation_plain)
    if max_abs_err(digests, plain):
        fail("poseidon_hash_many on the card differs from the plain sponge")
    phase("poseidon sponge", wall,
          "poseidon_hash_many of 2^16 rows of 3 felts == the sponge around "
          "the plain permutation (all rows) == host hash (rows 0-7)")
    return launches


# (flavour, backend, ranks, log_n, seq) of each group of the mesh phase:
# wide Fibonacci against phase 6's single-device proofs, the Poseidon252
# basic AIR (no seq) against phase 17's
MESH_GROUPS = (("blake2s", "nccl", 1, 18, 64), ("blake2s", "gloo", 2, 16, 32),
               ("blake2s", "gloo", 4, 18, 64),
               ("poseidon252", "nccl", 1, 20, None),
               ("poseidon252", "gloo", 2, 16, None),
               ("poseidon252", "gloo", 4, 20, None))
# per flavour: the kernels every rank must launch, and those it must not
MESH_KERNELS = {
    "blake2s": (("cfft_forward", "cfft_inverse", "merkle_layer",
                 "merkle_tail", "deinterleave", "blake2s_transcript",
                 "constraint_eval", "accumulate_quotients"), ()),
    "poseidon252": (POSEIDON_KERNELS, BLAKE2S_KERNELS)}
MESH_RANK_TIMEOUT_S = 300


def mesh_rank(argv) -> None:
    """One rank of the mesh phase (this script started with --mesh-rank):
    joins the group, proves twice (the first fills the per-process caches:
    the kernel library, twiddles, sharded-FFT plans) with the launch counts,
    leaf rows and collective traffic reset just before the second, writes
    that proof's JSON (its fields JSON for Poseidon252) and prints its
    report as one JSON line.  `--flavor poseidon252` proves the basic AIR
    of 2^log_n rows, the default wide Fibonacci 2^log_n x seq."""
    import argparse

    import torch

    ap = argparse.ArgumentParser()
    for name in ("--mesh-rank", "--size", "--log-n"):
        ap.add_argument(name, type=int, required=True)
    ap.add_argument("--seq", type=int)
    for name in ("--backend", "--store", "--out"):
        ap.add_argument(name, required=True)
    ap.add_argument("--flavor", default="blake2s",
                    choices=("blake2s", "poseidon252"))
    a = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from tstwo_tpu_torch import kernels
    from tstwo_tpu_torch.examples.basic_air import prove_basic_air
    from tstwo_tpu_torch.examples.wide_fibonacci import prove_wide_fibonacci
    from tstwo_tpu_torch.parallel import init_distributed, make_mesh

    def prove():
        if a.flavor == "poseidon252":
            return prove_basic_air(a.log_n, flavor="poseidon252", mesh=mesh)
        return prove_wide_fibonacci(a.log_n, a.seq, seed=0, mesh=mesh)

    init_distributed(a.backend, "file://" + a.store, a.mesh_rank, a.size)
    mesh = make_mesh()
    walls = []
    for _ in range(2):
        kernels.reset_launches()
        mesh.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        proof, _, _ = prove()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    Path(a.out).write_text(
        json.dumps(poseidon_proof_fields(proof), sort_keys=True)
        if a.flavor == "poseidon252" else proof_json(proof))
    print(json.dumps({"rank": mesh.rank, "device": str(mesh.device),
                      "walls": walls, "launches": dict(kernels.LAUNCHES),
                      "leaf_rows": mesh.leaf_rows,
                      "traffic": mesh.traffic}), flush=True)
    torch.distributed.destroy_process_group()


def mesh_phase(card: str, single_json: dict) -> None:
    """Phase 19: each group of MESH_GROUPS as processes of this script on
    the one card (the kernels are built: the ranks load the library),
    against the single-device proofs of phases 6 and 17, keyed by
    (log_n, seq)."""
    import tempfile

    for flavor, backend, size, log_n, seq in MESH_GROUPS:
        required, forbidden = MESH_KERNELS[flavor]
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            procs = [subprocess.Popen(
                [sys.executable, str(ROOT / "chip_smoke.py"),
                 "--mesh-rank", str(r), "--size", str(size),
                 "--log-n", str(log_n), "--flavor", flavor,
                 *(("--seq", str(seq)) if seq else ()),
                 "--backend", backend, "--store", f"{tmp}/store",
                 "--out", f"{tmp}/proof{r}.json"],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                for r in range(size)]
            outs = []
            try:
                for proc in procs:
                    outs.append(proc.communicate(timeout=MESH_RANK_TIMEOUT_S))
            except subprocess.TimeoutExpired:
                fail(f"mesh {backend} x{size}: a rank passed "
                     f"{MESH_RANK_TIMEOUT_S} s")
            finally:
                for proc in procs:
                    if proc.poll() is None:
                        proc.kill()
                        proc.wait()
            for r, (proc, (out, err)) in enumerate(zip(procs, outs)):
                if proc.returncode != 0:
                    print(err[-3000:], flush=True)
                    fail(f"mesh {backend} x{size}: rank {r} exited "
                         f"{proc.returncode}")
            reports = [json.loads(out.strip().splitlines()[-1])
                       for out, _ in outs]
            proofs = [Path(f"{tmp}/proof{r}.json").read_text()
                      for r in range(size)]
        name = (f"mesh {backend} x{size} "
                + (f"{log_n}x{seq}" if seq else f"poseidon252 {log_n}"))
        if any(p != single_json[(log_n, seq)] for p in proofs):
            fail(f"{name}: a rank's proof differs from the single-device "
                 "proof")
        for rep in reports:
            for kernel in required:
                if rep["launches"][kernel] <= 0:
                    fail(f"{name}: rank {rep['rank']} did not launch "
                         f"{kernel}")
            for kernel in forbidden:
                if rep["launches"][kernel] != 0:
                    fail(f"{name}: rank {rep['rank']} launched {kernel}")
            if not rep["leaf_rows"] or any(
                    local != (1 << log) // size
                    for log, _, local in rep["leaf_rows"]):
                fail(f"{name}: rank {rep['rank']} leaf rows "
                     f"{rep['leaf_rows']} are not n/{size} of each column")
            sent = {kind: t["bytes"] for kind, t in rep["traffic"].items()}
            print(f"  {name} rank {rep['rank']} on {rep['device']}: walls "
                  f"{', '.join(f'{w:.3f}' for w in rep['walls'])} s; "
                  f"launches {json.dumps(rep['launches'], sort_keys=True)};"
                  f" bytes sent {json.dumps(sent, sort_keys=True)}; "
                  f"traffic {json.dumps(rep['traffic'], sort_keys=True)}",
                  flush=True)
        warm = max(rep["walls"][1] for rep in reports)
        phase(name, time.perf_counter() - t0,
              f"{size} rank(s) sharing one card ({card}), not scale-out: "
              f"every rank's proof == the single-device proof; warm wall "
              f"{warm:.3f} s (slowest rank); kernels "
              f"{', '.join(required)} launched on every rank"
              + (f", none of {', '.join(forbidden)}" if forbidden else "")
              + f"; leaf rows n/{size} of every sharded column")


def constraint_eval_only(which: str = "constraint_eval") -> None:
    """`--only constraint_eval`: the card, the build and phase 8b alone,
    then the phase's rows of the kernel table; `--only poseidon2`: phase
    8c instead; `--only quotients`: phase 8d."""
    import torch

    sys.path.insert(0, str(ROOT))
    from tstwo_tpu_torch import kernels

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    t0 = time.perf_counter()
    kernels.lib()
    phase("build", time.perf_counter() - t0,
          f"nvcc {kernels.BUILD_INFO['seconds']:.1f} s")
    for line in kernels.BUILD_INFO.get("ptxas", "").splitlines():
        if which in line or "registers" in line:
            print(f"  ptxas: {line.strip()}", flush=True)
    rows = []
    run_phase = {"constraint_eval": constraint_eval_phase,
                 "poseidon2": poseidon2_phase,
                 "quotients": quotients_phase}[which]
    launches = run_phase(torch.device("cuda", 0), rows)
    for row in rows:
        row.setdefault("launches", launches["constraint_eval"])
    print(json.dumps({"kernels": rows}), flush=True)


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--mesh-rank":
        mesh_rank(sys.argv[1:])
    elif sys.argv[1:2] == ["--only"] and sys.argv[2:] in (
            ["constraint_eval"], ["poseidon2"], ["quotients"]):
        constraint_eval_only(sys.argv[2])
    else:
        main()
