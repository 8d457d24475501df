#!/usr/bin/env python3
"""Smoke run of tstwo_tpu_torch on one CUDA GPU.

    python3 chip_smoke.py [--only constraint_eval|poseidon2|quotients|gkr|
                                  poseidon_grind]

Builds the CUDA kernels from tstwo_tpu_torch/csrc and times each against
its plain PyTorch version on the card at the shapes its path gives it (the
rows, their inputs and the plain versions are tests/torch_cuda_cases.py's,
which tests/test_torch_cuda.py holds exactly; each row here is exact
too), then drives the paths, each with the launch counts set to 0 just
before it and read just after.  The phases run from PHASES; `--only NAME`
runs the card, the build and that phase alone:

  * the M31 kernels through their dispatch (`ops.m31_kernels.mul` and
    `mul_chain`, the roofline probes' path), launches counted;
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
  * the Poseidon252 grind (phase 7b, `--only poseidon_grind`): its kernel
    against its plain version, timed beside its bound, then the grind of a
    Poseidon252 channel on the card against `grind_host` at pow_bits 12,
    16 and 20, and at 26 on the card alone;
  * constraint programs (phase 8b, `--only constraint_eval`): LogUp at
    2^21 and wide Fibonacci at 2^21 x 100 (each rows-per-thread variant,
    the eager DomainEvaluator beside it), then a 96-bit wide Fibonacci
    2^20 x 100 prove that launches the kernel once and whose composition
    equals the eager evaluator's; Poseidon2 (8c, `--only poseidon2`): its
    19,899-instruction program at 2^19 x 1296, then a 96-bit 2^17 prove;
  * the DEEP quotients (phase 8d, `--only quotients`): the kernel
    against its plain version at the benchmark cells' quotient groups,
    timed beside its byte bound, then a 96-bit prove of each cell's
    recipe, which must launch it once a group (twice a proof) over the
    committed columns (`quotient_columns` 104 and 1300);
  * LogUp: the golden 2^8 proof against the committed JAX proof, 2^12 CUDA
    proofs against CPU ones for both `pairs` modes, then proves and
    verifies 2^16 and 2^20;
  * GKR (`--only gkr`): the round-sum and MLE-fold kernels against their
    plain versions at the GKR cell's rounds, timed beside their byte
    bound; 2^12 batch proofs of each layer kind against CPU ones, then a
    GrandProduct + LogUpGeneric batch at 2^20, verified, with its claims
    checked against the input MLEs, and a prove under the span tree that
    takes the round-sum kernel twice a round;
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
the same function, where one exists, timed the same way; `bound_ms` the
least time the card could take, the larger of the bytes the function
moves once over HBM_BYTES_PER_S and the integer operations it does over
INT32_OPS_PER_S (the case's `cost`), and `bound_by` which of the two, and
any further bound of the case beside it as `<name>_ms`; `launches` the
count from the path that runs the kernel.  A CFFT row also has `passes`,
the kernel launches of one transform, counted in this run and held to
`ops.fft.cfft_plan` and the limits 1 / 2 / 3 up to 2^11 / 2^22 / 2^30
points, and `columns_per_block`, the columns of the batch a block of each
pass walks over with its twiddles in registers.  A quotient row's `ms` is
the launch alone; its `host_us` and `call_ms` are the whole call's.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

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
    # none: the JAX package grinds a Poseidon252 channel on the host
    "poseidon_grind": "none (tstwo_tpu/proof_of_work.py:19 grind_host on "
                      "the host)",
    "gkr_round_sums": "tstwo_tpu/lookups/gkr.py:311, 331, 363 "
                      "_eval_*_sum_kernel (jitted programs)",
    "mle_fold": "tstwo_tpu/lookups/mle.py:27 _fold_first_variable "
                "(jitted program)",
}
# One H100 SXM (NVIDIA's data sheet): 3.35 TB/s of device memory; 67
# TFLOP/s of float32 outside the tensor cores = 132 SMs x 128 lanes x 2 (a
# fused multiply-add) x 1.98 GHz.  An SM issues int32 operations on half
# of those lanes and an add, xor or shift is one operation, so the integer
# peak is taken as a quarter of that figure: 1.675e13 operations/s.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 4
P = (1 << 31) - 1


def phase(name: str, seconds: float, result: str) -> None:
    print(f"phase {name}: {seconds:.3f} s: {result}", flush=True)


def fail(msg: str) -> None:
    print(f"FAILED: {msg}", flush=True)
    sys.exit(1)


def kernel_cases():
    """tests/torch_cuda_cases.py: the kernel rows' inputs and their plain
    versions, which the card tests hold the kernels to."""
    if str(ROOT / "tests") not in sys.path:
        sys.path.insert(0, str(ROOT / "tests"))
    import torch_cuda_cases

    return torch_cuda_cases


def bound_ms(n_bytes, n_ops) -> float:
    """The least time the card could take to move n_bytes once and do
    n_ops integer operations."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / INT32_OPS_PER_S) * 1e3


def check(rows: list, row, case) -> dict:
    """One row of the kernel table: `case.kernel()` against `case.plain()`
    (exact), both timed, beside the bound of `case.cost`.  A case with a
    `launch` is timed by it, its whole call (`kernel`) giving `host_us`
    and `call_ms`.  Returns the row."""
    import torch

    from tstwo_tpu_torch.measure_roofline import time_call, time_ms

    t0 = time.perf_counter()
    got, want = case.kernel(), case.plain()
    torch.cuda.synchronize()
    err = kernel_cases().max_abs_err(got, want)
    del got
    try:
        cost = case.cost(want)
    except AssertionError as e:
        fail(f"{row.name} {row.shape}: {e}")
    del want
    shape, extra = row.shape + cost.suffix, dict(cost.extra)
    launch = getattr(case, "launch", None)
    timing = time_call(launch or case.kernel)
    if launch:
        call = time_call(case.kernel, cold=False)
        timing["host_us"], extra["call_ms"] = call["host_us"], call["ms"]
    plain_ms = time_ms(case.plain)
    lib_t = {"ms": None, "host_us": None} if cost.library is None \
        else time_call(cost.library, cold=False)
    library_ms = lib_t["ms"]
    extra.update({f"{name}_ms": bound_ms(*counts)
                  for name, counts in cost.bounds.items()})
    bound = bound_ms(cost.n_bytes, cost.n_ops)
    phase(f"kernel {row.name} {shape}", time.perf_counter() - t0,
          f"max_abs_err {err} (tolerance 0), kernel {timing['ms']:.4f} ms"
          f" (cold {timing['cold_ms']:.4f} ms, host "
          f"{timing['host_us']:.1f} us), plain {plain_ms:.4f} ms"
          + (f", library {library_ms:.4f} ms (host "
             f"{lib_t['host_us']:.1f} us)" if cost.library else "")
          + f", bound {bound:.4f} ms"
          + "".join(f", {k} {v}" for k, v in extra.items()))
    if err != 0:
        fail(f"{row.name} {shape} disagrees with its plain version")
    out = {"name": row.name, "shape": shape, "route": "cuda",
           "source": CSRC + cost.source, "replaces": REPLACES[row.name],
           "max_abs_err": err, "ms": timing["ms"],
           "cold_ms": timing["cold_ms"], "host_us": timing["host_us"],
           "plain_ms": plain_ms, "bound_ms": bound,
           "bound_by": ("bytes" if cost.n_bytes / HBM_BYTES_PER_S
                        >= cost.n_ops / INT32_OPS_PER_S else "operations"),
           "library_ms": library_ms, "library_host_us": lib_t["host_us"],
           **extra}
    rows.append(out)
    return out


def kernel_phase(run) -> None:
    """Phase 3: every kernel against its plain version at the shapes its
    paths give it (tests/torch_cuda_cases.py's KERNEL_ROWS; exact:
    tolerance 0), each row timed."""
    t0 = time.perf_counter()
    for row in kernel_cases().KERNEL_ROWS:
        check(run.rows, row, row.build(run.device))
    phase("kernels", time.perf_counter() - t0,
          f"{len(run.rows)} checks exact")


def m31_phase(run) -> None:
    """Phase 3b: the M31 kernels through their dispatch
    (`ops.m31_kernels.mul` and `mul_chain` on card tensors, the roofline
    probes' path, as in the JAX package), launches counted, each result
    against its plain version."""
    from tstwo_tpu_torch import kernels
    from tstwo_tpu_torch.ops import m31_kernels

    t0 = time.perf_counter()
    case = kernel_cases().m31_case(1 << 24, run.device, reps=8)
    kernels.reset_launches()
    got = (m31_kernels.mul(case.a, case.b),
           m31_kernels.mul_chain(case.a, case.b, case.reps))
    launches = launch_counts("m31", ("m31_mul", "m31_mul_chain"))
    want = (m31_kernels.mul_plain(case.a, case.b), case.plain())
    if kernel_cases().max_abs_err(got, want):
        fail("the M31 dispatch differs from the plain versions")
    run.counts.update({name: launches[name]
                       for name in ("m31_mul", "m31_mul_chain")})
    phase("m31", time.perf_counter() - t0,
          "m31_kernels.mul and mul_chain (reps 8) at 2^24 on the card "
          "launched their kernels, exact")


def proof_json(proof) -> str:
    from tstwo_tpu_torch.serialize import proof_to_dict

    return json.dumps(proof_to_dict(proof), sort_keys=True)


def card_and_build() -> str:
    """Phases 1-2: the card (its name and power limit first) and the
    kernels' build; returns the card's nvidia-smi line."""
    import torch

    from tstwo_tpu_torch import kernels

    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    phase("card", time.perf_counter() - t0,
          f"{torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} device(s)")
    t0 = time.perf_counter()
    kernels.lib()
    info = kernels.BUILD_INFO
    phase("build", time.perf_counter() - t0,
          f"nvcc {info['seconds']:.1f} s{' (cached)' if info['cached'] else ''}"
          f" -> {Path(info['path']).relative_to(ROOT)}")
    for line in info.get("ptxas", "").splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}", flush=True)
    return card


def wide_fibonacci_phases(run) -> None:
    """Phases 4-6: wide Fibonacci, the main path.  The golden 2^8 x 8
    proof against the JAX package's, 2^12 x 32 CUDA against CPU, then two
    proves each at 2^16 x 32 and 2^18 x 64 with the kernels the main path
    launches counted (the first prove at a size also fills the host-side
    caches of that size: twiddle trees, domain points, vanishing
    inverses; the second is the warm time)."""
    import torch

    from tstwo_tpu_torch import kernels
    from tstwo_tpu_torch.examples.wide_fibonacci import (
        prove_wide_fibonacci, verify_wide_fibonacci)

    device = run.device
    t0 = time.perf_counter()
    proof, comp, cfg = prove_wide_fibonacci(8, 8, seed=0, device=device)
    if proof_json(proof) != FIXTURE.read_text().strip():
        fail("wide-Fibonacci 8x8 CUDA proof differs from the JAX fixture")
    verify_wide_fibonacci(proof, comp, cfg, 8)
    phase("golden", time.perf_counter() - t0,
          "log 8 x 8 seed 0 proof == JAX fixture; verified")

    t0 = time.perf_counter()
    cuda_json = proof_json(prove_wide_fibonacci(12, 32, seed=0,
                                                device=device)[0])
    cpu_json = proof_json(prove_wide_fibonacci(12, 32, seed=0,
                                               device="cpu")[0])
    if cuda_json != cpu_json:
        fail("wide-Fibonacci 12x32 CUDA proof differs from the CPU proof")
    phase("mid_size", time.perf_counter() - t0,
          "log 12 x 32 CUDA proof == CPU plain proof")

    t0 = time.perf_counter()
    prove_wide_fibonacci(16, 32, seed=0, device=device)  # warm run
    torch.cuda.synchronize()
    phase("warm", time.perf_counter() - t0, "log 16 x 32 warm prove")
    kernels.reset_launches()
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
        run.proofs[(log_n, seq)] = proof_json(proof)
    launches = launch_counts("wide_fibonacci", MAIN_PATH_KERNELS,
                             forbidden=("blake2s_grind",))
    run.counts.update({name: launches[name] for name in (
        "cfft_forward", "cfft_inverse", "blake2s", "merkle_layer",
        "merkle_tail", "deinterleave", "blake2s_transcript")})
    # the contiguous pass (fft_fused's work) runs in every transform
    run.counts["cfft_block_resident"] = launches["cfft_forward"] \
        + launches["cfft_inverse"]


def main(only=None) -> None:
    """Every phase of PHASES in order, or with `only` the card, the build
    and that phase alone; then the kernel table and the result."""
    if not (ROOT / "tstwo_tpu_torch" / "kernels.py").is_file():
        fail("tstwo_tpu_torch is not beside this script")
    for fixture in (FIXTURE, LOGUP_FIXTURE, POSEIDON_FIXTURE):
        if not fixture.is_file():
            fail(f"missing golden fixture {fixture}")
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    sys.path.insert(0, str(ROOT))
    # what the phases share: the kernel table's rows, the launches each
    # row reports (those of the path that runs its kernel), and the
    # single-device proofs the mesh phase holds its ranks to
    run = SimpleNamespace(device=torch.device("cuda", 0),
                          card=card_and_build(), rows=[], counts={},
                          proofs={})
    for name, run_phase in PHASES:
        if only in (None, name):
            run_phase(run)
    for row in run.rows:
        row.setdefault("launches", run.counts.get(row["name"]))
    print(json.dumps({"kernels": run.rows}), flush=True)
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
# what a GKR batch prove launches besides the deinterleave of its layers:
# a round's sums and its MLE folds
GKR_KERNELS = ("gkr_round_sums", "mle_fold")


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


def fri_transcript(run) -> None:
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

    device, card, log_n, seq = run.device, run.card, 18, 64
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


def defaults_phase(run) -> None:
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

    cuda0, log_n, seq = torch.device("cuda", 0), 18, 64
    example_json = run.proofs[(log_n, seq)]
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
    flat = kernel_cases().flat_gkr_proof
    if flat(gkr) != flat(gkr_twin):
        fail("defaults: the GKR proof with no device differs from "
             "device=\"cuda\"")
    gkr_counts = {k: gkr_launches[k] for k in GKR_KERNELS}
    if min(gkr_counts.values()) <= 0:
        fail(f"defaults: the GKR batch left a kernel out: {gkr_counts}")
    phase("defaults logup gkr", time.perf_counter() - t0,
          "LogUp 2^12 from LogupTraceGenerator(12), Seq(12).gen_column() "
          "with no device == prove_logup_lookup(12, device=\"cuda\"), "
          f"verified, launches {json.dumps(logup_counts, sort_keys=True)}; "
          "GKR GrandProduct 2^12 from Mle(numpy) == Mle(to_torch_u32(.., "
          f"\"cuda\")), launches {json.dumps(gkr_counts, sort_keys=True)}")


def grind_rates(run) -> None:
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
        grind(ch, pow_bits, device=run.device)  # warm
        walls = []
        for _ in range(3):
            nonce, wall = timed(lambda: grind(ch, pow_bits,
                                              device=run.device))
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


def poseidon_grind_phase(run) -> None:
    """Phase 7b (`--only poseidon_grind`): the Poseidon252 grind kernel at
    tests/torch_cuda_cases.py's POSEIDON_GRIND_ROWS against its plain
    version (`check`), timed beside the bound of two permutations a nonce;
    then `grind` of a Poseidon252 channel on the card against `grind_host`
    from three channel states at pow_bits 12 and 16 and from one at 20, and
    at 20 from another against the plain scan on the card (the same
    nonce), one launch a batch of GRIND_BATCH_P252_CUDA; last
    pow_bits 26 from each state on the card alone, its nonce's digest
    checked on the host and, from the fresh state, every nonce below it
    scanned by the plain version on the card without a hit."""
    from tstwo_tpu_torch import kernels
    from tstwo_tpu_torch.channel.poseidon import (FieldElement252,
                                                  Poseidon252Channel)
    from tstwo_tpu_torch.ops import poseidon252 as pos
    from tstwo_tpu_torch.proof_of_work import (GRIND_BATCH_P252_CUDA, grind,
                                               grind_host)

    cases, device = kernel_cases(), run.device
    for row in cases.POSEIDON_GRIND_ROWS:
        check(run.rows, row, row.build(device))
    t0 = time.perf_counter()
    for pow_bits in (12, 16, 20, 26):
        for label, digest in cases.poseidon_grind_digests():
            if pow_bits == 20 and label == "fresh":
                continue
            ch = Poseidon252Channel(FieldElement252(digest))
            grind(ch, pow_bits, device=device)  # warm
            kernels.reset_launches()
            nonce, wall = timed(lambda: grind(ch, pow_bits, device=device))
            launches = kernels.LAUNCHES["poseidon_grind"]
            if launches != nonce // GRIND_BATCH_P252_CUDA + 1:
                fail(f"Poseidon252 grind at pow_bits {pow_bits}: {launches} "
                     f"launches for nonce {nonce}")
            if pow_bits == 20 and label == "mix_root":
                # its hit lies at 122,593, ~3 min of host hashing
                want = int(pos.poseidon_grind_hit_plain(
                    digest, 0, nonce + 1, pow_bits, device))
                if nonce != want:
                    fail(f"Poseidon252 grind at pow_bits {pow_bits} "
                         f"({label}): card {nonce}, plain scan {want}")
                host = "the plain scan on the card's nonce"
            elif pow_bits <= 20:
                t1 = time.perf_counter()
                want = grind_host(ch, pow_bits)
                host_s = time.perf_counter() - t1
                if nonce != want:
                    fail(f"Poseidon252 grind at pow_bits {pow_bits} "
                         f"({label}): card {nonce}, host {want}")
                host = (f"host {host_s:.3f} s "
                        f"({host_s / (want + 1) * 1e6:.1f} us a nonce), the "
                        "same nonce")
            else:
                probe = ch.clone()
                probe.mix_u64(nonce)
                if probe.trailing_zeros() < pow_bits:
                    fail(f"Poseidon252 grind at pow_bits 26 ({label}): "
                         f"nonce {nonce} has too few trailing zeros")
                host = "its digest checked on the host"
                if label == "fresh":
                    t1 = time.perf_counter()
                    for start in range(0, nonce, GRIND_BATCH_P252_CUDA):
                        count = min(GRIND_BATCH_P252_CUDA, nonce - start)
                        if int(pos.poseidon_grind_hit_plain(
                                digest, start, count, pow_bits, device)) >= 0:
                            fail("Poseidon252 grind at pow_bits 26: the "
                                 f"plain scan hits below {nonce}")
                    host += (f", no hit below it by the plain scan "
                             f"({time.perf_counter() - t1:.3f} s)")
            print(f"  poseidon grind {label} pow_bits {pow_bits}: nonce "
                  f"{nonce}; card {wall * 1e3:.3f} ms synchronised in "
                  f"{launches} launch(es), "
                  f"{(nonce + 1) / wall / 1e6:.2f} M nonces/s; {host}",
                  flush=True)
    phase("poseidon grind", time.perf_counter() - t0,
          "grind of a Poseidon252 channel on the card == grind_host at "
          "pow_bits 12, 16 and 20 (and the plain scan at 20); at 26 a hit, "
          "one launch a batch")


def secure_prove(run) -> None:
    """Phase 8: wide Fibonacci 2^18 x 64 under stwo-cairo's
    secure_pcs_config (pow_bits 26, log blowup 1, 70 queries: 96 bits):
    two proves, a third under synchronised spans (the grind span beside
    the others), the port's verifier, and the nonce held against the plain
    grind scanned on the card over [0, nonce].  The grind kernel's row
    reports the launches of the proves."""
    import torch

    from tstwo_tpu_torch import kernels, tracing
    from tstwo_tpu_torch.examples.wide_fibonacci import (
        prove_wide_fibonacci, verify_wide_fibonacci)
    from tstwo_tpu_torch.fri import FriConfig
    from tstwo_tpu_torch.ops.blake2s import (digest_bytes_to_words,
                                             grind_batch_plain)
    from tstwo_tpu_torch.pcs import PcsConfig
    from tstwo_tpu_torch.pcs import prover as pcs_prover

    device = run.device
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
    run.counts["blake2s_grind"] = launches["blake2s_grind"]


def eager(ev, columns, log_n: int, coeffs, shift):
    """The eager DomainEvaluator's quotients of `ev` over the trace
    `columns` on the 2^(log_n + 1) domain: the path the constraint
    programs replaced, and the oracle of the prove's accumulation."""
    from tstwo_tpu_torch import constraint_framework as cf
    from tstwo_tpu_torch.constraints import \
        coset_vanishing_denominator_inverses_bitrev
    from tstwo_tpu_torch.ops import m31
    from tstwo_tpu_torch.utils import to_torch_u32

    dinv = to_torch_u32(coset_vanishing_denominator_inverses_bitrev(
        log_n, log_n + 1), columns.device)
    dom = cf.DomainEvaluator([[], list(columns)], log_n, log_n + 1,
                             coeffs.view(-1, 4), shift, None)
    ev.evaluate(dom)
    return m31.mul(dom.row_res.arr, dinv[None, :])


def constraint_eval_phase(run) -> None:
    """Phase 8b: constraint programs (constraint_framework/program.py) on
    the card.  `constraint_eval` against the plain executor, bit for bit
    and timed: the LogUp AIR at 2^21 in both `pairs` modes (offset -1
    masks, secure parameters), and wide Fibonacci 2^21 x 100, the row of
    the kernel table, with each rows-per-thread variant timed and the
    eager DomainEvaluator it replaces (equal, timed) beside it.  Then wide
    Fibonacci 2^20 x 100 at 96 bits, proved twice: the warm prove launches
    `constraint_eval` once, lowers nothing, runs no DomainEvaluator, and
    its composition accumulation equals the eager DomainEvaluator's on the
    same card columns."""
    from tstwo_tpu_torch import constraint_framework as cf
    from tstwo_tpu_torch import kernels, tracing
    from tstwo_tpu_torch.examples.wide_fibonacci import (
        prove_wide_fibonacci, verify_wide_fibonacci)
    from tstwo_tpu_torch.fri import FriConfig
    from tstwo_tpu_torch.measure_roofline import time_call, time_ms
    from tstwo_tpu_torch.ops import constraint_eval as ce
    from tstwo_tpu_torch.ops import m31
    from tstwo_tpu_torch.pcs import PcsConfig

    cases, device, log_n, columns = kernel_cases(), run.device, 20, 100
    for row in cases.LOGUP_PROGRAMS:
        case = row.build(device)
        if cases.max_abs_err(case.kernel(), case.plain()):
            fail(f"constraint_eval {row.shape} differs from the plain "
                 "executor")
        timing = time_call(case.kernel)
        program = case.program
        print(f"  constraint_eval {row.shape}: {program.n_constraints} "
              f"constraints, {len(program.code)} instructions, "
              f"{program.n_slots} slots, {timing['ms']:.4f} ms (cold "
              f"{timing['cold_ms']:.4f} ms)", flush=True)
        del case
    t0 = time.perf_counter()
    case = cases.WIDE_FIB_PROGRAM.build(device)
    wf_row = check(run.rows, cases.WIDE_FIB_PROGRAM, case)
    wf_row["rows_per_thread_ms"] = {
        rpt: time_ms(lambda: case.kernel(rpt)) for rpt in (1, 2, 4, 8)}
    # the eager path this replaces, on the same card columns
    program, scalars = case.program, case.scalars

    def eager_call():
        return eager(case.ev, case.stacks[1], case.trace_log,
                     scalars[:program.param_off],
                     scalars[program.shift_off:program.shift_off + 4])

    case.acc.copy_(case.acc0)
    if cases.max_abs_err(case.kernel(), m31.add(case.acc0, eager_call())):
        fail(f"constraint_eval {wf_row['shape']} differs from the eager "
             "DomainEvaluator")
    wf_row["eager_ms"] = eager_ms = time_ms(eager_call)
    phase(f"constraint_eval {wf_row['shape']} eager",
          time.perf_counter() - t0,
          f"== the eager DomainEvaluator ({eager_ms:.4f} ms, the kernel "
          f"{wf_row['ms']:.4f} ms); kernel ms by rows per thread: "
          f"{json.dumps(wf_row['rows_per_thread_ms'])}")
    del case

    # the 96-bit prove: one launch a proof, its accumulation == the eager
    t0 = time.perf_counter()
    config = PcsConfig(SECURE_POW_BITS, FriConfig(0, 1, SECURE_QUERIES))
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
    want = m31.add(before, eager(comp.eval, stacks[1], log_n,
                                 scalars[:4 * k], scalars[4 * k:4 * k + 4]))
    if cases.max_abs_err(after, want):
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
    run.counts["constraint_eval"] = launches["constraint_eval"]


def poseidon2_phase(run) -> None:
    """Phase 8c: the Poseidon2 AIR (examples/poseidon2.py).  Its constraint
    program (19,899 instructions, more than a block's shared memory holds)
    and wide Fibonacci's (493) through `constraint_eval`, each bit for bit
    against the plain executor and timed as phase 8b times them:
    Poseidon2 at 2^19 x 1264 (+ 32 interaction columns), bound by the
    operations its equations need (the benchmark reference's
    `constraint_ops`, the port's instruction count beside it), wide
    Fibonacci at 2^21 x 100, bound by the port's count as in phase 8b.
    Then a 2^17-row prove at 96 bits, three times: the warm prove,
    with the launch counts reset just before it, launches `constraint_eval`
    once and every kernel of the main path and the grind, runs no
    DomainEvaluator on the card, fuses 1144 constraints, and verifies.
    The Poseidon2 row's `launches` are that prove's."""
    from tstwo_tpu_torch import constraint_framework as cf
    from tstwo_tpu_torch import kernels, tracing
    from tstwo_tpu_torch.examples.poseidon2 import (prove_poseidon2,
                                                    verify_poseidon2)
    from tstwo_tpu_torch.fri import FriConfig
    from tstwo_tpu_torch.pcs import PcsConfig

    sys.path.insert(0, str(ROOT))
    from stark_bench.reference.poseidon2 import constraint_ops

    cases, device, log_n = kernel_cases(), run.device, 17
    p2_row = check(run.rows, cases.POSEIDON2_PROGRAM,
                   cases.POSEIDON2_PROGRAM.build(
                       device, equation_ops=constraint_ops({}, log_n)))
    check(run.rows, cases.WIDE_FIB_PROGRAM,
          cases.WIDE_FIB_PROGRAM.build(device))

    # the 96-bit prove: one launch a proof, no eager evaluator, verified
    t0 = time.perf_counter()
    config = PcsConfig(SECURE_POW_BITS, FriConfig(0, 1, SECURE_QUERIES))
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
    run.counts.setdefault("constraint_eval", launches["constraint_eval"])
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


def quotients_phase(run) -> None:
    """Phase 8d: the DEEP quotients (csrc/quotients.cu).  The kernel at
    the benchmark cells' quotient groups (tests/torch_cuda_cases.py's
    QUOTIENT_ROWS) against the plain version (`_accumulate_rows`, on the
    card) bit for bit (`check`): the launch alone timed warm and cold
    beside its bound (each column value read once, the [4, n] result
    written once), the whole call's time and host cost beside them.
    Then one 96-bit prove of each
    cell's recipe, wide Fibonacci 2^20 x 100 and Poseidon2 2^17, warm,
    under the span tree: one launch a group (2 a proof) and
    `quotient_columns` the committed columns (104 and 1300); the
    synchronised `fri_quotients` span of a third prove.  The rows report
    the launches of the Poseidon2 prove."""
    from tstwo_tpu_torch import kernels, tracing
    from tstwo_tpu_torch.examples.poseidon2 import prove_poseidon2
    from tstwo_tpu_torch.examples.wide_fibonacci import prove_wide_fibonacci
    from tstwo_tpu_torch.fri import FriConfig
    from tstwo_tpu_torch.pcs import PcsConfig

    cases, device = kernel_cases(), run.device
    for row in cases.QUOTIENT_ROWS:
        check(run.rows, row, row.build(device))

    config = PcsConfig(SECURE_POW_BITS, FriConfig(0, 1, SECURE_QUERIES))
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
    run.counts["accumulate_quotients"] = launches["accumulate_quotients"]


def logup_phases(run) -> None:
    """Phases 10-12: the LogUp lookup AIR (three trees, LogUp interaction
    trace).  Golden 2^8 proof, 2^12 CUDA == CPU for both `pairs` modes,
    then two proves each at 2^16 and 2^20 with the launches counted."""
    import torch

    from tstwo_tpu_torch import kernels
    from tstwo_tpu_torch.examples.logup_lookup import (prove_logup_lookup,
                                                       verify_logup_lookup)

    device = run.device
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
    launch_counts("logup", MAIN_PATH_KERNELS, forbidden=("blake2s_grind",))


def gkr_phases(run) -> None:
    """Phases 13-14 (`--only gkr`): the GKR kernels (csrc/gkr.cu) at the
    GKR cell's rounds (tests/torch_cuda_cases.py's GKR_ROWS) against
    their plain versions bit for bit (`check`), timed beside the bound of
    their bytes; 2^12 CUDA == CPU batch proofs for each layer kind; then a
    GrandProduct + LogUpGeneric batch at 2^20: two proves, the batch
    verifier, its claims against the input MLEs, and a third prove under
    the span tree, which must take the round-sum kernel in every oracle
    round (`gkr_round_sums_on_card` twice `sumcheck_rounds`, 380)."""
    import torch

    from tstwo_tpu_torch import kernels, tracing
    from tstwo_tpu_torch.channel.blake2s import Blake2sChannel
    from tstwo_tpu_torch.lookups.gkr import (GATE_GRAND_PRODUCT, GATE_LOGUP,
                                             partially_verify_batch,
                                             prove_batch)

    cases, device = kernel_cases(), run.device
    for row in cases.GKR_ROWS:
        check(run.rows, row, row.build(device))
    t0 = time.perf_counter()
    for i, kind in enumerate(cases.GKR_COLUMNS):
        cuda_proof, _ = prove_batch(Blake2sChannel(),
                                    [cases.gkr_layer(kind, 12, i, device)])
        cpu_proof, _ = prove_batch(Blake2sChannel(),
                                   [cases.gkr_layer(kind, 12, i, "cpu")])
        if cases.flat_gkr_proof(cuda_proof) != \
                cases.flat_gkr_proof(cpu_proof):
            fail(f"GKR {kind} 2^12 CUDA proof differs from the CPU proof")
    phase("gkr mid_size", time.perf_counter() - t0,
          "2^12 CUDA proofs == CPU plain proofs for all four layer kinds")

    log_n = 20
    layers = [cases.gkr_layer("GrandProduct", log_n, 10, device),
              cases.gkr_layer("LogUpGeneric", log_n, 11, device)]
    kernels.reset_launches()
    walls = []
    for _ in range(2):
        torch.cuda.reset_peak_memory_stats(device)
        (proof, artifact), wall = timed(
            lambda: prove_batch(Blake2sChannel(), layers))
        walls.append(wall)
    peak = torch.cuda.max_memory_allocated(device)
    launches = launch_counts("gkr", ("deinterleave",) + GKR_KERNELS)
    # a proof's launches, of the two counted
    run.counts.update({name: launches[name] // 2 for name in GKR_KERNELS})
    art, verify_s = timed(lambda: partially_verify_batch(
        [GATE_GRAND_PRODUCT, GATE_LOGUP], proof, Blake2sChannel()))
    if art.ood_point != artifact.ood_point or \
            art.claims_to_verify_by_instance != \
            artifact.claims_to_verify_by_instance:
        fail("GKR 2^20 verifier artifact differs from the prover's")
    # the input MLEs at the OOD point, on the card and, as a witness apart
    # from the CUDA path, on CPU copies made from the same numpy values
    cpu_layers = [cases.gkr_layer("GrandProduct", log_n, 10, "cpu"),
                  cases.gkr_layer("LogUpGeneric", log_n, 11, "cpu")]
    for where, (gp, lg) in (("card", layers), ("CPU", cpu_layers)):
        if art.claims_to_verify_by_instance != [
                [gp.data.eval_at_point(art.ood_point)],
                [lg.numerators.eval_at_point(art.ood_point),
                 lg.denominators.eval_at_point(art.ood_point)]]:
            fail(f"GKR 2^20 claims differ from the input MLEs ({where}) at "
                 "the OOD point")
    tracing.reset()
    tracing.enable(sync=False)
    try:
        with tracing.request(0):
            traced = prove_batch(Blake2sChannel(), layers)[0]
        counts = tracing.counts()[0]
    finally:
        tracing.disable()
        tracing.reset()
    if cases.flat_gkr_proof(traced) != cases.flat_gkr_proof(proof):
        fail("GKR 2^20 proof under the span tree differs")
    rounds = counts.get("sumcheck_rounds")
    on_card = counts.get("gkr_round_sums_on_card")
    if rounds != log_n * (log_n - 1) // 2 or on_card != 2 * rounds:
        fail(f"GKR 2^20: {on_card} round sums on the card in {rounds} "
             "rounds, not two a round")
    phase(f"gkr prove 2^{log_n}", walls[1],
          f"GrandProduct + LogUpGeneric batch: two proves {walls[0]:.3f} s, "
          f"{walls[1]:.3f} s; verified in {verify_s:.3f} s; claims == input "
          "MLEs at the OOD point on the card and on the CPU; peak device "
          f"memory {peak / 2**30:.3f} GiB; gkr_round_sums_on_card {on_card} "
          f"in {rounds} sumcheck_rounds")


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


def poseidon_phases(run) -> None:
    """Phases 15-17: the basic AIR under the Poseidon252 flavour.  Golden
    2^4 proof, 2^6 CUDA == CPU, then two proves each at 2^16 and 2^20 rows
    with the launches counted; every proof verified on the host, whose
    hash_node is Python-int Hades and shares nothing with the kernel.
    Keeps the 2^16 and 2^20 proofs' fields JSON (the mesh phase's
    references)."""
    import torch

    from tstwo_tpu_torch import kernels
    from tstwo_tpu_torch.examples.basic_air import (prove_basic_air,
                                                    verify_basic_air)

    device = run.device

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
        run.proofs[(log_n, None)] = fields_json(proof)
    run.counts["poseidon_merkle_layer"] = launch_counts(
        "poseidon", POSEIDON_KERNELS,
        forbidden=BLAKE2S_KERNELS)["poseidon_merkle_layer"]


def poseidon_sponge(run) -> None:
    """Phase 18: `poseidon_hash_many` of 2^16 rows of three felts on the
    card (two Hades launches): every row against the same sponge around
    the plain permutation, rows 0-7 against the host's hash."""
    import numpy as np

    from tstwo_tpu_torch import kernels
    from tstwo_tpu_torch.channel.poseidon import poseidon_hash_many
    from tstwo_tpu_torch.ops import poseidon252 as pos

    cases = kernel_cases()
    rng = np.random.default_rng(16)
    cols = [cases.rand_felts(rng, 1 << 16, run.device) for _ in range(3)]
    kernels.reset_launches()
    digests, wall = timed(lambda: pos.poseidon_hash_many(cols))
    launches = launch_counts("poseidon sponge", ("hades_permutation",))
    rows = list(zip(*(pos.felts_to_ints(c[:, :8]) for c in cols)))
    if pos.felts_to_ints(digests[:, :8]) != [poseidon_hash_many(r)
                                             for r in rows]:
        fail("poseidon_hash_many on the card differs from the host's hash")
    plain = pos._sponge(cols, 1 << 16, run.device,
                        pos.hades_permutation_plain)
    if cases.max_abs_err(digests, plain):
        fail("poseidon_hash_many on the card differs from the plain sponge")
    phase("poseidon sponge", wall,
          "poseidon_hash_many of 2^16 rows of 3 felts == the sponge around "
          "the plain permutation (all rows) == host hash (rows 0-7)")
    run.counts["hades_permutation"] = launches["hades_permutation"]


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


def mesh_phase(run) -> None:
    """Phase 19: each group of MESH_GROUPS as processes of this script on
    the one card (the kernels are built: the ranks load the library),
    against the single-device proofs of phases 6 and 17, keyed by
    (log_n, seq)."""
    import tempfile

    card, single_json = run.card, run.proofs
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


# (--only name, phase) in the order main() runs them: `--only NAME` runs
# the card, the build and that phase alone
PHASES = ((None, kernel_phase), (None, m31_phase),
          (None, wide_fibonacci_phases),
          (None, fri_transcript), (None, defaults_phase),
          (None, grind_rates), ("poseidon_grind", poseidon_grind_phase),
          (None, secure_prove),
          ("constraint_eval", constraint_eval_phase),
          ("poseidon2", poseidon2_phase), ("quotients", quotients_phase),
          (None, logup_phases), ("gkr", gkr_phases), (None, poseidon_phases),
          (None, poseidon_sponge), (None, mesh_phase))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-rank"]:
        mesh_rank(sys.argv[1:])
    else:
        import argparse

        ap = argparse.ArgumentParser()
        ap.add_argument("--only", choices=[name for name, _ in PHASES if name])
        main(ap.parse_args().only)
