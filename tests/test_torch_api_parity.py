"""Public names of the JAX package that the PyTorch port also has, held
against the JAX functions on the same numpy inputs (tolerance 0).

Each case feeds one seeded numpy array to the JAX function and to the
port's, then compares the uint32 bits.  The port's tensors are int32 on
the CPU; the same names on a CUDA tensor go through the port's hand
kernels (the deinterleave of `fold`, the Blake2s kernel of
`hash_u32_batch`), which chip_smoke.py holds against these plain versions.
"""
import numpy as np
import pytest

import jax.numpy as jnp

from tstwo_tpu import tracing as jax_tracing
from tstwo_tpu.circle import CanonicCoset as JaxCoset
from tstwo_tpu.fields import QM31 as JaxQM31
from tstwo_tpu.lookups import npqm31 as jax_npqm31
from tstwo_tpu.ops import blake2s as jax_b2
from tstwo_tpu.ops import cm31 as jax_cm31
from tstwo_tpu.ops import fft as jax_fft
from tstwo_tpu.ops import m31 as jax_m31
from tstwo_tpu.ops import qm31 as jax_qm31
from tstwo_tpu.poly import circle_poly as jax_circle_poly
from tstwo_tpu.poly.twiddles import precompute_twiddles as jax_twiddles
from tstwo_tpu.vcs import prover as jax_vcs_prover
from tstwo_tpu_torch import tracing
from tstwo_tpu_torch.circle import CanonicCoset
from tstwo_tpu_torch.fields import QM31
from tstwo_tpu_torch.lookups import npqm31
from tstwo_tpu_torch.ops import blake2s as b2
from tstwo_tpu_torch.ops import cm31, m31, qm31
from tstwo_tpu_torch.ops import fft as fft_ops
from tstwo_tpu_torch.poly import circle_poly
from tstwo_tpu_torch.poly.twiddles import precompute_twiddles
from tstwo_tpu_torch.utils import to_numpy_u32, to_torch_u32
from tstwo_tpu_torch.vcs import prover as vcs_prover

P = (1 << 31) - 1


def _m31(rng, *shape):
    return rng.integers(0, P, size=shape, dtype=np.uint32)


def _words(rng, *shape):
    return rng.integers(0, 1 << 32, size=shape, dtype=np.uint64).astype(
        np.uint32)


def _same(port_tensor, jax_array):
    np.testing.assert_array_equal(to_numpy_u32(port_tensor),
                                  np.asarray(jax_array, dtype=np.uint32))


# -- tracing ----------------------------------------------------------------

def test_tracing_records_and_report_match_jax():
    for mod in (tracing, jax_tracing):
        mod.reset()
        mod.enable()
        try:
            for name in ("extension", "merkle", "extension"):
                with mod.span(name):
                    pass
        finally:
            mod.disable()
    port, ref = tracing.records(), jax_tracing.records()
    assert [r["name"] for r in port] == [r["name"] for r in ref]
    assert [sorted(r) for r in port] == [sorted(r) for r in ref]
    assert all(r["seconds"] >= 0 for r in port)
    # the same totals format to the same report
    for mod in (tracing, jax_tracing):
        mod.reset()
        mod._totals.update({"extension": 0.25, "merkle": 1.5, "grind": 0.0})
    assert tracing.report() == jax_tracing.report()
    assert "ms" in tracing.report()
    for mod in (tracing, jax_tracing):
        mod.reset()
    assert tracing.records() == [] and tracing.totals() == {}


def _profiled_names(fn, tmp_path):
    """The event names of a CPU torch.profiler trace of fn() (read from
    the exported Chrome trace: key_averages() takes seconds on a prove)."""
    import json

    import torch.profiler

    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return {e.get("name") for e in json.loads(path.read_text())[
        "traceEvents"]}


def test_profiler_ranges_of_the_spans_show_in_a_torch_profiler_trace(
        tmp_path):
    """`enable(use_profiler=True)`: every span of a small CPU prove is a
    record_function range of that name in a torch.profiler trace, the FRI
    commit's dispatch and fetch among them; without the option a span
    opens no range."""
    from tstwo_tpu_torch.examples.wide_fibonacci import prove_wide_fibonacci

    tracing.reset()
    tracing.enable(use_profiler=True)
    try:
        names = _profiled_names(
            lambda: prove_wide_fibonacci(5, 4, seed=0, device="cpu"),
            tmp_path)
        spans = {r["name"] for r in tracing.records()}
        tracing.enable()

        def bare():
            with tracing.span("no_range_here"):
                pass

        bare_names = _profiled_names(bare, tmp_path)
    finally:
        tracing.disable()
        tracing.reset()
    assert {"fri_commit", "fri_fused_dispatch", "fri_state_fetch",
            "fri_last_layer", "channel_sync", "merkle"} <= spans
    assert spans <= names
    assert "no_range_here" not in bare_names


# -- the API diff -------------------------------------------------------------

# What of the JAX package's public surface the port leaves out on purpose
# (ROADMAP.md section 1, "Not to port"): TPU workarounds, JAX's sharding
# specs and jit caches, the limb arithmetic a TPU lane needs.
NOT_PORTED_MODULES = {"native", "native._tstwo_native", "ops.pallas",
                      "ops.pallas.fft_kernels", "ops.pallas.interleave",
                      "ops.pallas.m31_kernels", "utils_fetch"}
NOT_PORTED_NAMES = {
    "backend": {"XlaBackend"}, "ops.cm31": {"pack"}, "ops.qm31": {"pack"},
    "ops.m31": {"asarray", "np_add", "np_mul", "np_neg", "np_sub"},
    "ops.poseidon252": {"from_mont", "int_to_limbs", "ints_to_limb_array",
                        "limb_array_to_ints", "limbs_to_int", "mont_mul",
                        "to_mont"},
    "parallel.mesh": {"col_sharding", "point_axes", "replicated"},
    "pcs.quotients": {"pack_quotient_inputs"}}
# class members: the deferred fetches of FetchBatch, the TPU dispatch
# thresholds and padding, and the key of a jitted domain kernel's cache
NOT_PORTED_MEMBERS = {"decommit_deferred", "root_deferred", "HOST_N_CPU",
                      "HOST_N_TPU", "PAD", "kernel_cache_key"}


def _shared_modules():
    import importlib
    import pkgutil

    import tstwo_tpu
    import tstwo_tpu_torch

    def names(pkg):
        return {m.name.split(".", 1)[1]: m.name
                for m in pkgutil.walk_packages(pkg.__path__,
                                               pkg.__name__ + ".")}

    ref, port = names(tstwo_tpu), names(tstwo_tpu_torch)
    assert set(ref) - set(port) == NOT_PORTED_MODULES
    return [(rel, importlib.import_module(ref[rel]),
             importlib.import_module(port[rel]))
            for rel in sorted(set(ref) & set(port))]


def _public(module):
    import inspect

    return {n: v for n, v in vars(module).items()
            if not n.startswith("_")
            and (inspect.isfunction(v) or inspect.isclass(v))
            and getattr(v, "__module__", None) == module.__name__}


def test_port_has_every_public_name_and_class_member_of_the_reference():
    """A name-by-name diff of the two packages: every public function and
    class of each shared module, and every public member (method,
    property, attribute) of each shared class, exists in the port, but
    for the listed TPU-only names."""
    missing, members = {}, {}
    for rel, ref, port in _shared_modules():
        names = set(_public(ref)) - set(vars(port))
        if names - NOT_PORTED_NAMES.get(rel, set()):
            missing[rel] = sorted(names)
        for name, cls in _public(ref).items():
            ours = getattr(port, name, None)
            if not isinstance(cls, type) or not isinstance(ours, type):
                continue
            gone = {m for m in dir(cls) if not m.startswith("_")} - set(
                dir(ours))
            if gone - NOT_PORTED_MEMBERS:
                members[f"{rel}.{name}"] = sorted(gone - NOT_PORTED_MEMBERS)
    assert missing == {} and members == {}


# -- poly -------------------------------------------------------------------

@pytest.mark.parametrize("offset,step", [(0, 1), (3, 5), (13, 7)])
def test_coset_sub_evaluation_matches_jax(offset, step):
    values = list(range(100, 116))
    port = circle_poly.CosetSubEvaluation(values, offset, step)
    ref = jax_circle_poly.CosetSubEvaluation(values, offset, step)
    for i in range(-3, 40):
        assert port.at(i) == ref.at(i) == port[i] == port.get(i)


def test_coset_sub_evaluation_refuses_a_length_that_is_not_a_power_of_two():
    with pytest.raises(ValueError):
        circle_poly.CosetSubEvaluation([1, 2, 3], 0, 1)


@pytest.mark.parametrize("log", [3, 5])
@pytest.mark.parametrize("m", [3, 5, 6])
def test_evaluate_values_pads_any_length_as_jax_does(log, m):
    rng = np.random.default_rng(100 * log + m)
    coeffs = _m31(rng, 2, m)
    domain = CanonicCoset.new(log).circle_domain()
    port = circle_poly.evaluate_values(
        to_torch_u32(coeffs), domain, precompute_twiddles(domain.half_coset))
    jdomain = JaxCoset.new(log).circle_domain()
    ref = jax_circle_poly.evaluate_values(
        jnp.asarray(coeffs), jdomain, jax_twiddles(jdomain.half_coset))
    _same(port, ref)


# -- ops --------------------------------------------------------------------

@pytest.mark.parametrize("n_factors", [0, 1, 4])
def test_fft_fold_matches_jax(n_factors):
    rng = np.random.default_rng(n_factors)
    values = _m31(rng, 3, 1 << n_factors)
    factors = [int(f) for f in _m31(rng, n_factors)]
    port = fft_ops.fold(to_torch_u32(values), factors, m31.mul, m31.add)
    ref = jax_fft.fold(jnp.asarray(values), [jnp.uint32(f) for f in factors],
                       jax_m31.mul, jax_m31.add)
    _same(port, ref)


@pytest.mark.parametrize("byte_len", [4, 32, 64, 72, 100, 128])
def test_hash_u32_batch_matches_jax(byte_len):
    rng = np.random.default_rng(byte_len)
    n_words = -(-byte_len // 4)
    words = _words(rng, 17, n_words)
    if byte_len % 4:
        words[:, -1] &= (1 << (8 * (byte_len % 4))) - 1
    port = b2.hash_u32_batch(to_torch_u32(words), byte_len)
    ref = jax_b2.hash_u32_batch(jnp.asarray(words), byte_len)
    assert tuple(port.shape) == (17, 8)
    _same(port, ref)


@pytest.mark.parametrize("t,is_final", [(64, False), (40, True),
                                        ((1 << 32) + 7, True)])
def test_blake2s_compress_matches_jax(t, is_final):
    rng = np.random.default_rng(t % 1000)
    h = _words(rng, 5, 3, 8)
    m = _words(rng, 5, 3, 16)
    port = b2.compress(to_torch_u32(h), to_torch_u32(m), t, is_final)
    ref = jax_b2.compress(jnp.asarray(h), jnp.asarray(m), t, is_final)
    _same(port, ref)


def test_cm31_helpers_match_jax():
    rng = np.random.default_rng(3)
    a, s = _m31(rng, 2, 9), _m31(rng, 9)
    ta, ts = to_torch_u32(a), to_torch_u32(s)
    ja, js = jnp.asarray(a), jnp.asarray(s)
    _same(cm31.real(ta), jax_cm31.real(ja))
    _same(cm31.imag(ta), jax_cm31.imag(ja))
    _same(cm31.from_m31(ts), jax_cm31.from_m31(js))
    _same(cm31.mul_m31(ta, ts), jax_cm31.mul_m31(ja, js))


def test_qm31_helpers_match_jax():
    rng = np.random.default_rng(4)
    a, b, s = _m31(rng, 4, 9), _m31(rng, 2, 9), _m31(rng, 9)
    ta, tb, ts = to_torch_u32(a), to_torch_u32(b), to_torch_u32(s)
    ja, jb, js = jnp.asarray(a), jnp.asarray(b), jnp.asarray(s)
    _same(qm31.c0(ta), jax_qm31.c0(ja))
    _same(qm31.c1(ta), jax_qm31.c1(ja))
    _same(qm31.join(tb, qm31.c1(ta)), jax_qm31.join(jb, jax_qm31.c1(ja)))
    _same(qm31.mul_m31(ta, ts), jax_qm31.mul_m31(ja, js))


@pytest.mark.parametrize("e", [0, 1, 2, 5, 17, P - 2, (1 << 40) + 3])
def test_m31_pow_const_matches_jax(e):
    rng = np.random.default_rng(e % 997)
    v = np.concatenate([_m31(rng, 13),
                        np.array([0, 1, P - 1], dtype=np.uint32)])
    _same(m31.pow_const(to_torch_u32(v), e),
          jax_m31.pow_const(jnp.asarray(v), e))


def test_npqm31_neg_and_mul_scalar_match_jax():
    rng = np.random.default_rng(6)
    x = _m31(rng, 4, 11)
    v = rng.integers(0, P, size=4)
    _same(npqm31.neg(to_torch_u32(x)), jax_npqm31.neg(jnp.asarray(x)))
    _same(npqm31.mul_scalar(to_torch_u32(x), QM31.from_ints(v.tolist())),
          jax_npqm31.mul_scalar(jnp.asarray(x),
                                JaxQM31.from_ints(v.tolist())))


# -- vcs --------------------------------------------------------------------

@pytest.mark.parametrize("shapes", [[(8,)], [(3, 8)], [(8,), (8,), (8,)],
                                    [(8,), (2, 8), (8,)]])
def test_stack_column_groups_and_column_count_match_jax(shapes):
    rng = np.random.default_rng(len(shapes))
    cols = [_m31(rng, *s) for s in shapes]
    port = vcs_prover.stack_column_groups([to_torch_u32(c) for c in cols])
    ref = jax_vcs_prover.stack_column_groups([jnp.asarray(c) for c in cols])
    _same(port, ref)
    assert (vcs_prover.column_count([to_torch_u32(c) for c in cols])
            == jax_vcs_prover.column_count([jnp.asarray(c) for c in cols]))
