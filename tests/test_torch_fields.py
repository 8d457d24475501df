"""Field parity of the PyTorch port against the Rust vectors and the JAX ops.

The 807 Rust-generated vectors (tests/vectors/all-field-test-vectors.json)
replay against the port's host field classes; the port's tensor ops
(int32 tensors, int64 compute) must equal the JAX package's uint32 ops
exactly on random arrays and on the edge values 0, 1 and P-1.
"""
import collections
import json
import os

import numpy as np
import pytest

import jax.numpy as jnp

from tstwo_tpu.ops import cm31 as jax_cm31
from tstwo_tpu.ops import m31 as jax_m31
from tstwo_tpu.ops import qm31 as jax_qm31
from tstwo_tpu_torch.fields import CM31, M31, QM31, SecureColumnByCoords
from tstwo_tpu_torch.ops import cm31, m31, qm31
from tstwo_tpu_torch.utils import to_numpy_u32, to_torch_u32

P = (1 << 31) - 1
VECTORS = os.path.join(os.path.dirname(__file__), "vectors",
                       "all-field-test-vectors.json")


def _groups():
    with open(VECTORS) as f:
        fields = json.load(f)
    groups = collections.defaultdict(list)
    for field in fields:
        for v in field["test_vectors"]:
            groups[(field["field_type"], v["operation"])].append(v)
    return groups


GROUPS = _groups()


def _cm(d, prefix=""):
    return CM31(d[prefix + "real"], d[prefix + "imag"])


def _cm_out(c):
    return {"real": c.a, "imag": c.b}


def _q(x):
    return list(x.to_ints())


def _replay_m31(op, ins, out):
    if op in ("add", "sub", "mul"):
        a, b = M31(ins["a"]), M31(ins["b"])
        r = {"add": a + b, "sub": a - b, "mul": a * b}[op]
        return r.value == out
    table = {
        "neg": lambda: (-M31(ins["a"])).value,
        "from_u32_unchecked": lambda: M31.from_u32_unchecked(ins["value"]).value,
        "from_i32": lambda: M31.from_int(int(ins["value"])).value,
        "from_u32": lambda: M31.from_int(int(ins["value"])).value,
        "partial_reduce": lambda: M31.partial_reduce(int(ins["value"])).value,
        "reduce": lambda: M31.reduce(int(ins["value"])).value,
        "inverse": lambda: M31(ins["value"]).inverse().value,
        "pow2147483645": lambda: M31(ins["value"]).inverse().value,
        "into_slice": lambda: list(M31.into_slice(
            [M31(x) for x in ins["elements"]])),
        "zero": lambda: M31.zero().value,
        "one": lambda: M31.one().value,
        "is_zero": lambda: M31(ins["value"]).is_zero(),
        "complex_conjugate": lambda: M31(ins["value"]).complex_conjugate().value,
    }
    return table[op]() == out


def _replay_cm31(op, ins, out):
    if op in ("add", "sub", "mul"):
        a, b = _cm(ins, "a_"), _cm(ins, "b_")
        r = {"add": a + b, "sub": a - b, "mul": a * b}[op]
        return _cm_out(r) == out
    table = {
        "neg": lambda: _cm_out(-_cm(ins)),
        "from_u32_unchecked": lambda: _cm_out(
            CM31.from_u32_unchecked(ins["real"], ins["imag"])),
        "inverse": lambda: _cm_out(_cm(ins).inverse()),
        "complex_conjugate": lambda: _cm_out(_cm(ins).complex_conjugate()),
        "into_slice": lambda: list(CM31.into_slice(
            [_cm(e) for e in ins["elements"]])),
        "zero": lambda: _cm_out(CM31.zero()),
        "one": lambda: _cm_out(CM31.one()),
    }
    return table[op]() == out


def _replay_qm31(op, ins, out):
    if op in ("add", "sub", "mul"):
        a, b = QM31.from_ints(ins["a"]), QM31.from_ints(ins["b"])
        r = {"add": a + b, "sub": a - b, "mul": a * b}[op]
        return _q(r) == out
    table = {
        "neg": lambda: _q(-QM31.from_ints(ins["value"])),
        "from_u32_unchecked": lambda: _q(
            QM31.from_u32_unchecked(*ins["values"])),
        "from_partial_evals": lambda: _q(QM31.from_partial_evals(
            [QM31.from_ints(e) for e in ins["evals"]])),
        "inverse": lambda: _q(QM31.from_ints(ins["value"]).inverse()),
        "mul_cm31": lambda: _q(QM31.from_ints(ins["qm31"]).mul_cm31(
            CM31(*ins["cm31"]))),
        "into_slice": lambda: list(QM31.into_slice(
            [QM31.from_ints(e) for e in ins["elements"]])),
        "zero": lambda: _q(QM31.zero()),
        "one": lambda: _q(QM31.one()),
    }
    return table[op]() == out


def _secure_column(values):
    data = np.array(values, dtype=np.uint32).reshape(-1, 4).T.copy()
    return SecureColumnByCoords.from_device(to_torch_u32(data))


def _replay_secure_column(op, ins, out):
    if op == "set_and_at":
        col = _secure_column([[0, 0, 0, 0]] * (ins["index"] + 1))
        col.set(ins["index"], QM31.from_ints(ins["value"]))
        return _q(col.at(ins["index"])) == out
    if op in ("len", "is_empty"):
        col = _secure_column([[0, 0, 0, 0]] * ins["column_size"])
        return (len(col) if op == "len" else col.is_empty()) == out
    values = ins.get("column_values", ins.get("input_values"))
    col = _secure_column(values)
    return [_q(v) for v in col.to_vec()] == out


REPLAY = {"M31": _replay_m31, "CM31": _replay_cm31, "QM31": _replay_qm31,
          "SecureColumn": _replay_secure_column}


def test_vector_file_has_807_field_cases():
    assert sum(len(v) for (field, _), v in GROUPS.items()
               if field in ("M31", "CM31", "QM31")) == 807


@pytest.mark.parametrize("field,op", sorted(GROUPS))
def test_rust_vectors_replay_on_port_fields(field, op):
    for v in GROUPS[(field, op)]:
        assert REPLAY[field](op, v["inputs"], v["output"]), v


# ---------------------------------------------------------------------------
# tensor ops == JAX ops (tolerance 0)
# ---------------------------------------------------------------------------

EDGE = np.array([0, 1, P - 1], dtype=np.uint32)


def _operands(rng, lead, n=512):
    """Random canonical operands with every edge-value pairing appended."""
    a = rng.integers(0, P, size=(*lead, n), dtype=np.uint32)
    b = rng.integers(0, P, size=(*lead, n), dtype=np.uint32)
    ea = np.broadcast_to(np.repeat(EDGE, 3), (*lead, 9))
    eb = np.broadcast_to(np.tile(EDGE, 3), (*lead, 9))
    return (np.concatenate([a, ea], axis=-1),
            np.concatenate([b, eb], axis=-1))


def _port(fn, *xs):
    return to_numpy_u32(fn(*[to_torch_u32(x) for x in xs]))


def _jax(fn, *xs):
    return np.asarray(fn(*[jnp.asarray(x) for x in xs]))


@pytest.mark.parametrize("name", ["add", "sub", "mul", "square", "neg",
                                  "double", "inv"])
def test_m31_ops_match_jax(name):
    rng = np.random.default_rng(10)
    a, b = _operands(rng, ())
    unary = name in ("square", "neg", "double", "inv")
    args = (a,) if unary else (a, b)
    np.testing.assert_array_equal(_port(getattr(m31, name), *args),
                                  _jax(getattr(jax_m31, name), *args))


@pytest.mark.parametrize("name", ["add", "sub", "mul", "neg", "square",
                                  "conj", "inv"])
def test_cm31_ops_match_jax(name):
    rng = np.random.default_rng(11)
    a, b = _operands(rng, (2,))
    unary = name in ("neg", "square", "conj", "inv")
    args = (a,) if unary else (a, b)
    np.testing.assert_array_equal(_port(getattr(cm31, name), *args),
                                  _jax(getattr(jax_cm31, name), *args))


@pytest.mark.parametrize("name", ["add", "sub", "mul", "neg", "square",
                                  "conj", "inv", "mul_cm31"])
def test_qm31_ops_match_jax(name):
    rng = np.random.default_rng(12)
    a, b = _operands(rng, (4,))
    if name == "mul_cm31":
        args = (a, b[:2])
    elif name in ("add", "sub", "mul"):
        args = (a, b)
    else:
        args = (a,)
    np.testing.assert_array_equal(_port(getattr(qm31, name), *args),
                                  _jax(getattr(jax_qm31, name), *args))


def test_qm31_scalar_broadcast_matches_jax():
    q = QM31.from_ints([P - 1, 0, 1, 12345])
    rng = np.random.default_rng(13)
    a = rng.integers(0, P, size=(4, 64), dtype=np.uint32)
    got = to_numpy_u32(qm31.mul(to_torch_u32(a),
                                qm31.scalar(q, device="cpu")[:, None]))
    want = np.asarray(jax_qm31.mul(jnp.asarray(a), jax_qm31.scalar(q)[:, None]))
    np.testing.assert_array_equal(got, want)


def test_u32_converters_keep_bits():
    words = np.array([0, 1, P, 1 << 31, 0xFFFFFFFF, 0xDEADBEEF], np.uint32)
    t = to_torch_u32(words)
    assert t.dtype.is_signed and t.element_size() == 4
    np.testing.assert_array_equal(to_numpy_u32(t), words)
