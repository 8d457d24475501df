"""The felt252 arithmetic of the Poseidon252 kernels, compiled for the host.

`tstwo_tpu_torch/csrc/felt252.cuh` compiles with g++ as well as with nvcc
(device-only code sits behind `__CUDA_ARCH__` beside a portable twin).  This
file builds it with `g++ -O2 -shared -fPIC -x c++` and a small `extern "C"`
wrapper into a temporary directory, calls it through ctypes, and holds every
function against Python integers, exactly (tolerance 0): the Montgomery
product and square (R = 2^256), the cube, the modular add and subtract, the
packing of eight M31 values, and the Hades permutation against the JAX
package's host Hades (`tstwo_tpu/channel/poseidon.py`, pinned to stwo) and
the port's copy of it.  Skips where g++ is missing.

    python -m pytest tests/test_torch_felt252_host.py -n 0
"""
import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

from tstwo_tpu.channel.poseidon import hades_permutation as jax_host_hades
from tstwo_tpu_torch.channel.poseidon import _ARK
from tstwo_tpu_torch.channel.poseidon import hades_permutation as port_hades

HEADER_DIR = Path(__file__).resolve().parents[1] / "tstwo_tpu_torch" / "csrc"
P252 = (1 << 251) + 17 * (1 << 192) + 1
R = 1 << 256
R_INV = pow(R, -1, P252)
U32 = (1 << 32) - 1

# Felts that stress the carries and the reduction: the ends of the field,
# the words of p, runs of set words, and their neighbours.
FELT_EDGE = [0, 1, 2, P252 - 1, P252 - 2, 1 << 251, (1 << 251) - 1,
             17 << 192, (1 << 192) - 1, (1 << 224) - 1,
             ((1 << 251) - 1) - (17 << 192), (1 << 32) - 1]

# The wrapper: batches of felts as [n, 8] words.  A header without a
# dedicated square gets one from the product (a non-template function of the
# header wins over this template in overload resolution).
WRAPPER = r"""
#include "felt252.cuh"

namespace tstwo {
template <int = 0>
Felt felt_mont_sqr(const Felt& a) { return felt_mont_mul(a, a); }
}  // namespace tstwo

using tstwo::Felt;

static void store(const Felt& f, uint32_t* out) {
  for (int w = 0; w < 8; ++w) out[w] = f.w[w];
}

// op 0: a * b / R, 1: a + b, 2: a - b (mod p)
extern "C" void felt_binary(int op, const uint32_t* a, const uint32_t* b,
                            uint32_t* out, long n) {
  for (long i = 0; i < n; ++i) {
    const Felt x = tstwo::felt_load(a + 8 * i), y = tstwo::felt_load(b + 8 * i);
    store(op == 0 ? tstwo::felt_mont_mul(x, y)
          : op == 1 ? tstwo::felt_add(x, y) : tstwo::felt_sub(x, y), out + 8 * i);
  }
}

// op 0: a^2 / R, 1: the Montgomery cube a^3 / R^2 (mod p)
extern "C" void felt_unary(int op, const uint32_t* a, uint32_t* out, long n) {
  for (long i = 0; i < n; ++i) {
    const Felt x = tstwo::felt_load(a + 8 * i);
    store(op == 0 ? tstwo::felt_mont_sqr(x) : tstwo::felt_cube(x), out + 8 * i);
  }
}

extern "C" void felt_pack(const uint32_t* v, uint32_t* out, long n) {
  for (long i = 0; i < n; ++i) store(tstwo::felt_pack_m31(v + 8 * i), out + 8 * i);
}

// states: [n, 3, 8] in Montgomery form, permuted in place
extern "C" void felt_hades(uint32_t* states, const uint32_t* consts, long n) {
  for (long i = 0; i < n; ++i) {
    Felt s[3];
    for (int k = 0; k < 3; ++k) s[k] = tstwo::felt_load(states + 24 * i + 8 * k);
    tstwo::hades_permute(s, consts);
    for (int k = 0; k < 3; ++k) store(s[k], states + 24 * i + 8 * k);
  }
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    out = tmp_path_factory.mktemp("felt252")
    src = out / "felt252_host.cc"
    src.write_text(WRAPPER)
    so = out / "libfelt252_host.so"
    subprocess.run([gxx, "-O2", "-shared", "-fPIC", "-x", "c++",
                    f"-I{HEADER_DIR}", "-o", str(so), str(src)], check=True)
    handle = ctypes.CDLL(str(so))
    ptr, long_ = ctypes.c_void_p, ctypes.c_long
    handle.felt_binary.argtypes = [ctypes.c_int, ptr, ptr, ptr, long_]
    handle.felt_unary.argtypes = [ctypes.c_int, ptr, ptr, long_]
    handle.felt_pack.argtypes = [ptr, ptr, long_]
    handle.felt_hades.argtypes = [ptr, ptr, long_]
    return handle


def _words(vals):
    return np.array([[(v >> (32 * w)) & U32 for w in range(8)] for v in vals],
                    dtype=np.uint32).reshape(len(vals), 8)


def _ints(words):
    return [sum(int(row[w]) << (32 * w) for w in range(8)) for row in words]


def _binary(lib, op, a, b):
    x, y = _words(a), _words(b)
    out = np.zeros_like(x)
    lib.felt_binary(op, x.ctypes.data, y.ctypes.data, out.ctypes.data, len(a))
    return _ints(out)


def _unary(lib, op, a):
    x = _words(a)
    out = np.zeros_like(x)
    lib.felt_unary(op, x.ctypes.data, out.ctypes.data, len(a))
    return _ints(out)


def _random_felts(seed, n):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(32), "little") % P252 for _ in range(n)]


def _redc_overflows(t):
    """Whether (t + m p) / R, m = -t / p mod R, lies in [p, 2p): the case the
    product's final subtraction exists for."""
    m = (-t * pow(P252, -1, R)) % R
    return (t + m * P252) // R >= P252


def _overflowing_pairs(n, square=False):
    """n seeded pairs (a, b) near p whose Montgomery product reaches [p, 2p)
    before the final subtraction (about one pair in 32 does)."""
    rng = np.random.default_rng(7 if square else 8)
    pairs = []
    while len(pairs) < n:
        a = P252 - 1 - int(rng.integers(0, 1 << 62)) * int(rng.integers(1, 1 << 62))
        b = a if square else \
            P252 - 1 - int(rng.integers(0, 1 << 62)) * int(rng.integers(1, 1 << 62))
        if _redc_overflows(a * b):
            pairs.append((a, b))
    return pairs


def test_the_edge_list_stresses_what_it_should():
    assert all(0 <= v < P252 for v in FELT_EDGE)
    assert len(_overflowing_pairs(4)) == 4
    assert len(_overflowing_pairs(4, square=True)) == 4


@pytest.mark.parametrize("a", FELT_EDGE, ids=hex)
def test_mont_mul_on_edge_pairs(lib, a):
    got = _binary(lib, 0, [a] * len(FELT_EDGE), FELT_EDGE)
    assert got == [a * b * R_INV % P252 for b in FELT_EDGE]


@pytest.mark.parametrize("seed", range(4))
def test_mont_mul_on_random_pairs(lib, seed):
    a, b = _random_felts(2 * seed, 1000), _random_felts(2 * seed + 1, 1000)
    assert _binary(lib, 0, a, b) == [x * y * R_INV % P252 for x, y in zip(a, b)]


@pytest.mark.parametrize("square", [False, True])
def test_mont_mul_when_the_sum_reaches_p_before_the_subtraction(lib, square):
    pairs = _overflowing_pairs(64, square)
    a, b = [x for x, _ in pairs], [y for _, y in pairs]
    assert _binary(lib, 0, a, b) == [x * y * R_INV % P252 for x, y in pairs]
    if square:
        assert _unary(lib, 0, a) == [x * x * R_INV % P252 for x in a]


def test_mont_sqr_on_edge_felts(lib):
    assert _unary(lib, 0, FELT_EDGE) == [a * a * R_INV % P252 for a in FELT_EDGE]


@pytest.mark.parametrize("seed", range(4))
def test_mont_sqr_on_random_felts(lib, seed):
    a = _random_felts(100 + seed, 1000)
    assert _unary(lib, 0, a) == [x * x * R_INV % P252 for x in a]


@pytest.mark.parametrize("seed", [None, 0, 1])
def test_cube(lib, seed):
    """felt_cube(a) = a^3 / R^2: the cube of a Montgomery-form value."""
    a = FELT_EDGE if seed is None else _random_felts(200 + seed, 500)
    assert _unary(lib, 1, a) == [pow(x, 3, P252) * R_INV * R_INV % P252
                                 for x in a]


@pytest.mark.parametrize("op", [1, 2], ids=["add", "sub"])
@pytest.mark.parametrize("seed", [None, 0])
def test_add_and_sub(lib, op, seed):
    if seed is None:
        a = [x for x in FELT_EDGE for _ in FELT_EDGE]
        b = FELT_EDGE * len(FELT_EDGE)
    else:
        a, b = _random_felts(300 + seed, 1000), _random_felts(400 + seed, 1000)
    want = [(x + y if op == 1 else x - y) % P252 for x, y in zip(a, b)]
    assert _binary(lib, op, a, b) == want


@pytest.mark.parametrize("seed", range(2))
def test_pack_m31(lib, seed):
    """Eight values below 2^31, the first highest, 31 bits each."""
    p31 = (1 << 31) - 1
    rng = np.random.default_rng(500 + seed)
    v = rng.integers(0, p31, size=(1000, 8), dtype=np.uint64).astype(np.uint32)
    v[:4] = [[p31 - 1] * 8, [0] * 8, [1] * 8, [p31 - 1, 0] * 4]
    out = np.zeros_like(v)
    lib.felt_pack(v.ctypes.data, out.ctypes.data, len(v))
    want = [sum(int(x) << (31 * (7 - j)) for j, x in enumerate(row)) for row in v]
    assert _ints(out) == want


def _hades(lib, states):
    consts = _words([c * R % P252 for row in _ARK for c in row]
                    + [R * R % P252, R % P252])
    words = _words([v * R % P252 for s in states for v in s]).reshape(-1, 3, 8)
    words = np.ascontiguousarray(words)
    lib.felt_hades(words.ctypes.data, consts.ctypes.data, len(states))
    flat = [v * R_INV % P252 for v in _ints(words.reshape(-1, 8))]
    return [flat[3 * i:3 * i + 3] for i in range(len(states))]


@pytest.mark.parametrize("position", range(3))
def test_hades_with_edge_felts_in_every_position(lib, position):
    """Each edge felt at `position`, the other two words random or edge."""
    others = _random_felts(600 + position, 2 * len(FELT_EDGE))
    states = []
    for i, v in enumerate(FELT_EDGE):
        s = [others[2 * i], others[2 * i + 1]]
        s.insert(position, v)
        states.append(s)
        states.append([v if k == position else FELT_EDGE[-1 - i] for k in range(3)])
    got = _hades(lib, states)
    assert got == [jax_host_hades(s) for s in states]
    assert got == [port_hades(s) for s in states]


@pytest.mark.parametrize("seed", range(2))
def test_hades_on_random_states(lib, seed):
    flat = _random_felts(700 + seed, 3 * 16)
    states = [flat[3 * i:3 * i + 3] for i in range(16)]
    got = _hades(lib, states)
    assert got == [jax_host_hades(s) for s in states]
    assert got == [port_hades(s) for s in states]
