"""The transcript kernel's body, compiled for the host.

`tstwo_tpu_torch/csrc/blake2s.cuh` compiles with g++ as well as with nvcc
(a rotation is a funnel shift only behind `__CUDA_ARCH__`).  This file
builds its `transcript_step` -- the whole body of `blake2s_transcript_kernel`
-- with g++ and a small `extern "C"` wrapper into a temporary directory,
calls it through ctypes, and holds it exactly (tolerance 0) against the
host channel and hashlib and against the kernel's plain PyTorch version
(`ops.blake2s.transcript_plain`): mixes of one or more blocks and of any
byte length, words a stride apart, draws from 64-bit counts, and the
rejecting state (zero digest, n_sent 238,210,102).  Skips where g++ is
missing.

    python -m pytest tests/test_torch_blake2s_transcript_host.py -n 0
"""
import ctypes
import hashlib
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

from tstwo_tpu_torch.ops import blake2s as b2
from tstwo_tpu_torch.utils import to_numpy_u32, to_torch_u32

HEADER_DIR = Path(__file__).resolve().parents[1] / "tstwo_tpu_torch" / "csrc"
P = (1 << 31) - 1
MASK = (1 << 32) - 1

WRAPPER = r"""
#include "blake2s.cuh"

extern "C" void step(const uint32_t* digest, const uint32_t* n_sent,
                     const uint32_t* msg, long long stride, long long msg_bytes,
                     uint32_t* digest_out, uint32_t* n_sent_out,
                     uint32_t* draws, int k) {
  tstwo::transcript_step(digest, n_sent, msg, stride, msg_bytes, digest_out,
                         n_sent_out, draws, k);
}
"""


@pytest.fixture(scope="module")
def step(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    out = tmp_path_factory.mktemp("transcript")
    src, lib = out / "wrapper.cpp", out / "libtranscript.so"
    src.write_text(WRAPPER)
    subprocess.run([gxx, "-O2", "-std=c++17", "-shared", "-fPIC",
                    f"-I{HEADER_DIR}", "-o", str(lib), str(src)], check=True,
                   capture_output=True)
    fn = ctypes.CDLL(str(lib)).step
    ptr = ctypes.c_void_p
    fn.argtypes = [ptr, ptr, ptr, ctypes.c_longlong, ctypes.c_longlong, ptr,
                   ptr, ptr, ctypes.c_int]
    fn.restype = None

    def call(digest, n_sent, msg, stride, msg_bytes, k, aliased=False):
        d = np.ascontiguousarray(digest, dtype=np.uint32)
        ns = np.array([n_sent & MASK, n_sent >> 32], dtype=np.uint32)
        m = None if msg is None else np.ascontiguousarray(msg, np.uint32)
        d_out = d if aliased else np.zeros(8, np.uint32)
        ns_out = ns if aliased else np.zeros(2, np.uint32)
        draws = np.zeros(max(k, 1) * 8, np.uint32)
        fn(d.ctypes.data, ns.ctypes.data,
           None if m is None else m.ctypes.data, stride, msg_bytes,
           d_out.ctypes.data, ns_out.ctypes.data, draws.ctypes.data, k)
        return (d_out.tolist(), int(ns_out[0]) | int(ns_out[1]) << 32,
                draws[:8 * k].reshape(k, 8).tolist())

    return call


def _host(digest_words, n_sent, msg_bytes_value, k):
    """The host channel's semantics in hashlib: a mix of the given bytes
    (None: no mix), then k whole-hash-rejected draws."""
    digest = np.asarray(digest_words, np.uint32).tobytes()
    if msg_bytes_value is not None:
        digest = hashlib.blake2s(digest + msg_bytes_value).digest()
        n_sent = 0
    draws = []
    for _ in range(k):
        while True:
            h = np.frombuffer(hashlib.blake2s(
                digest + n_sent.to_bytes(8, "little") + bytes(24)).digest(),
                "<u4").astype(np.int64)
            n_sent += 1
            if (h < 2 * P).all():
                break
        draws.append(np.where(h >= P, h - P, h).tolist())
    return np.frombuffer(digest, "<u4").tolist(), n_sent, draws


def _plain(digest_words, n_sent, msg, msg_bytes, k):
    d, ns, draws = b2.transcript_plain(
        to_torch_u32(np.asarray(digest_words, np.uint32)),
        to_torch_u32(np.array([n_sent & MASK, n_sent >> 32], np.uint32)),
        None if msg is None else to_torch_u32(msg), msg_bytes, k)
    lo, hi = to_numpy_u32(ns).tolist()
    return (to_numpy_u32(d).tolist(), lo | hi << 32,
            to_numpy_u32(draws).tolist())


@pytest.mark.parametrize("msg_bytes", [0, 1, 3, 8, 16, 31, 32, 33, 40, 64,
                                       95, 96, 97, 160])
@pytest.mark.parametrize("k", [0, 1, 3])
def test_mix_then_draws_match_the_host_channel_and_plain(step, msg_bytes, k):
    rng = np.random.default_rng(1000 * k + msg_bytes)
    digest = rng.integers(0, 1 << 32, size=8, dtype=np.uint64).astype(
        np.uint32)
    words = rng.integers(0, 1 << 32, size=-(-msg_bytes // 4) + 1,
                         dtype=np.uint64).astype(np.uint32)
    want = _host(digest, 0, words.tobytes()[:msg_bytes], k)
    assert step(digest, 12345, words, 1, msg_bytes, k) == tuple(want)
    assert _plain(digest, 12345, words, msg_bytes, k) == tuple(want)


@pytest.mark.parametrize("n_sent", [0, 5, (1 << 32) - 1, (1 << 32) + 7,
                                    (1 << 63) + 11])
@pytest.mark.parametrize("k", [1, 2, 5])
def test_draws_from_any_64_bit_count(step, n_sent, k):
    rng = np.random.default_rng(n_sent % 1000 + k)
    digest = rng.integers(0, 1 << 32, size=8, dtype=np.uint64).astype(
        np.uint32)
    want = _host(digest, n_sent, None, k)
    assert step(digest, n_sent, None, 1, -1, k) == tuple(want)
    assert _plain(digest, n_sent, None, None, k) == tuple(want)


@pytest.mark.parametrize("k", [1, 2])
def test_the_rejecting_state(step, k):
    """Zero digest, n_sent 238,210,102: that draw's word 3 is 0xFFFFFFFE
    >= 2P, so the first draw is the hash at 238,210,103."""
    zero = np.zeros(8, np.uint32)
    first = np.frombuffer(hashlib.blake2s(
        bytes(32) + (238_210_102).to_bytes(8, "little") + bytes(24)).digest(),
        "<u4")
    assert first[3] == 0xFFFFFFFE
    got = step(zero, 238_210_102, None, 1, -1, k)
    want = _host(zero, 238_210_102, None, k)
    assert got == tuple(want) == _plain(zero, 238_210_102, None, None, k)
    assert got[1] == 238_210_102 + 1 + k


def test_words_a_stride_apart_and_outputs_over_inputs(step):
    """A Merkle root read in place from its layer (stride 3), and the
    state written over itself."""
    rng = np.random.default_rng(7)
    digest = rng.integers(0, 1 << 32, size=8, dtype=np.uint64).astype(
        np.uint32)
    layer = rng.integers(0, 1 << 32, size=(8, 3), dtype=np.uint64).astype(
        np.uint32)
    root = layer[:, 0].copy()
    want = _host(digest, 0, root.tobytes(), 2)
    assert step(digest, 99, layer.reshape(-1), 3, 32, 2) == tuple(want)
    assert step(digest, 99, root, 1, 32, 2, aliased=True) == tuple(want)
