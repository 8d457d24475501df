"""The source count of the Poseidon252 kernels' felt252 arithmetic.

`tstwo_tpu_torch/csrc/felt252.cuh` writes its Montgomery product and square
as primitives of one PTX instruction each; built for the host with
-DTSTWO_FELT_COUNT_OPS every primitive adds one to a counter.  This file
builds it so with g++, counts a product, a square and a Hades permutation,
and holds the counts against the constants `tests/torch_cuda_cases.py`
counts the Poseidon rows' `source_count` bound with (exact).  Skips where g++ is missing.

    python -m pytest tests/test_torch_felt252_source_count.py -n 0
"""
import ctypes
import shutil
import subprocess
from pathlib import Path

import pytest
import torch_cuda_cases as cases

ROOT = Path(__file__).resolve().parents[1]
HEADER_DIR = ROOT / "tstwo_tpu_torch" / "csrc"

WRAPPER = r"""
#include "felt252.cuh"

using tstwo::Felt;

static Felt some_felt(uint32_t seed) {
  Felt f;
  for (int w = 0; w < 8; ++w) f.w[w] = seed * 2654435761u + w;
  f.w[7] &= (1u << 27) - 1;
  return f;
}

// the instructions of one call: 0 a product, 1 a square, 2 a cube,
// 3 a Hades permutation (its products and squares; the modular adds are
// plain C++ and not counted)
extern "C" unsigned long long count_ops(int what, const uint32_t* consts) {
  const unsigned long long before = tstwo::felt_op_count;
  volatile uint32_t sink = 0;
  if (what == 0) {
    sink = tstwo::felt_mont_mul(some_felt(1), some_felt(2)).w[0];
  } else if (what == 1) {
    sink = tstwo::felt_mont_sqr(some_felt(3)).w[0];
  } else if (what == 2) {
    sink = tstwo::felt_cube(some_felt(4)).w[0];
  } else {
    Felt s[3] = {some_felt(5), some_felt(6), some_felt(7)};
    tstwo::hades_permute(s, consts);
    sink = s[0].w[0];
  }
  (void)sink;
  return tstwo::felt_op_count - before;
}
"""


@pytest.fixture(scope="module")
def count_ops(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    out = tmp_path_factory.mktemp("felt252_count")
    src = out / "felt252_count.cc"
    src.write_text(WRAPPER)
    so = out / "libfelt252_count.so"
    subprocess.run([gxx, "-O2", "-shared", "-fPIC", "-x", "c++",
                    "-DTSTWO_FELT_COUNT_OPS", f"-I{HEADER_DIR}", "-o", str(so),
                    str(src)], check=True)
    fn = ctypes.CDLL(str(so)).count_ops
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_ulonglong
    consts = (ctypes.c_uint32 * (8 * (91 * 3 + 2)))()
    return lambda what: fn(what, ctypes.addressof(consts))


@pytest.mark.parametrize("what,want", [
    (0, cases.FELT_MUL_SOURCE_OPS), (1, cases.FELT_SQR_SOURCE_OPS),
    (2, cases.FELT_MUL_SOURCE_OPS + cases.FELT_SQR_SOURCE_OPS)],
    ids=["product", "square", "cube"])
def test_felt_source_counts(count_ops, what, want):
    assert count_ops(what) == want


def test_hades_source_count(count_ops):
    """107 cubes a permutation, each a square and a product; the whole body
    within the design target of 64,000 instructions."""
    cube = cases.FELT_MUL_SOURCE_OPS + cases.FELT_SQR_SOURCE_OPS
    assert count_ops(3) == 107 * cube
    assert cases.HADES_SOURCE_OPS == \
        107 * cube + 91 * 12 * cases.FELT_ADD_SOURCE_OPS
    assert cases.HADES_SOURCE_OPS <= 64_000
    assert cases.HADES_OPS == 33_308
