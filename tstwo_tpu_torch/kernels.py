"""Build, load and launch the hand-written CUDA kernels in csrc/.

The sources compile with nvcc into one shared library with a plain C
interface, bound with ctypes.  The build happens at the first CUDA call,
into build/tstwo_tpu_torch/<hash of sources and flags>/ beside the
package, so a fresh checkout builds everything on first use and a later
process reuses the library.  Importing this module needs neither CUDA nor
nvcc.

Each kernel counts its launches in `LAUNCHES`: the wrappers in ops/fft.py
(forward and inverse CFFT apart), ops/blake2s.py and ops/fri_ops.py add
one per call of the C entry point, and nowhere else.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("cfft.cu", "blake2s.cu", "deinterleave.cu")
HEADERS = ("m31.cuh",)
BUILD_ROOT = Path(__file__).resolve().parent.parent / "build" / "tstwo_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
LIB_NAME = "libtstwo_kernels.so"

_VP = ctypes.c_void_p
_SIGNATURES = {
    # src, dst, twiddles, batch, log_n, inverse, stream
    "tstwo_cfft": (_VP, _VP, _VP, ctypes.c_int, ctypes.c_int, ctypes.c_int, _VP),
    # words, out, n_blocks, n, byte_len, stream
    "tstwo_blake2s": (_VP, _VP, ctypes.c_int, ctypes.c_longlong,
                      ctypes.c_longlong, _VP),
    # src, even, odd, pairs, stream
    "tstwo_deinterleave": (_VP, _VP, _VP, ctypes.c_longlong, _VP),
}

LAUNCHES = {"cfft_forward": 0, "cfft_inverse": 0, "blake2s": 0,
            "deinterleave": 0}

_lib = None
BUILD_INFO: dict = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                           "(set CUDA_HOME or put nvcc on PATH)")
    return found


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile csrc/ into the shared library unless it exists; its path."""
    out_dir = BUILD_ROOT / _source_hash()
    lib_path = out_dir / LIB_NAME
    if lib_path.is_file():
        BUILD_INFO.update(path=str(lib_path), seconds=0.0, cached=True)
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"{LIB_NAME}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp),
           *(str(CSRC / s) for s in SOURCES)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, lib_path)
    BUILD_INFO.update(path=str(lib_path), seconds=time.perf_counter() - t0,
                      cached=False, ptxas=res.stderr)
    return lib_path


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available: the kernels need a GPU")
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _lib = handle
    return _lib


def launch(entry: str, counter: str, device: torch.device, *args) -> None:
    """Call the C entry point tstwo_<entry> on `device`'s current stream,
    raise if a launch failed, and count one launch under `counter`."""
    fn = getattr(lib(), "tstwo_" + entry)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {err}")
    LAUNCHES[counter] += 1


def check_cuda_tensor(t: torch.Tensor, name: str, dtype=torch.int32) -> None:
    """Wrapper-side validation before a pointer crosses into C."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor")
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def on_cuda(t: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one; any other device raises.
    The wrappers launch their kernel for CUDA and take the plain PyTorch
    version only for CPU tensors."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}")
