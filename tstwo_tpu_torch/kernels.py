"""Build, load and launch the hand-written CUDA kernels in csrc/.

The sources compile with nvcc, one process per source in parallel, and
link into one shared library with a plain C interface, bound with ctypes.
The build happens at the first CUDA call, into
build/tstwo_tpu_torch/<hash of sources and flags>/ beside the package, so
a fresh checkout builds everything on first use and a later process
reuses the library.  Importing this module needs neither CUDA nor nvcc.

Each kernel counts its launches in `LAUNCHES`: the wrappers in ops/fft.py
(forward and inverse CFFT apart), ops/blake2s.py (a layer of messages
without children as `blake2s`, a Merkle layer that reads its child pairs
as `merkle_layer`, the one-block top of a tree as `merkle_tail`, a batch
of proof-of-work nonces as `blake2s_grind`, a Fiat-Shamir transcript step
as `blake2s_transcript`),
ops/fri_ops.py, ops/m31_kernels.py, ops/poseidon252.py (the Hades
permutation of a batch as `hades_permutation`, a Poseidon252 Merkle layer
as `poseidon_merkle_layer`, a batch of a Poseidon252 channel's
proof-of-work nonces as `poseidon_grind`), ops/constraint_eval.py (a
component's constraint program over its evaluation domain as
`constraint_eval`) and
pcs/quotients.py (the DEEP quotients of a group of columns of one size as
`accumulate_quotients`) and lookups/gkr_kernels.py (a GKR oracle's two
round sums as `gkr_round_sums`, an MLE's fold as `mle_fold`) add one per
call of the C entry point, and nowhere else.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple, Sequence

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("cfft.cu", "cfft_forward.cu", "blake2s.cu", "deinterleave.cu",
           "m31_kernels.cu", "poseidon252.cu", "constraint_eval.cu",
           "quotients.cu", "gkr.cu")
HEADERS = ("m31.cuh", "cfft_pass.cuh", "segments.cuh", "felt252.cuh",
           "blake2s.cuh")
BUILD_ROOT = Path(__file__).resolve().parent.parent / "build" / "tstwo_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")
LIB_NAME = "libtstwo_kernels.so"

_VP = ctypes.c_void_p
_SIGNATURES = {
    # src, dst, twiddles, batch, log_n, log_m, inverse, scale, stream
    "tstwo_cfft": (_VP, _VP, _VP, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_uint, _VP),
    # prev, seg_ptrs, seg_strides, seg_rows, n_segs, out, n, byte_len, stream
    "tstwo_blake2s_layer": (_VP, _VP, _VP, _VP, ctypes.c_int, _VP,
                            ctypes.c_longlong, ctypes.c_longlong, _VP),
    # prev, out, log, stream
    "tstwo_merkle_tail": (_VP, _VP, ctypes.c_int, _VP),
    # digest (8 host words), start, count, pow_bits, best, stream
    "tstwo_blake2s_grind": (_VP, ctypes.c_ulonglong, ctypes.c_longlong,
                            ctypes.c_int, _VP, _VP),
    # digest_in, n_sent_in, msg, msg_stride, msg_bytes, digest_out,
    # n_sent_out, draws, k, stream
    "tstwo_blake2s_transcript": (_VP, _VP, _VP, ctypes.c_longlong,
                                 ctypes.c_longlong, _VP, _VP, _VP,
                                 ctypes.c_int, _VP),
    # src, even, odd, pairs, stream
    "tstwo_deinterleave": (_VP, _VP, _VP, ctypes.c_longlong, _VP),
    # a, b, out, n, stream
    "tstwo_m31_mul": (_VP, _VP, _VP, ctypes.c_longlong, _VP),
    # a, b, out, n, reps, stream
    "tstwo_m31_mul_chain": (_VP, _VP, _VP, ctypes.c_longlong, ctypes.c_int,
                            _VP),
    # in, out, n, stream
    "tstwo_hades_permutation": (_VP, _VP, ctypes.c_longlong, _VP),
    # prev, seg_ptrs, seg_strides, seg_rows, n_segs, out, n, stream
    "tstwo_poseidon_merkle_layer": (_VP, _VP, _VP, _VP, ctypes.c_int, _VP,
                                    ctypes.c_longlong, _VP),
    # digest (8 host words), start, count, pow_bits, best, stream
    "tstwo_poseidon_grind": (_VP, ctypes.c_ulonglong, ctypes.c_longlong,
                             ctypes.c_int, _VP, _VP),
    # program, n_instr, loads, n_loads, scalars, n_scalars, denom_off,
    # ptrs, strides, acc, log_n, trace_log, n_slots, rows_per_thread, stream
    "tstwo_constraint_eval": (_VP, ctypes.c_int, _VP, ctypes.c_int, _VP,
                              ctypes.c_int, ctypes.c_int, _VP, _VP, _VP,
                              ctypes.c_int, ctypes.c_int, ctypes.c_int,
                              ctypes.c_int, _VP),
    # table, n_cols, n_batches, n_entries, points (host words), log_n,
    # row0, n_rows, out, stream
    "tstwo_accumulate_quotients": (_VP, ctypes.c_int, ctypes.c_int,
                                   ctypes.c_int, _VP, ctypes.c_int,
                                   ctypes.c_longlong, ctypes.c_longlong, _VP,
                                   _VP),
    # kind, eq, eq_stride, a, a_stride, b, b_stride, n_terms, lambda (4
    # words), out, stream
    "tstwo_gkr_round_sums": (ctypes.c_int, _VP, ctypes.c_longlong, _VP,
                             ctypes.c_longlong, _VP, ctypes.c_longlong,
                             ctypes.c_longlong, *(ctypes.c_uint,) * 4, _VP,
                             _VP),
    # src, stride, half, base, c (4 words), out, stream
    "tstwo_mle_fold": (_VP, ctypes.c_longlong, ctypes.c_longlong,
                       ctypes.c_int, *(ctypes.c_uint,) * 4, _VP, _VP),
}

# entry points that launch nothing: (argument types, result type)
_QUERIES = {
    # batch, log_n, inverse, out (6 ints a pass) -> number of passes
    "tstwo_cfft_describe": ((ctypes.c_int, ctypes.c_int, ctypes.c_int,
                             ctypes.POINTER(ctypes.c_int)), ctypes.c_int),
    "tstwo_cfft_kernel_launches": ((), ctypes.c_longlong),
    # consts (host words), n_words -> cudaError_t of the copy to the
    # current device
    "tstwo_poseidon_set_constants": ((_VP, ctypes.c_int), ctypes.c_int),
    # n_instr, n_loads, n_scalars, n_slots, rows_per_thread, out (rows,
    # chunk) -> cudaError_t
    "tstwo_constraint_eval_shape": ((ctypes.c_int, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                     ctypes.POINTER(ctypes.c_int)),
                                    ctypes.c_int),
}

LAUNCHES = {"cfft_forward": 0, "cfft_inverse": 0, "blake2s": 0,
            "merkle_layer": 0, "merkle_tail": 0, "blake2s_grind": 0,
            "blake2s_transcript": 0, "deinterleave": 0,
            "m31_mul": 0, "m31_mul_chain": 0, "hades_permutation": 0,
            "poseidon_merkle_layer": 0, "poseidon_grind": 0,
            "constraint_eval": 0,
            "accumulate_quotients": 0, "gkr_round_sums": 0, "mle_fold": 0}

_lib = None
_entries: dict = {}  # entry name -> bound C function, filled by lib()
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
    """Compile csrc/ into the shared library unless it exists; its path.

    One nvcc per source, all started together, then one link.  If one
    fails, the others are killed; no object file outlives the call."""
    out_dir = BUILD_ROOT / _source_hash()
    lib_path = out_dir / LIB_NAME
    if lib_path.is_file():
        BUILD_INFO.update(path=str(lib_path), seconds=0.0, cached=True)
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc, pid = _nvcc(), os.getpid()
    objs = [out_dir / f"{Path(s).stem}.{pid}.o" for s in SOURCES]
    tmp = out_dir / f"{LIB_NAME}.{pid}.tmp"
    t0 = time.perf_counter()
    procs, logs = [], []
    try:
        for src, obj in zip(SOURCES, objs):
            procs.append(subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", str(obj),
                 str(CSRC / src)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        for src, proc in zip(SOURCES, procs):
            _, err = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src} ({proc.returncode}):"
                                   f"\n{err}")
            logs.append(err)
        res = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                             capture_output=True, text=True, check=False)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                               f"{res.stderr}")
        os.replace(tmp, lib_path)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
            proc.communicate()
        for path in (*objs, tmp):
            path.unlink(missing_ok=True)
    BUILD_INFO.update(path=str(lib_path), seconds=time.perf_counter() - t0,
                      cached=False, ptxas="".join(logs))
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
            _entries[name.removeprefix("tstwo_")] = fn
        for name, (argtypes, restype) in _QUERIES.items():
            fn = getattr(handle, name)
            fn.argtypes = list(argtypes)
            fn.restype = restype
            _entries[name.removeprefix("tstwo_")] = fn
        _lib = handle
    return _lib


def entry(name: str):
    """The bound C function tstwo_<name> (the library is built on first
    use)."""
    if name not in _entries:
        lib()
    return _entries[name]


def _current_stream(index: int) -> int:
    """The raw handle of PyTorch's current stream on device `index`."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:  # no Stream object is built on the way
        return raw(index)
    return torch.cuda.current_stream(index).cuda_stream


def launch(entry: str, counter: str, device: torch.device, *args) -> None:
    """Call the C entry point tstwo_<entry> on `device`'s current stream,
    raise if a launch failed, and count one launch under `counter`.

    A launch is host work of a few microseconds around kernels that often
    take less, so the function is looked up once (`lib()`), and the device
    is switched only when it is not the current one."""
    fn = _entries.get(entry)
    if fn is None:
        lib()
        fn = _entries[entry]
    current = torch.cuda.current_device()
    index = current if device.index is None else device.index
    if index == current:
        err = fn(*args, _current_stream(index))
    else:
        with torch.cuda.device(index):
            err = fn(*args, _current_stream(index))
    if err != 0:
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {err}")
    LAUNCHES[counter] += 1


def check_cuda_tensor(t: torch.Tensor, name: str, dtype=torch.int32,
                      contiguous: bool = True) -> None:
    """Wrapper-side validation before a pointer crosses into C."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor")
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def is_cuda(device: torch.device) -> bool:
    """True for a CUDA device, False for the CPU; any other device raises.
    The wrappers launch their kernel for CUDA and take the plain PyTorch
    version only for CPU tensors."""
    if device.type == "cuda":
        return True
    if device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {device}")


def on_cuda(t: torch.Tensor) -> bool:
    """`is_cuda` of the device a tensor lies on."""
    return is_cuda(t.device)


MAX_SEGMENTS = 16  # csrc/segments.cuh: kMaxSegments
_SegPtrs = ctypes.c_void_p * MAX_SEGMENTS
_SegStrides = ctypes.c_longlong * MAX_SEGMENTS
_SegRows = ctypes.c_int * MAX_SEGMENTS


class SegmentTable(NamedTuple):
    """Column rows for a Merkle layer kernel to read where they lie."""

    segments: list  # the [C, n] tensors behind the pointers, kept alive
    rows: int       # the rows of all segments together
    args: tuple     # seg_ptrs, seg_strides, seg_rows, n_segs of a C entry


def segment_table(entries: Sequence[torch.Tensor], n: int,
                  device: torch.device) -> SegmentTable:
    """The by-value segment table of csrc/segments.cuh for `entries`, each
    [n] or [C, n] int32 on `device`, in order.  Rows that lie a stride
    apart are taken as they are; more than MAX_SEGMENTS entries are
    concatenated into one."""
    segs = []
    for c in entries:
        if c.ndim == 1:
            c = c[None, :]
        if c.ndim != 2 or c.shape[1] != n:
            raise ValueError(f"column entry: expected [{n}] or [C, {n}], got "
                             f"{tuple(c.shape)}")
        if c.device != device or c.dtype != torch.int32:
            raise TypeError(f"column entry: expected int32 on {device}, got "
                            f"{c.dtype} on {c.device}")
        if n > 1 and c.stride(1) != 1:
            c = c.contiguous()
        if c.shape[0]:
            segs.append(c)
    if len(segs) > MAX_SEGMENTS:
        segs = [torch.cat(segs, dim=0)]
    args = (_SegPtrs(*[c.data_ptr() for c in segs]),
            _SegStrides(*[c.stride(0) for c in segs]),
            _SegRows(*[c.shape[0] for c in segs]), len(segs)
            ) if segs else (None, None, None, 0)
    return SegmentTable(segs, sum(c.shape[0] for c in segs), args)
