"""Index permutation helpers shared across the stack (host side).

reference: packages/core/src/utils.ts
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np

from .tracing import count, counting, span


def bit_reverse_index(i: int, log_size: int) -> int:
    """Reverse the low `log_size` bits of i (reference utils.ts:15-22)."""
    if log_size == 0:
        return i
    return int(format(i, f"0{log_size}b")[::-1], 2)


def bit_reverse_permutation(log_size: int) -> np.ndarray:
    """perm[j] = bitrev(j); out = in[perm] converts natural <-> bit-reversed."""
    n = 1 << log_size
    idx = np.arange(n, dtype=np.int64)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(log_size):
        rev |= ((idx >> b) & 1) << (log_size - 1 - b)
    return rev


def bit_reverse_list(values: list) -> list:
    """Return values permuted into bit-reversed order."""
    n = len(values)
    if n & (n - 1):
        raise ValueError("length must be a power of two")
    log = n.bit_length() - 1
    perm = bit_reverse_permutation(log)
    return [values[int(p)] for p in perm]


def offset_bit_reversed_circle_domain_index(
    i: int, domain_log_size: int, eval_log_size: int, offset: int
) -> int:
    """reference utils.ts:109-126."""
    prev_index = bit_reverse_index(i, eval_log_size)
    half_size = 1 << (eval_log_size - 1)
    step_size = offset * (1 << (eval_log_size - domain_log_size - 1))
    if prev_index < half_size:
        prev_index = (prev_index + step_size) % half_size
    else:
        prev_index = (prev_index - step_size) % half_size + half_size
    return bit_reverse_index(prev_index, eval_log_size)


def previous_bit_reversed_circle_domain_index(
    i: int, domain_log_size: int, eval_log_size: int
) -> int:
    return offset_bit_reversed_circle_domain_index(i, domain_log_size, eval_log_size, -1)


def coset_index_to_circle_domain_index(coset_index: int, log_domain_size: int) -> int:
    """reference utils.ts:175-183."""
    if coset_index % 2 == 0:
        return coset_index // 2
    return ((2 << log_domain_size) - coset_index) >> 1


def circle_domain_index_to_coset_index(circle_index: int, log_domain_size: int) -> int:
    n = 1 << log_domain_size
    if circle_index < n // 2:
        return circle_index * 2
    return (n - 1 - circle_index) * 2 + 1


def to_torch_u32(arr, device="cpu"):
    """numpy uint32 array -> int32 tensor with the same bits, on `device`.

    M31 values (< 2^31) read the same either way; Blake2s words >= 2^31
    become negative int32 bit-views.

    The one public callable whose `device` defaults to the CPU: it is the
    numpy bridge (no JAX counterpart), computes nothing, and the port's
    own callers always name the device.  Every other callable that places
    host values on a device resolves `device=None` by `entry_device`."""
    import torch

    a = np.ascontiguousarray(np.asarray(arr, dtype=np.uint32))
    return upload(torch.from_numpy(a.view(np.int32).copy()), device)


_TRANSFER_COUNTERS = {"upload": ("upload_bytes", "uploads"),
                      "fetch": ("fetch_bytes", "fetches")}


def _count_transfer(kind: str, t, device) -> None:
    """Count a copy of tensor `t` between the host and `device`, `kind`
    "upload" or "fetch": its bytes and one call.  Nothing for the CPU, or
    with the counters off."""
    import torch

    if counting() and torch.device(device).type != "cpu":
        nbytes, calls = _TRANSFER_COUNTERS[kind]
        count(nbytes, t.numel() * t.element_size())
        count(calls, 1)


def upload(host, device, non_blocking: bool = False):
    """The host tensor `host` on `device`.  A copy to a device other than
    the CPU is an upload, counted in `upload_bytes` and `uploads`
    (`tracing.count`)."""
    _count_transfer("upload", host, device)
    return host.to(device, non_blocking=non_blocking)


def entry_device(device=None):
    """The device an entry point runs on, and where any public callable
    puts the data it makes from host values (`prove_*`, `generate_trace`,
    `CommitmentSchemeProver`, `load_prover_checkpoint`, the LogUp and GKR
    builders, the field and channel helpers): CUDA device 0 unless the
    caller names one; `device="cpu"` asks for the CPU.  Without a CUDA
    device the default raises: nothing steps down to the CPU on its own."""
    import torch

    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the entry points run on cuda:0 by default "
            "(torch.cuda.is_available() is false); pass device=\"cpu\" to "
            "run on the CPU")
    return torch.device("cuda", 0)


def mesh_device(mesh=None, device=None):
    """The device of an entry point given a `mesh` (parallel/): the mesh
    decides it, and a `device` that differs raises; without a mesh,
    `entry_device(device)`."""
    if mesh is None:
        return entry_device(device)
    import torch

    if device is not None and torch.device(device) != mesh.device:
        raise ValueError(f"the mesh runs on {mesh.device}, not {device}")
    return mesh.device


def to_host(x) -> np.ndarray:
    """A column on the host as numpy uint32: a tensor as it is, or an
    evaluation (CircleEvaluation, SecureEvaluation, LineEvaluation) whose
    `mesh` says it is point-sharded, gathered from every rank first (a
    collective: every rank calls it).  The counterpart of the JAX
    package's `utils.to_host`."""
    mesh = getattr(x, "mesh", None)
    values = getattr(x, "values", x)
    if mesh is not None:
        from .parallel.ops import gather_points

        values = gather_points(mesh, values)
    return to_numpy_u32(values)


def to_numpy_u32(t) -> np.ndarray:
    """int32 tensor (any device) -> numpy uint32 array with the same bits.
    Runs under a `fetch` span: from a device, its host time is the wait
    for the stream to drain and the copy, counted in `fetch_bytes` and
    `fetches`."""
    with span("fetch"):
        _count_transfer("fetch", t, t.device)
        return t.detach().cpu().contiguous().numpy().view(np.uint32)


def to_host_list(t) -> list:
    """`t.tolist()` under a `fetch` span, counted as `to_numpy_u32` counts
    a read from a device."""
    with span("fetch"):
        _count_transfer("fetch", t, t.device)
        return t.tolist()


def as_int32_bits(x):
    """int64 tensor of values in [0, 2^32) -> int32 with the same low 32
    bits."""
    import torch

    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)
