"""Constraint programs over the evaluation domain: the instruction set, the
plain PyTorch executor and the launch of csrc/constraint_eval.cu.

A constraint program (constraint_framework/program.py lowers one from an
AIR's `evaluate`) is straight-line register code, int32 [I, 4], one
instruction a row:

    w0 = opcode | aux << 8   (aux: a signed 24-bit mask offset, or flags)
    w1 = destination slot, w2 = a, w3 = b

A slot holds one M31 value of every row; a secure (QM31) value takes four
consecutive slots, one a coordinate.  `scalars` (int32, one upload a
proof) holds the words the program reads by offset: the constraints'
random coefficients, the per-proof secure parameters, the LogUp cumsum
shift, the program's QM31 constants, and at `denom_off` the 2^(eval -
trace) vanishing-denominator inverses, `denom[row >> trace_log]` for row
`row` of the bit-reversed evaluation domain.  The program evaluates
sum_k constraint_k * coefficient_k on every row, multiplies it by the row's
denominator inverse and adds it into the accumulator [4, n].

The kernel also reads the program's load table (`load_table`): one row
(interaction, column, offset, 0) a LOAD, in program order, from which it
starts each column read ahead of the instruction that stores it.

`evaluate` launches the kernel for CUDA tensors (`evaluate_cuda`, in place)
and runs the plain version for CPU tensors (`evaluate_plain`: one
vectorised operator an instruction over all rows, in int64).  No TPU
kernel corresponds: the JAX package leaves the whole domain evaluation to
XLA under one `jax.jit` (tstwo_tpu/constraint_framework/__init__.py,
`_domain_kernel`).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from .. import kernels
from . import m31, qm31

P = (1 << 31) - 1

# opcodes (csrc/constraint_eval.cu: enum Op)
LOAD = 0        # dst <- column b of interaction a, at mask offset aux
CONST_B = 1     # dst <- the M31 value a
SCALAR_S = 2    # dst (4 slots) <- scalars[a : a + 4]
ADD_B = 3
SUB_B = 4
MUL_B = 5
SQR_B = 6       # dst <- a * a
NEG_B = 7
ADD_S = 8
SUB_S = 9
MUL_S = 10
NEG_S = 11
PROMOTE = 12    # dst (4 slots) <- (a, 0, 0, 0)
COMBINE_LO = 13  # dst coordinates 0, 1 <- a, b
COMBINE_HI = 14  # dst coordinates 2, 3 <- a, b
ACCUM_B = 15    # sum += a * scalars[b : b + 4]; aux & FOLD: reduce after
ACCUM_S = 16    # sum += a * scalars[b : b + 4] (QM31 product)
FOLD = 1

# Integer operations an instruction needs for one row, counted as the
# repo's bounds count them: 9 an M31 product, 3 an M31 addition (add,
# compare, select).  A QM31 product is the 9 M31 products and 29 additions
# of the Karatsuba form the kernel computes.  Loads, constants and moves
# count 0.  ROW_OPS: the row's end, the sum reduced, times the denominator
# inverse and added into the accumulator.
QM31_MUL_OPS = 9 * 9 + 29 * 3
OP_COST = {LOAD: 0, CONST_B: 0, SCALAR_S: 0, ADD_B: 3, SUB_B: 3, MUL_B: 9,
           SQR_B: 9, NEG_B: 3, ADD_S: 12, SUB_S: 12, MUL_S: QM31_MUL_OPS,
           NEG_S: 12, PROMOTE: 0, COMBINE_LO: 0, COMBINE_HI: 0,
           ACCUM_B: 4 * (9 + 3), ACCUM_S: QM31_MUL_OPS + 4 * 3}
ROW_OPS = 4 * (9 + 3)

MAX_INTERACTIONS = 8  # csrc/constraint_eval.cu: kMaxInteractions


def encode_w0(op: int, aux: int = 0) -> int:
    """The first word of an instruction: opcode and signed 24-bit aux."""
    if not -(1 << 23) <= aux < (1 << 23):
        raise ValueError(f"instruction aux {aux} does not fit 24 bits")
    word = op | (aux & 0xffffff) << 8
    return word - (1 << 32) if word >= 1 << 31 else word


def decode_w0(w0: int):
    """(opcode, aux) of an instruction's first word."""
    return w0 & 0xff, w0 >> 8


def bit_reverse(x, log: int):
    """Bit-reverse the low `log` bits of each element of an integer tensor
    (the kernel's `__brev(x) >> (32 - log)`)."""
    out = torch.zeros_like(x)
    for b in range(log):
        out |= ((x >> b) & 1) << (log - 1 - b)
    return out


def offset_source_rows(rows: torch.Tensor, trace_log: int, eval_log: int,
                       offset: int) -> torch.Tensor:
    """The row a mask at `offset` trace steps reads for each row of the
    bit-reversed evaluation domain: the formula the kernel computes per
    row, equal to constraint_framework `_offset_perm`."""
    n = 1 << eval_log
    rev = bit_reverse(rows, eval_log)
    if trace_log == eval_log:
        # walk the canonic coset order: position k, then k + offset
        k = torch.where(rev < n // 2, 2 * rev, 2 * (n - 1 - rev) + 1)
        k2 = (k + offset) & (n - 1)
        pos = torch.where(k2 & 1 == 0, k2 >> 1, (2 * n - k2) >> 1)
    else:
        half = n >> 1
        step = offset << (eval_log - trace_log - 1)
        pos = torch.where(rev < half, (rev + step) & (half - 1),
                          ((rev - step) & (half - 1)) + half)
    return bit_reverse(pos, eval_log)


def load_table(code) -> torch.Tensor:
    """int32 [L, 4] (interaction, column, mask offset, 0), one row for each
    LOAD of the program `code` (int32 [I, 4] on the host), in order."""
    host = torch.as_tensor(code).to(torch.int64)
    ops, aux = host[:, 0] & 0xff, host[:, 0] >> 8
    rows = (ops == LOAD).nonzero().flatten()
    return torch.stack([host[rows, 2], host[rows, 3], aux[rows],
                        torch.zeros_like(rows)], dim=1).to(
        torch.int32).reshape(-1, 4)


def _check(code: torch.Tensor, stacks: Sequence[Optional[torch.Tensor]],
           scalars: torch.Tensor, n: int) -> None:
    if code.dtype != torch.int32 or code.dim() != 2 or code.shape[1] != 4:
        raise ValueError(f"program: expected int32 [I, 4], got {code.dtype} "
                         f"{tuple(code.shape)}")
    if len(stacks) > MAX_INTERACTIONS:
        raise ValueError(f"{len(stacks)} interactions; at most "
                         f"{MAX_INTERACTIONS}")
    for s in stacks:
        if s is not None and (s.dim() != 2 or s.shape[1] != n
                              or s.dtype != torch.int32):
            raise ValueError(f"interaction stack: expected int32 [B, {n}], "
                             f"got {s.dtype} {tuple(s.shape)}")
    if scalars.dtype != torch.int32 or scalars.dim() != 1:
        raise ValueError("scalars: expected int32 [S]")


def evaluate_plain(code: torch.Tensor, n_slots: int,
                   stacks: Sequence[Optional[torch.Tensor]],
                   scalars: torch.Tensor, denom_off: int, trace_log: int,
                   eval_log: int) -> torch.Tensor:
    """The program over all 2^eval_log rows in plain PyTorch: one
    vectorised operator an instruction, canonical int64 slots.  Returns
    the contribution to the accumulator, int32 [4, n], on the stacks'
    device."""
    n = 1 << eval_log
    _check(code, stacks, scalars, n)
    device = next(s.device for s in stacks if s is not None) \
        if any(s is not None for s in stacks) else scalars.device
    sc = [int(v) & 0xffffffff for v in scalars.tolist()]
    regs: list = [None] * n_slots
    rows = torch.arange(n, device=device, dtype=torch.int64)
    sums = [torch.zeros(n, dtype=torch.int64, device=device)
            for _ in range(4)]

    def full(v):
        return torch.full((n,), v, dtype=torch.int64, device=device)

    def sec(s):
        return torch.stack(regs[s:s + 4])

    def put(s, x4):
        for j in range(4):
            regs[s + j] = x4[j]

    for w0, dst, a, b in code.tolist():
        op, aux = decode_w0(w0)
        if op == LOAD:
            col = stacks[a][b].to(torch.int64)
            if aux:
                col = col.index_select(0, offset_source_rows(
                    rows, trace_log, eval_log, aux))
            regs[dst] = col
        elif op == CONST_B:
            regs[dst] = full(a)
        elif op == SCALAR_S:
            put(dst, [full(sc[a + j]) for j in range(4)])
        elif op == ADD_B:
            regs[dst] = m31.add_w(regs[a], regs[b])
        elif op == SUB_B:
            regs[dst] = m31.sub_w(regs[a], regs[b])
        elif op == MUL_B:
            regs[dst] = m31.mul_w(regs[a], regs[b])
        elif op == SQR_B:
            regs[dst] = m31.mul_w(regs[a], regs[a])
        elif op == NEG_B:
            regs[dst] = m31.neg_w(regs[a])
        elif op == ADD_S:
            put(dst, m31.add_w(sec(a), sec(b)))
        elif op == SUB_S:
            put(dst, m31.sub_w(sec(a), sec(b)))
        elif op == MUL_S:
            put(dst, qm31.mul_w(sec(a), sec(b)))
        elif op == NEG_S:
            put(dst, m31.neg_w(sec(a)))
        elif op == PROMOTE:
            zero = torch.zeros_like(regs[a])
            put(dst, [regs[a], zero, zero, zero])
        elif op in (COMBINE_LO, COMBINE_HI):
            base = dst + (2 if op == COMBINE_HI else 0)
            regs[base], regs[base + 1] = regs[a], regs[b]
        elif op == ACCUM_B:
            for j in range(4):
                sums[j] = (sums[j] + regs[a] * sc[b + j]) % P
        elif op == ACCUM_S:
            coeff = torch.tensor(sc[b:b + 4], dtype=torch.int64,
                                 device=device)[:, None]
            prod = qm31.mul_w(sec(a), coeff)
            for j in range(4):
                sums[j] = (sums[j] + prod[j]) % P
        else:
            raise ValueError(f"unknown opcode {op}")
    denom = torch.tensor(sc[denom_off:denom_off + (1 << (eval_log
                                                         - trace_log))],
                         dtype=torch.int64, device=device)[rows >> trace_log]
    return torch.stack([m31.mul_w(s, denom) for s in sums]).to(torch.int32)


_Ptrs = ctypes.c_void_p * MAX_INTERACTIONS
_Strides = ctypes.c_longlong * MAX_INTERACTIONS


def evaluate_cuda(code: torch.Tensor, loads: torch.Tensor, n_slots: int,
                  stacks: Sequence[Optional[torch.Tensor]],
                  scalars: torch.Tensor, denom_off: int, trace_log: int,
                  eval_log: int, accumulator: torch.Tensor,
                  rows_per_thread: int = 0) -> None:
    """Launch csrc/constraint_eval.cu once: the program over every row,
    its result added into `accumulator` (int32 [4, n] on the card) in
    place.  No synchronisation.  `loads` is the program's `load_table` on
    the card (`ConstraintProgram.device_loads`).  `rows_per_thread` (1, 2, 4, 8; 0: the
    kernel's default) sets how many rows one decode serves; the kernel
    takes fewer by itself where a program's slots do not fit in shared
    memory, and the card tests name each to cover those variants."""
    n = 1 << eval_log
    _check(code, stacks, scalars, n)
    device = accumulator.device
    kernels.check_cuda_tensor(code, "program")
    kernels.check_cuda_tensor(loads, "load table")
    kernels.check_cuda_tensor(scalars, "scalars")
    kernels.check_cuda_tensor(accumulator, "accumulator")
    if tuple(accumulator.shape) != (4, n):
        raise ValueError(f"accumulator: expected [4, {n}], got "
                         f"{tuple(accumulator.shape)}")
    ptrs, strides = _Ptrs(), _Strides()
    for i, s in enumerate(stacks):
        if s is None:
            continue
        kernels.check_cuda_tensor(s, f"interaction {i}", contiguous=False)
        if s.device != device or s.stride(1) != 1:
            raise ValueError(f"interaction {i}: expected rows of stride 1 "
                             f"on {device}")
        ptrs[i], strides[i] = s.data_ptr(), s.stride(0)
    kernels.launch("constraint_eval", "constraint_eval", device,
                   code.data_ptr(), code.shape[0], loads.data_ptr(),
                   loads.shape[0], scalars.data_ptr(),
                   scalars.numel(), denom_off, ptrs, strides,
                   accumulator.data_ptr(), eval_log, trace_log, n_slots,
                   rows_per_thread)


def launch_shape(n_instr: int, n_loads: int, n_scalars: int, n_slots: int,
                 rows_per_thread: int = 0) -> tuple:
    """(rows a thread, instructions a chunk) that csrc/constraint_eval.cu
    takes for a program of these sizes on the current CUDA device."""
    out = (ctypes.c_int * 2)()
    err = kernels.entry("constraint_eval_shape")(
        n_instr, n_loads, n_scalars, n_slots, rows_per_thread, out)
    if err:
        raise RuntimeError(f"a program of {n_slots} slots, {n_loads} loads "
                           f"and {n_scalars} scalars does not fit a block")
    return out[0], out[1]


def evaluate(code: torch.Tensor, loads: torch.Tensor, n_slots: int,
             stacks: Sequence[Optional[torch.Tensor]], scalars: torch.Tensor,
             denom_off: int, trace_log: int, eval_log: int,
             accumulator: torch.Tensor) -> torch.Tensor:
    """Add the program's quotients into `accumulator` [4, n]: the kernel
    in place for a CUDA accumulator, the plain version (which reads
    `code` alone, not the load table `loads`) for a CPU one.  Returns the
    accumulator (the same tensor on the card, a new one on the CPU)."""
    if kernels.on_cuda(accumulator):
        evaluate_cuda(code, loads, n_slots, stacks, scalars, denom_off,
                      trace_log, eval_log, accumulator)
        return accumulator
    return qm31.add(accumulator, evaluate_plain(
        code, n_slots, stacks, scalars, denom_off, trace_log, eval_log))
