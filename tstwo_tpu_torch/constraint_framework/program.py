"""Lower an AIR's constraints once to a constraint program.

`lower(eval, trace_log, eval_log)` runs the FrameworkEval's `evaluate` once
with a `ProgramRecorder`: every field operation becomes a node of
straight-line SSA over M31 (base) and QM31 (secure) values.  Nodes are
hash-consed, so a subexpression computed twice is computed once (wide
Fibonacci's `b.square()` of one constraint is the `a.square()` of the
next); nodes no constraint reads are dropped; and slots are allocated by
liveness, so a program needs as many slots as its peak live set.  The
result, a `ConstraintProgram`, is what ops/constraint_eval.py runs: one
launch of csrc/constraint_eval.cu on the card, the plain executor on the
CPU.

What changes every proof is not in the program: the constraints' random
coefficients, the `secure_param`s (lookup elements) and the LogUp cumsum
shift are operands the program reads from `scalars`, which
`ConstraintProgram.scalars` packs into one small int32 array a proof.

The recorder accepts what `DomainEvaluator` accepts, with the same
meaning: base and secure values, ints, M31 and QM31 constants, `+ - *`,
unary minus and `square()`; `combine_ef` of four base values; masks at any
offset.  Anything else raises while lowering.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from functools import lru_cache
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..air import ORIGINAL_TRACE_IDX, PREPROCESSED_TRACE_IDX
from ..circle import CanonicCoset
from ..constraints import coset_vanishing
from ..fields import M31, QM31
from ..ops import constraint_eval as ce
from ..utils import bit_reverse_index, upload
from . import _LogupEvalMixin
from .logup import LogupAtRow

P = (1 << 31) - 1

ACCUM = -1  # the node of a constraint; an ACCUM_B or ACCUM_S instruction
_BASE_OPS = {"add": ce.ADD_B, "sub": ce.SUB_B, "mul": ce.MUL_B}
_SECURE_OPS = {"add": ce.ADD_S, "sub": ce.SUB_S, "mul": ce.MUL_S}


class _Val:
    """A recorded value: node `id` of its recorder, base or secure."""

    __slots__ = ("rec", "id", "secure")

    def __init__(self, rec: "ProgramRecorder", id: int, secure: bool):
        self.rec, self.id, self.secure = rec, id, secure

    def __add__(self, other):
        return self.rec.binary("add", self, other)

    __radd__ = __add__

    def __sub__(self, other):
        return self.rec.binary("sub", self, other)

    def __rsub__(self, other):
        return self.rec.binary("sub", other, self)

    def __mul__(self, other):
        return self.rec.binary("mul", self, other)

    __rmul__ = __mul__

    def __neg__(self):
        return self.rec.node(ce.NEG_S if self.secure else ce.NEG_B,
                             (self.id,), self.secure)

    def square(self):
        return self * self


@lru_cache(maxsize=None)
def denominator_inverses(trace_log: int, eval_log: int) -> np.ndarray:
    """The 2^(eval_log - trace_log) distinct values of
    `coset_vanishing_denominator_inverses_bitrev(trace_log, eval_log)`:
    row i of the bit-reversed evaluation domain takes value i >> trace_log
    (uint32)."""
    domain = CanonicCoset.new(eval_log).circle_domain()
    coset = CanonicCoset.new(trace_log).coset
    values = [coset_vanishing(coset, domain.at(bit_reverse_index(
        j << trace_log, eval_log))) for j in range(1 << (eval_log - trace_log))]
    # 1/0 is 0, as the full table's batch inverse has it
    return np.array([0 if v.is_zero() else v.inverse().value for v in values],
                    dtype=np.uint32)


@dataclass
class ConstraintProgram:
    """A lowered constraint program and the layout of its scalars.

    code: int32 [I, 4] (ops/constraint_eval.py); n_slots: slots it needs;
    n_constraints, n_params: coefficients and secure parameters it reads;
    constants: its QM31 constants; columns: columns read per interaction."""

    code: np.ndarray
    n_slots: int
    n_constraints: int
    n_params: int
    constants: List[QM31]
    columns: List[int]
    trace_log: int
    eval_log: int
    _device_code: Dict[str, torch.Tensor] = field(default_factory=dict,
                                                  repr=False)

    # scalars: coefficients | params | shift | constants | denominators
    @property
    def param_off(self) -> int:
        return 4 * self.n_constraints

    @property
    def shift_off(self) -> int:
        return self.param_off + 4 * self.n_params

    @property
    def const_off(self) -> int:
        return self.shift_off + 4

    @property
    def denom_off(self) -> int:
        return self.const_off + 4 * len(self.constants)

    def count(self, op: int) -> int:
        """Instructions of opcode `op`."""
        return int(np.count_nonzero((self.code[:, 0] & 0xff) == op))

    def ops_per_row(self) -> int:
        """Integer operations the program needs for one row
        (ops/constraint_eval.py OP_COST, ROW_OPS)."""
        return ce.ROW_OPS + sum(ce.OP_COST[int(w0) & 0xff]
                                for w0 in self.code[:, 0])

    def scalars(self, coeff_powers: Sequence[QM31], params: Sequence[QM31],
                cumsum_shift: QM31) -> np.ndarray:
        """The per-proof words the program reads, int32: constraint k's
        coefficient is coeff_powers[-1 - k] (the accumulator's powers
        are handed out from the end)."""
        if len(coeff_powers) != self.n_constraints or \
                len(params) != self.n_params:
            raise ValueError(
                f"program of {self.n_constraints} constraints and "
                f"{self.n_params} parameters given {len(coeff_powers)} and "
                f"{len(params)}")
        words = [q.to_ints() for q in reversed(coeff_powers)]
        words += [q.to_ints() for q in params]
        words += [cumsum_shift.to_ints()]
        words += [q.to_ints() for q in self.constants]
        flat = [v for w in words for v in w]
        flat += denominator_inverses(self.trace_log, self.eval_log).tolist()
        return np.array(flat, dtype=np.int64).astype(np.int32)

    def device_code(self, device: torch.device) -> torch.Tensor:
        """The code on `device`, uploaded once."""
        key = str(device)
        if key not in self._device_code:
            self._device_code[key] = upload(torch.from_numpy(self.code),
                                            device)
        return self._device_code[key]

    def device_loads(self, device: torch.device) -> torch.Tensor:
        """The program's load table (ops/constraint_eval.py `load_table`)
        on `device`, uploaded once."""
        key = ("loads", str(device))
        if key not in self._device_code:
            self._device_code[key] = upload(
                ce.load_table(torch.from_numpy(self.code)), device)
        return self._device_code[key]


class ProgramRecorder(_LogupEvalMixin):
    """EvalAtRow that records SSA nodes instead of computing.

    A node is (opcode, operand node ids, immediate); `nodes[i]` is node
    i, `secure[i]` its type.  Scalar reads are nodes of opcode SCALAR_S
    whose immediate names the word: ("param", i), ("shift",) or
    ("const", ints)."""

    def __init__(self):
        self.nodes: List[Tuple] = []
        self.secure: List[bool] = []
        self._memo: Dict[Tuple, int] = {}
        self.accums: List[int] = []  # the value node of constraint k
        self.col_index: Dict[int, int] = {}
        self._n_params = 0
        self.logup = LogupAtRow.dummy()
        self.logup.cumsum_shift = self.node(ce.SCALAR_S, (), True, ("shift",))

    # -- nodes ---------------------------------------------------------------
    def node(self, op: int, args: Tuple[int, ...], secure: bool,
             imm=None) -> _Val:
        key = (op, args, imm)
        i = self._memo.get(key)
        if i is None:
            i = len(self.nodes)
            self.nodes.append(key)
            self.secure.append(secure)
            self._memo[key] = i
        return _Val(self, i, secure)

    def _lift(self, x) -> _Val:
        if isinstance(x, _Val):
            if x.rec is not self:
                raise ValueError("value of another constraint program")
            return x
        if isinstance(x, bool):
            raise TypeError("bool is not a field element")
        if isinstance(x, int):
            return self.node(ce.CONST_B, (), False, x % P)
        if isinstance(x, M31):
            return self.node(ce.CONST_B, (), False, x.value)
        if isinstance(x, QM31):
            return self.node(ce.SCALAR_S, (), True, ("const", x.to_ints()))
        raise TypeError(f"a constraint cannot take {type(x).__name__}")

    def promote(self, v: _Val) -> _Val:
        if v.secure:
            return v
        if v.rec.nodes[v.id][0] == ce.CONST_B:
            c = v.rec.nodes[v.id][2]
            return self.node(ce.SCALAR_S, (), True, ("const", (c, 0, 0, 0)))
        return self.node(ce.PROMOTE, (v.id,), True)

    def binary(self, kind: str, x, y) -> _Val:
        x, y = self._lift(x), self._lift(y)
        secure = x.secure or y.secure
        if secure:
            x, y = self.promote(x), self.promote(y)
        op = (_SECURE_OPS if secure else _BASE_OPS)[kind]
        if kind == "mul" and x.id == y.id and not secure:
            return self.node(ce.SQR_B, (x.id,), False)
        args = (x.id, y.id)
        if kind != "sub":
            args = tuple(sorted(args))
        return self.node(op, args, secure)

    # -- EvalAtRow -----------------------------------------------------------
    def secure_param(self, value: QM31) -> _Val:
        i = self._n_params
        self._n_params += 1
        return self.node(ce.SCALAR_S, (), True, ("param", i))

    def get_preprocessed_column(self, cid) -> _Val:
        return self.next_interaction_mask(PREPROCESSED_TRACE_IDX, [0])[0]

    def next_trace_mask(self) -> _Val:
        return self.next_interaction_mask(ORIGINAL_TRACE_IDX, [0])[0]

    def next_interaction_mask(self, interaction: int,
                              offsets: Sequence[int]) -> List[_Val]:
        idx = self.col_index.get(interaction, 0)
        self.col_index[interaction] = idx + 1
        return [self.node(ce.LOAD, (), False, (interaction, idx, int(off)))
                for off in offsets]

    def add_constraint(self, constraint) -> None:
        v = self._lift(constraint)
        self.accums.append(v.id)
        self.node(ACCUM, (v.id,), False, ("accum", len(self.accums) - 1))

    def combine_ef(self, values: Sequence) -> _Val:
        vals = [self._lift(v) for v in values]
        if len(vals) != 4 or any(v.secure for v in vals):
            raise ValueError("combine_ef takes four base values")
        return self.node(ce.COMBINE_LO, tuple(v.id for v in vals), True)


class _Slots:
    """First-fit slot allocator: a base value takes 1 slot, a secure one
    4 consecutive slots."""

    def __init__(self):
        self.used: List[bool] = []

    def alloc(self, width: int) -> int:
        i = 0
        while True:
            while len(self.used) < i + width:
                self.used.append(False)
            if not any(self.used[i:i + width]):
                self.used[i:i + width] = [True] * width
                return i
            i += 1

    def free(self, start: int, width: int) -> None:
        self.used[start:start + width] = [False] * width


FOLD_EVERY = 3  # constraints between two folds of the kernel's 64-bit sums


def lower(framework_eval, trace_log: int, eval_log: int) -> ConstraintProgram:
    """Record `framework_eval.evaluate` once and lower it to a program.

    Instructions keep the recorded order, except that a load, constant or
    scalar read moves to just before its first reader, so an AIR that
    reads all its columns first does not hold them all live.  Every
    FOLD_EVERY-th constraint reduces the kernel's 64-bit sums: three
    products below 2^62 fit above a folded sum below 2^34."""
    rec = ProgramRecorder()
    framework_eval.evaluate(rec)
    if not rec.logup.is_finalized:
        raise ValueError("logup fractions written but never finalized")
    nodes, secure = rec.nodes, rec.secure
    # live nodes: what some constraint reads
    live = [False] * len(nodes)
    for i in range(len(nodes) - 1, -1, -1):
        if nodes[i][0] == ACCUM or live[i]:
            live[i] = True
            for a in nodes[i][1]:
                live[a] = True
    order: List[int] = []
    placed = [False] * len(nodes)
    for i in range(len(nodes)):
        if not live[i] or not nodes[i][1]:
            continue  # leaves go in front of their first reader
        for a in nodes[i][1]:
            if not placed[a]:  # a leaf: earlier nodes are placed already
                placed[a] = True
                order.append(a)
        placed[i] = True
        order.append(i)
    last_use: Dict[int, int] = {}
    for p, i in enumerate(order):
        for a in nodes[i][1]:
            last_use[a] = p
    # scalar words
    constants: List[QM31] = []
    const_index: Dict[Tuple, int] = {}
    for i in order:
        op, _, imm = nodes[i]
        if op == ce.SCALAR_S and imm[0] == "const" and imm[1] not in \
                const_index:
            const_index[imm[1]] = len(constants)
            constants.append(QM31.from_ints(imm[1]))
    program = ConstraintProgram(
        code=np.zeros((0, 4), np.int32), n_slots=0,
        n_constraints=len(rec.accums), n_params=rec._n_params,
        constants=constants, columns=[], trace_log=trace_log,
        eval_log=eval_log)

    def scalar_word(imm) -> int:
        if imm[0] == "param":
            return program.param_off + 4 * imm[1]
        if imm[0] == "shift":
            return program.shift_off
        return program.const_off + 4 * const_index[imm[1]]

    slots, slot_of, code = _Slots(), {}, []
    columns: Dict[int, int] = {}
    for p, i in enumerate(order):
        op, args, imm = nodes[i]
        src = [slot_of[a] for a in args]
        if op == ACCUM:
            k = imm[1]
            fold = ce.FOLD if (k + 1) % FOLD_EVERY == 0 else 0
            code.append((ce.encode_w0(
                ce.ACCUM_S if secure[args[0]] else ce.ACCUM_B, fold), 0,
                src[0], 4 * k))
        else:
            # the destination is taken before the sources are freed, so
            # it never shares a slot with one of them
            dst = slot_of[i] = slots.alloc(4 if secure[i] else 1)
            if op == ce.LOAD:
                interaction, col, offset = imm
                columns[interaction] = max(columns.get(interaction, 0),
                                           col + 1)
                code.append((ce.encode_w0(op, offset), dst, interaction,
                             col))
            elif op == ce.CONST_B:
                code.append((op, dst, imm, 0))
            elif op == ce.SCALAR_S:
                code.append((op, dst, scalar_word(imm), 0))
            elif op == ce.COMBINE_LO:
                code.append((ce.COMBINE_LO, dst, src[0], src[1]))
                code.append((ce.COMBINE_HI, dst, src[2], src[3]))
            elif len(src) == 1:
                code.append((op, dst, src[0], src[0]))
            else:
                code.append((op, dst, src[0], src[1]))
        for a in set(args):
            if last_use[a] == p:
                slots.free(slot_of[a], 4 if secure[a] else 1)
    program.code = np.array(code, dtype=np.int64).reshape(-1, 4).astype(
        np.int32)
    program.n_slots = len(slots.used)
    program.columns = [columns.get(i, 0) for i in range(
        max(columns, default=-1) + 1)]
    return program
