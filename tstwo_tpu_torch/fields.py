"""Host-side scalar field arithmetic for the Circle-STARK stack.

M31 = GF(2^31 - 1), CM31 = M31[i]/(i^2+1), QM31 = CM31[u]/(u^2 - (2+i)).

These are exact-integer Python implementations used for the sequential,
host-side parts of the protocol (Fiat-Shamir transcript, OODS points, proof
assembly, twiddle derivation).  Bulk columns live on device as uint32 arrays
(see tstwo_tpu_torch.ops).  Semantics mirror the Rust stwo field stack
(reference: packages/core/src/fields/{m31,cm31,qm31}.ts, which ports
stwo-prover's fields module; validated against test-vectors/*.json).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, List, Sequence, Tuple, Union

P = (1 << 31) - 1  # 2^31 - 1
MODULUS_BITS = 31
N_BYTES_FELT = 4
P2 = P * P
P4 = P**4
SECURE_EXTENSION_DEGREE = 4


def m31_reduce(val: int) -> int:
    """Reduce any non-negative integer < P^2 to [0, P).

    Mirrors the Rust bit-trick ((((v>>31)+v+1)>>31)+v)&P
    (reference m31.ts:89-101); for host ints plain % is equivalent and exact.
    """
    return val % P


@dataclass(frozen=True, slots=True)
class M31:
    """Element of GF(2^31-1). reference m31.ts:11."""

    value: int

    # -- constructors -------------------------------------------------------
    @staticmethod
    def from_u32_unchecked(v: int) -> "M31":
        return M31(v)

    @staticmethod
    def from_int(v: int) -> "M31":
        return M31(v % P)

    # Rust From<i32>/From<u32>
    from_ = from_int

    @staticmethod
    def partial_reduce(v: int) -> "M31":
        return M31(v - P if v >= P else v)

    @staticmethod
    def reduce(v: int) -> "M31":
        return M31(m31_reduce(v))

    @staticmethod
    def zero() -> "M31":
        return M31(0)

    @staticmethod
    def one() -> "M31":
        return M31(1)

    # -- arithmetic ---------------------------------------------------------
    def __add__(self, o: "M31") -> "M31":
        s = self.value + o.value
        return M31(s - P if s >= P else s)

    def __sub__(self, o: "M31") -> "M31":
        s = self.value + P - o.value
        return M31(s - P if s >= P else s)

    def __neg__(self) -> "M31":
        return M31(0) if self.value == 0 else M31(P - self.value)

    def __mul__(self, o: "M31") -> "M31":
        return M31((self.value * o.value) % P)

    def double(self) -> "M31":
        return self + self

    def square(self) -> "M31":
        return self * self

    def pow(self, e: int) -> "M31":
        return M31(pow(self.value, e, P))

    def inverse(self) -> "M31":
        if self.value == 0:
            raise ZeroDivisionError("0 has no inverse")
        # p-2 exponent; equivalent to the 37-mul chain pow2147483645
        # (reference m31.ts:305-315)
        return M31(pow(self.value, P - 2, P))

    def is_zero(self) -> bool:
        return self.value == 0

    def complex_conjugate(self) -> "M31":
        return self

    def to_bytes(self) -> bytes:
        return self.value.to_bytes(4, "little")

    @staticmethod
    def into_slice(elems: Sequence["M31"]) -> bytes:
        return b"".join(e.to_bytes() for e in elems)

    def __repr__(self) -> str:  # pragma: no cover
        return f"M31({self.value})"


M31_ZERO = M31(0)
M31_ONE = M31(1)


@dataclass(frozen=True, slots=True)
class CM31:
    """Element of GF(P^2) = M31[i]/(i^2+1), stored as a + b*i.

    reference cm31.ts:12.
    """

    a: int  # real
    b: int  # imag

    @staticmethod
    def from_u32_unchecked(a: int, b: int) -> "CM31":
        return CM31(a, b)

    @staticmethod
    def from_m31(a: M31, b: M31) -> "CM31":
        return CM31(a.value, b.value)

    @staticmethod
    def from_base(a: M31) -> "CM31":
        return CM31(a.value, 0)

    @staticmethod
    def zero() -> "CM31":
        return CM31(0, 0)

    @staticmethod
    def one() -> "CM31":
        return CM31(1, 0)

    @property
    def real(self) -> M31:
        return M31(self.a)

    @property
    def imag(self) -> M31:
        return M31(self.b)

    def __add__(self, o: "CM31") -> "CM31":
        return CM31((self.a + o.a) % P, (self.b + o.b) % P)

    def __sub__(self, o: "CM31") -> "CM31":
        return CM31((self.a - o.a) % P, (self.b - o.b) % P)

    def __neg__(self) -> "CM31":
        return CM31((-self.a) % P, (-self.b) % P)

    def __mul__(self, o: "CM31") -> "CM31":
        # (a+bi)(c+di) = (ac-bd) + (ad+bc)i   (reference cm31.ts:202-205)
        return CM31(
            (self.a * o.a - self.b * o.b) % P,
            (self.a * o.b + self.b * o.a) % P,
        )

    def mul_m31(self, o: M31) -> "CM31":
        return CM31((self.a * o.value) % P, (self.b * o.value) % P)

    def sub_m31(self, o: M31) -> "CM31":
        return CM31((self.a - o.value) % P, self.b)

    def double(self) -> "CM31":
        return self + self

    def square(self) -> "CM31":
        return self * self

    def pow(self, e: int) -> "CM31":
        r, base = CM31.one(), self
        while e:
            if e & 1:
                r = r * base
            base = base * base
            e >>= 1
        return r

    def inverse(self) -> "CM31":
        # 1/(a+bi) = (a-bi)/(a^2+b^2)   (reference cm31.ts:237-251)
        if self.is_zero():
            raise ZeroDivisionError("0 has no inverse")
        norm = (self.a * self.a + self.b * self.b) % P
        ninv = pow(norm, P - 2, P)
        return CM31((self.a * ninv) % P, (-self.b * ninv) % P)

    def is_zero(self) -> bool:
        return self.a == 0 and self.b == 0

    def complex_conjugate(self) -> "CM31":
        return CM31(self.a, (-self.b) % P)

    def to_bytes(self) -> bytes:
        return self.a.to_bytes(4, "little") + self.b.to_bytes(4, "little")

    @staticmethod
    def into_slice(elems: Sequence["CM31"]) -> bytes:
        return b"".join(e.to_bytes() for e in elems)

    def __repr__(self) -> str:  # pragma: no cover
        return f"CM31({self.a}, {self.b})"


# R = 2 + i, the non-residue for the u^2 = R extension (reference qm31.ts:9)
_R = CM31(2, 1)


@dataclass(frozen=True, slots=True)
class QM31:
    """Element of GF(P^4) = CM31[u]/(u^2 - (2+i)). reference qm31.ts:29."""

    c0: CM31
    c1: CM31

    @staticmethod
    def from_u32_unchecked(a: int, b: int, c: int, d: int) -> "QM31":
        return QM31(CM31(a, b), CM31(c, d))

    @staticmethod
    def from_m31(a: M31, b: M31, c: M31, d: M31) -> "QM31":
        return QM31(CM31(a.value, b.value), CM31(c.value, d.value))

    @staticmethod
    def from_m31_array(arr: Sequence[M31]) -> "QM31":
        a, b, c, d = arr
        return QM31.from_m31(a, b, c, d)

    @staticmethod
    def from_base(v: M31) -> "QM31":
        return QM31(CM31(v.value, 0), CM31.zero())

    @staticmethod
    def from_cm31(v: CM31) -> "QM31":
        return QM31(v, CM31.zero())

    @staticmethod
    def zero() -> "QM31":
        return QM31(CM31.zero(), CM31.zero())

    @staticmethod
    def one() -> "QM31":
        return QM31(CM31.one(), CM31.zero())

    def to_m31_array(self) -> Tuple[M31, M31, M31, M31]:
        return (M31(self.c0.a), M31(self.c0.b), M31(self.c1.a), M31(self.c1.b))

    def to_ints(self) -> Tuple[int, int, int, int]:
        return (self.c0.a, self.c0.b, self.c1.a, self.c1.b)

    @staticmethod
    def from_ints(v: Sequence[int]) -> "QM31":
        return QM31(CM31(v[0] % P, v[1] % P), CM31(v[2] % P, v[3] % P))

    @staticmethod
    def from_partial_evals(evals: Sequence["QM31"]) -> "QM31":
        """Combine 4 coordinate-poly evals into one (reference qm31.ts:168-174)."""
        res = evals[0]
        res = res + evals[1] * QM31.from_u32_unchecked(0, 1, 0, 0)
        res = res + evals[2] * QM31.from_u32_unchecked(0, 0, 1, 0)
        res = res + evals[3] * QM31.from_u32_unchecked(0, 0, 0, 1)
        return res

    def __add__(self, o: "QM31") -> "QM31":
        if not isinstance(o, QM31):
            return NotImplemented
        return QM31(self.c0 + o.c0, self.c1 + o.c1)

    def __sub__(self, o: "QM31") -> "QM31":
        if not isinstance(o, QM31):
            return NotImplemented
        return QM31(self.c0 - o.c0, self.c1 - o.c1)

    def __neg__(self) -> "QM31":
        return QM31(-self.c0, -self.c1)

    def __mul__(self, o: "QM31") -> "QM31":
        # (a+bu)(c+du) = (ac + R bd) + (ad + bc)u   (reference qm31.ts:300-305)
        if not isinstance(o, QM31):
            return NotImplemented  # defer to the other operand's __rmul__
        return QM31(
            self.c0 * o.c0 + _R * self.c1 * o.c1,
            self.c0 * o.c1 + self.c1 * o.c0,
        )

    def mul_m31(self, o: M31) -> "QM31":
        return QM31(self.c0.mul_m31(o), self.c1.mul_m31(o))

    def mul_cm31(self, o: CM31) -> "QM31":
        return QM31(self.c0 * o, self.c1 * o)

    def add_m31(self, o: M31) -> "QM31":
        return QM31(self.c0 + CM31(o.value, 0), self.c1)

    def sub_m31(self, o: M31) -> "QM31":
        return QM31(self.c0 - CM31(o.value, 0), self.c1)

    def double(self) -> "QM31":
        return self + self

    def square(self) -> "QM31":
        return self * self

    def pow(self, e: int) -> "QM31":
        r, base = QM31.one(), self
        while e:
            if e & 1:
                r = r * base
            base = base * base
            e >>= 1
        return r

    def inverse(self) -> "QM31":
        # (a + bu)^-1 = (a - bu) / (a^2 - (2+i) b^2)  (reference qm31.ts:396-406)
        if self.is_zero():
            raise ZeroDivisionError("0 has no inverse")
        b2 = self.c1.square()
        ib2 = CM31((-b2.b) % P, b2.a)  # i * b^2
        denom = self.c0.square() - (b2 + b2 + ib2)
        dinv = denom.inverse()
        return QM31(self.c0 * dinv, (-self.c1) * dinv)

    def div(self, o: "QM31") -> "QM31":
        return self * o.inverse()

    def div_m31(self, o: M31) -> "QM31":
        return self.mul_m31(o.inverse())

    def is_zero(self) -> bool:
        return self.c0.is_zero() and self.c1.is_zero()

    def complex_conjugate(self) -> "QM31":
        """Galois conjugation of QM31/CM31: u -> -u, i.e. (c0, -c1).

        This is the Rust stwo semantics (quotients.rs: "a point Pr + uPi ...
        and its conjugate Pr - uPi").  NOTE: the reference TS
        (qm31.ts:433-435) conjugates i in each coordinate instead -- that map
        is not multiplicative on QM31 (it moves R = 2+i) and breaks the DEEP
        quotient low-degree property; it is a TS-only bug, not ported.
        """
        return QM31(self.c0, -self.c1)

    def to_bytes(self) -> bytes:
        return self.c0.to_bytes() + self.c1.to_bytes()

    @staticmethod
    def into_slice(elems: Sequence["QM31"]) -> bytes:
        return b"".join(e.to_bytes() for e in elems)

    def __repr__(self) -> str:  # pragma: no cover
        return f"QM31{self.to_ints()}"


QM31_ZERO = QM31.zero()
QM31_ONE = QM31.one()

Felt = Union[M31, CM31, QM31]


def batch_inverse(elems: Sequence[Felt]) -> List[Felt]:
    """Montgomery-trick batch inversion (reference fields.ts:66)."""
    n = len(elems)
    if n == 0:
        return []
    one = type(elems[0]).one()
    prefix = [one] * (n + 1)
    for i, e in enumerate(elems):
        prefix[i + 1] = prefix[i] * e
    inv_all = prefix[n].inverse()
    out: List[Felt] = [one] * n
    for i in range(n - 1, -1, -1):
        out[i] = prefix[i] * inv_all
        inv_all = inv_all * elems[i]
    return out


def batch_inverse_in_place(elems: Sequence[Felt], dst: List[Felt]) -> None:
    """Write inverses of ``elems`` into ``dst`` (reference fields.ts
    batchInverseInPlace / batchInverseClassic).  ``dst`` must be at least
    as long as ``elems``.  The reference splits this into a WIDTH-strided
    SIMD path and a classic path; one whole-column pass is both here.
    """
    if len(dst) < len(elems):
        raise ValueError("dst is smaller than column")
    for i, v in enumerate(batch_inverse(elems)):
        dst[i] = v


def batch_inverse_chunked(elems: Sequence[Felt], dst: List[Felt],
                          chunk_size: int) -> None:
    """Chunked batch inversion (reference fields.ts batchInverseChunked):
    processes ``elems`` in ``chunk_size`` blocks -- same results as one
    pass, bounded peak scratch."""
    if chunk_size <= 0:
        raise ValueError("chunk_size must be positive")
    if len(dst) < len(elems):
        raise ValueError("dst is smaller than column")
    for start in range(0, len(elems), chunk_size):
        block = elems[start:start + chunk_size]
        for i, v in enumerate(batch_inverse(block)):
            dst[start + i] = v


class SecureColumnByCoords:
    """QM31 column stored as SECURE_EXTENSION_DEGREE coordinate columns.

    Reference ``src/fields/secure_columns.ts`` (tested by
    ``test/fields/secure_columns.test.ts``).  tpu-first shape: the four
    M31 coordinate columns live in ONE ``u32[4, n]`` SoA array -- the
    exact layout every device kernel in this package consumes -- so
    ``to_device()`` is a zero-copy handoff rather than a transpose of
    per-element objects.
    """

    __slots__ = ("data",)

    def __init__(self, columns):
        import numpy as np

        if len(columns) != SECURE_EXTENSION_DEGREE:
            raise ValueError(
                f"expected {SECURE_EXTENSION_DEGREE} coordinate columns")
        lengths = {len(c) for c in columns}
        if len(lengths) > 1:
            raise ValueError("coordinate column length mismatch")
        n = lengths.pop() if lengths else 0
        data = np.empty((SECURE_EXTENSION_DEGREE, n), dtype=np.uint32)
        for i, col in enumerate(columns):
            data[i] = [v.value if isinstance(v, M31) else int(v) % P
                       for v in col]
        self.data = data

    # -- constructors -----------------------------------------------------
    @staticmethod
    def _wrap(data) -> "SecureColumnByCoords":
        sc = SecureColumnByCoords.zeros(0)
        sc.data = data
        return sc

    @staticmethod
    def zeros(n: int) -> "SecureColumnByCoords":
        import numpy as np

        return SecureColumnByCoords.__new__(SecureColumnByCoords)._init_zeros(n)

    def _init_zeros(self, n: int) -> "SecureColumnByCoords":
        import numpy as np

        self.data = np.zeros((SECURE_EXTENSION_DEGREE, n), dtype=np.uint32)
        return self

    # reference exposes uninitialized() with zeros() behavior
    uninitialized = zeros

    @staticmethod
    def from_iter(values: Iterable[QM31]) -> "SecureColumnByCoords":
        import numpy as np

        vals = [v.to_ints() for v in values]
        data = (np.array(vals, dtype=np.uint32).T if vals
                else np.zeros((SECURE_EXTENSION_DEGREE, 0), dtype=np.uint32))
        return SecureColumnByCoords._wrap(data)

    # -- container protocol ----------------------------------------------
    @property
    def columns(self):
        return [self.data[i] for i in range(SECURE_EXTENSION_DEGREE)]

    def __len__(self) -> int:
        return int(self.data.shape[1])

    def len(self) -> int:
        return len(self)

    def is_empty(self) -> bool:
        return len(self) == 0

    def at(self, index: int) -> QM31:
        if not 0 <= index < len(self):
            raise IndexError(f"index {index} out of bounds")
        return QM31.from_ints([int(v) for v in self.data[:, index]])

    def set(self, index: int, value: QM31) -> None:
        if not 0 <= index < len(self):
            raise IndexError(f"index {index} out of bounds")
        self.data[:, index] = value.to_ints()

    def __iter__(self):
        for i in range(len(self)):
            yield self.at(i)

    def to_vec(self) -> List[QM31]:
        return list(self)

    def to_cpu(self) -> "SecureColumnByCoords":
        return SecureColumnByCoords._wrap(self.data.copy())

    def __eq__(self, other) -> bool:
        import numpy as np

        return (isinstance(other, SecureColumnByCoords)
                and self.data.shape == other.data.shape
                and bool(np.array_equal(self.data, other.data)))

    # -- device interop ---------------------------------------------------
    def to_device(self, device):
        """The SoA array IS the device layout: one upload, no transpose."""
        from .utils import to_torch_u32

        return to_torch_u32(self.data, device)

    @staticmethod
    def from_device(arr) -> "SecureColumnByCoords":
        from .utils import to_numpy_u32

        data = to_numpy_u32(arr)
        if data.ndim != 2 or data.shape[0] != SECURE_EXTENSION_DEGREE:
            raise ValueError("expected a [4, n] coordinate array")
        return SecureColumnByCoords._wrap(data)
