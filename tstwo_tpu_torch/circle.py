"""Circle-group geometry over M31 and QM31 (host side).

The unit circle x^2 + y^2 = 1 over GF(2^31-1) is a cyclic group of order
2^31 under rotation; cosets of its subgroups form the evaluation domains of
the circle FFT.  reference: packages/core/src/circle.ts.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Generic, Iterator, List, TypeVar

from .fields import M31, QM31, P4

F = TypeVar("F")

M31_CIRCLE_LOG_ORDER = 31
_ORDER_MASK = (1 << M31_CIRCLE_LOG_ORDER) - 1


@dataclass(frozen=True, slots=True)
class CirclePoint(Generic[F]):
    """Point on x^2+y^2=1, an additive group under rotation.

    reference circle.ts:19.
    """

    x: F
    y: F

    def __add__(self, o: "CirclePoint[F]") -> "CirclePoint[F]":
        return CirclePoint(
            self.x * o.x - self.y * o.y,
            self.x * o.y + self.y * o.x,
        )

    def conjugate(self) -> "CirclePoint[F]":
        return CirclePoint(self.x, -self.y)

    def __neg__(self) -> "CirclePoint[F]":
        return self.conjugate()

    def __sub__(self, o: "CirclePoint[F]") -> "CirclePoint[F]":
        return self + (-o)

    def antipode(self) -> "CirclePoint[F]":
        return CirclePoint(-self.x, -self.y)

    def double(self) -> "CirclePoint[F]":
        return self + self

    def repeated_double(self, n: int) -> "CirclePoint[F]":
        p = self
        for _ in range(n):
            p = p.double()
        return p

    def mul(self, scalar: int, zero: "CirclePoint[F]") -> "CirclePoint[F]":
        res, cur = zero, self
        while scalar > 0:
            if scalar & 1:
                res = res + cur
            cur = cur.double()
            scalar >>= 1
        return res

    def complex_conjugate(self) -> "CirclePoint[F]":
        return CirclePoint(self.x.complex_conjugate(), self.y.complex_conjugate())

    def into_ef(self, convert) -> "CirclePoint":
        return CirclePoint(convert(self.x), convert(self.y))

    @staticmethod
    def double_x(x: F, one: F) -> F:
        sx = x * x
        return sx + sx - one

    @staticmethod
    def zero_m31() -> "CirclePoint[M31]":
        return CirclePoint(M31.one(), M31.zero())

    @staticmethod
    def zero_qm31() -> "CirclePoint[QM31]":
        return CirclePoint(QM31.one(), QM31.zero())

    def log_order_m31(self) -> int:
        res, cur = 0, self.x
        one = M31.one()
        while cur != one:
            cur = CirclePoint.double_x(cur, one)
            res += 1
            if res > 31:
                raise ValueError("not a 2-power order point")
        return res

    def mul_signed(self, off: int, zero: "CirclePoint[F]") -> "CirclePoint[F]":
        if off >= 0:
            return self.mul(off, zero)
        return self.conjugate().mul(-off, zero)

    @staticmethod
    def get_point(index: int) -> "CirclePoint[QM31]":
        if index >= SECURE_FIELD_CIRCLE_ORDER:
            raise ValueError("index out of range")
        return SECURE_FIELD_CIRCLE_GEN.mul(index, CirclePoint.zero_qm31())

    @staticmethod
    def get_random_point(channel) -> "CirclePoint[QM31]":
        """Sample a uniform QM31 circle point: t -> ((1-t^2)/(1+t^2), 2t/(1+t^2)).

        reference circle.ts:126-133.
        """
        t = channel.draw_felt()
        t2 = t.square()
        inv = (t2 + QM31.one()).inverse()
        x = (QM31.one() - t2) * inv
        y = t.double() * inv
        return CirclePoint(x, y)


# Generator of the order-2^31 circle group over M31 (reference circle.ts:137).
M31_CIRCLE_GEN: CirclePoint[M31] = CirclePoint(M31(2), M31(1268011823))

# Generator of the full circle group over QM31 (reference circle.ts:143-146).
SECURE_FIELD_CIRCLE_GEN: CirclePoint[QM31] = CirclePoint(
    QM31.from_u32_unchecked(1, 0, 478637715, 513582971),
    QM31.from_u32_unchecked(992285211, 649143431, 740191619, 1186584352),
)
SECURE_FIELD_CIRCLE_ORDER = P4 - 1


# Cache of k -> point(k) for subgroup generators, and fast to_point.
_GEN_POW_CACHE: List[CirclePoint[M31]] = []


def _gen_pows() -> List[CirclePoint[M31]]:
    if not _GEN_POW_CACHE:
        p = M31_CIRCLE_GEN
        for _ in range(M31_CIRCLE_LOG_ORDER):
            _GEN_POW_CACHE.append(p)
            p = p.double()
    return _GEN_POW_CACHE


@dataclass(frozen=True, slots=True)
class CirclePointIndex:
    """Integer i standing for i * M31_CIRCLE_GEN (reference circle.ts:152)."""

    value: int

    @staticmethod
    def zero() -> "CirclePointIndex":
        return CirclePointIndex(0)

    @staticmethod
    def generator() -> "CirclePointIndex":
        return CirclePointIndex(1)

    @staticmethod
    def subgroup_gen(log_size: int) -> "CirclePointIndex":
        if log_size > M31_CIRCLE_LOG_ORDER:
            raise ValueError("log_size too large")
        return CirclePointIndex(1 << (M31_CIRCLE_LOG_ORDER - log_size))

    def reduce(self) -> "CirclePointIndex":
        return CirclePointIndex(self.value & _ORDER_MASK)

    def to_point(self) -> CirclePoint[M31]:
        res = CirclePoint.zero_m31()
        v = self.value
        for j, p in enumerate(_gen_pows()):
            if (v >> j) & 1:
                res = res + p
        return res

    def half(self) -> "CirclePointIndex":
        if self.value & 1:
            raise ValueError("not even")
        return CirclePointIndex(self.value >> 1)

    def __add__(self, o: "CirclePointIndex") -> "CirclePointIndex":
        return CirclePointIndex((self.value + o.value) & _ORDER_MASK)

    def __sub__(self, o: "CirclePointIndex") -> "CirclePointIndex":
        return CirclePointIndex((self.value - o.value) & _ORDER_MASK)

    def scale(self, k: int) -> "CirclePointIndex":
        return CirclePointIndex((self.value * k) & _ORDER_MASK)

    def __neg__(self) -> "CirclePointIndex":
        return CirclePointIndex((-self.value) & _ORDER_MASK)


@dataclass(frozen=True, slots=True)
class Coset:
    """The coset initial + <step> of size 2^log_size (reference circle.ts:199)."""

    initial_index: CirclePointIndex
    log_size: int

    @property
    def step_size(self) -> CirclePointIndex:
        return CirclePointIndex.subgroup_gen(self.log_size)

    @property
    def step(self) -> CirclePoint[M31]:
        return self.step_size.to_point()

    @property
    def initial(self) -> CirclePoint[M31]:
        return self.initial_index.to_point()

    @staticmethod
    def new(initial_index: CirclePointIndex, log_size: int) -> "Coset":
        if log_size > M31_CIRCLE_LOG_ORDER:
            raise ValueError("log_size too large")
        return Coset(initial_index, log_size)

    @staticmethod
    def subgroup(log_size: int) -> "Coset":
        return Coset.new(CirclePointIndex.zero(), log_size)

    @staticmethod
    def odds(log_size: int) -> "Coset":
        """G_{2n} + <G_n>."""
        return Coset.new(CirclePointIndex.subgroup_gen(log_size + 1), log_size)

    @staticmethod
    def half_odds(log_size: int) -> "Coset":
        """G_{4n} + <G_n>."""
        return Coset.new(CirclePointIndex.subgroup_gen(log_size + 2), log_size)

    def size(self) -> int:
        return 1 << self.log_size

    def double(self) -> "Coset":
        if self.log_size <= 0:
            raise ValueError("log_size must be > 0 to double")
        return Coset(self.initial_index.scale(2), self.log_size - 1)

    def repeated_double(self, n: int) -> "Coset":
        c = self
        for _ in range(n):
            c = c.double()
        return c

    def is_doubling_of(self, other: "Coset") -> bool:
        return (
            self.log_size <= other.log_size
            and self == other.repeated_double(other.log_size - self.log_size)
        )

    def index_at(self, i: int) -> CirclePointIndex:
        return self.initial_index + self.step_size.scale(i)

    def at(self, i: int) -> CirclePoint[M31]:
        return self.index_at(i).to_point()

    def shift(self, shift_size: CirclePointIndex) -> "Coset":
        return Coset.new(self.initial_index + shift_size, self.log_size)

    def conjugate(self) -> "Coset":
        return Coset.new(-self.initial_index, self.log_size)

    def iter(self) -> Iterator[CirclePoint[M31]]:
        cur, step = self.initial, self.step
        for _ in range(self.size()):
            yield cur
            cur = cur + step

    def iter_indices(self) -> Iterator[CirclePointIndex]:
        cur = self.initial_index
        for _ in range(self.size()):
            yield cur
            cur = cur + self.step_size


@dataclass(frozen=True, slots=True)
class CircleDomain:
    """Union of a half-coset and its conjugate (reference circle.ts:386)."""

    half_coset: Coset

    @staticmethod
    def new(half_coset: Coset) -> "CircleDomain":
        return CircleDomain(half_coset)

    def log_size(self) -> int:
        return self.half_coset.log_size + 1

    def size(self) -> int:
        return 1 << self.log_size()

    def index_at(self, i: int) -> CirclePointIndex:
        half = self.half_coset.size()
        if i < half:
            return self.half_coset.index_at(i)
        return -self.half_coset.index_at(i - half)

    def at(self, i: int) -> CirclePoint[M31]:
        return self.index_at(i).to_point()

    def is_canonic(self) -> bool:
        return self.half_coset.initial_index.value * 4 == self.half_coset.step_size.value

    def iter_indices(self) -> Iterator[CirclePointIndex]:
        """Half-coset indices followed by their conjugates, in ``at()``
        order (reference poly/circle/domain.ts iterIndices; the Rust
        conjugate negates the step, so position i here equals
        ``index_at(i)`` — the TS version iterates the conjugate with a
        positive step, which breaks that identity and is not ported)."""
        yield from self.half_coset.iter_indices()
        for idx in self.half_coset.iter_indices():
            yield -idx

    def iter(self) -> Iterator[CirclePoint[M31]]:
        for idx in self.iter_indices():
            yield idx.to_point()

    def __iter__(self) -> Iterator[CirclePoint[M31]]:
        return self.iter()

    def shift(self, shift_size: CirclePointIndex) -> "CircleDomain":
        return CircleDomain(self.half_coset.shift(shift_size))

    def split(self, log_parts: int):
        """Split into 2^log_parts subdomains + shifts (SIMD quotient layout)."""
        sub = CircleDomain(
            Coset.new(self.half_coset.initial_index,
                      self.half_coset.log_size - log_parts))
        shifts = [self.half_coset.step_size.scale(i) for i in range(1 << log_parts)]
        return sub, shifts


@dataclass(frozen=True, slots=True)
class CanonicCoset:
    """The coset G_{2n} + <G_n> whose domain is FFT-friendly (circle.ts:317)."""

    log_size: int

    def __post_init__(self):
        if self.log_size <= 0:
            raise ValueError("log_size must be positive")

    @staticmethod
    def new(log_size: int) -> "CanonicCoset":
        return CanonicCoset(log_size)

    @property
    def coset(self) -> Coset:
        return Coset.odds(self.log_size)

    def half_coset(self) -> Coset:
        return Coset.half_odds(self.log_size - 1)

    def circle_domain(self) -> CircleDomain:
        return CircleDomain(self.half_coset())

    def size(self) -> int:
        return 1 << self.log_size

    def initial_index(self) -> CirclePointIndex:
        return self.coset.initial_index

    def step_size(self) -> CirclePointIndex:
        return self.coset.step_size

    def step(self) -> CirclePoint[M31]:
        return self.coset.step

    def index_at(self, i: int) -> CirclePointIndex:
        return self.coset.index_at(i)

    def at(self, i: int) -> CirclePoint[M31]:
        return self.coset.at(i)
