// Arithmetic in the Starknet prime field, p = 2^251 + 17 * 2^192 + 1, and
// the Hades permutation over it (Poseidon252: m = 3, 8 full and 83 partial
// rounds, S-box x^3, MDS [[3,1,1],[1,-1,1],[1,1,-2]]).
//
// The counterpart of tstwo_tpu/ops/poseidon252.py, which spreads a felt over
// 21 limbs of 12 bits because a TPU lane has no wide multiply.  Hopper has
// a 32 x 32 + 64 -> 64 multiply-add (IMAD.WIDE.U32) and adds with a carry
// flag, so here a felt is eight 32-bit words, least significant first, and
// a product is 64 wide multiply-adds and 64 adds with carry.
//
// Products are Montgomery products with R = 2^256.  Every function takes and
// returns values below p (`felt_mont_mul`, `felt_mont_sqr`: in Montgomery
// form if their inputs are).  The product and the square are written in
// primitives of one PTX instruction each (mad.wide.u32, and the carry chains
// of add.cc / addc.cc / sub.cc / subc): on the card each is that
// instruction, on the host the same instruction emulated with its carry
// flag in a `Carry`.  So the host runs the very sequence of
// operations the card runs, which lets g++ hold it against Python integers
// (tests/test_torch_felt252_host.py), and, built with
// -DTSTWO_FELT_COUNT_OPS, counts the instructions of a product, a square and
// a permutation (tests/test_torch_felt252_source_count.py).
#pragma once

#include <cstdint>

#if defined(__CUDACC__)
#define TSTWO_HD __host__ __device__ __forceinline__
#else
#define TSTWO_HD inline
#endif

namespace tstwo {

struct Felt {
  uint32_t w[8];
};

constexpr int kHadesRounds = 91;      // 4 full, 83 partial, 4 full
constexpr int kHadesHalfFull = 4;
// The constants a Hades kernel reads, as felts of 8 words: the 91 x 3 round
// constants in Montgomery form, then R^2 mod p (into Montgomery form) and
// R mod p (the felt 1 in Montgomery form).
constexpr int kHadesArkFelts = kHadesRounds * 3;
constexpr int kHadesR2 = kHadesArkFelts;
constexpr int kHadesOne = kHadesArkFelts + 1;
constexpr int kHadesConstFelts = kHadesArkFelts + 2;

// Word i of p.
TSTWO_HD constexpr uint32_t felt_p_word(int i) {
  return i == 0 ? 1u : i == 6 ? 17u : i == 7 ? 0x08000000u : 0u;
}

TSTWO_HD Felt felt_zero() {
  Felt r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.w[i] = 0;
  return r;
}

TSTWO_HD Felt felt_load(const uint32_t* words) {
  Felt r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.w[i] = words[i];
  return r;
}

// a - p if a >= p, else a; for a < 2p.
TSTWO_HD Felt felt_cond_sub_p(const Felt& a) {
  Felt d;
  uint64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint64_t v = static_cast<uint64_t>(a.w[i]) - felt_p_word(i) - borrow;
    d.w[i] = static_cast<uint32_t>(v);
    borrow = v >> 63;
  }
  Felt r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.w[i] = borrow ? a.w[i] : d.w[i];
  return r;
}

// (a + b) mod p; the sum is below 2p < 2^253.
TSTWO_HD Felt felt_add(const Felt& a, const Felt& b) {
  Felt s;
  uint64_t carry = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint64_t v = static_cast<uint64_t>(a.w[i]) + b.w[i] + carry;
    s.w[i] = static_cast<uint32_t>(v);
    carry = v >> 32;
  }
  return felt_cond_sub_p(s);
}

// (a - b) mod p: a - b, plus p if that borrowed.
TSTWO_HD Felt felt_sub(const Felt& a, const Felt& b) {
  Felt d;
  uint64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint64_t v = static_cast<uint64_t>(a.w[i]) - b.w[i] - borrow;
    d.w[i] = static_cast<uint32_t>(v);
    borrow = v >> 63;
  }
  Felt r;
  uint64_t carry = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint64_t v = static_cast<uint64_t>(d.w[i]) + (borrow ? felt_p_word(i) : 0u) + carry;
    r.w[i] = static_cast<uint32_t>(v);
    carry = v >> 32;
  }
  return r;
}

// --- Extended-precision primitives ---------------------------------------
// One PTX instruction each.  PTX keeps the carry flag of a chain (.cc sets
// it, addc / subc read it) in the hardware between the statements;
// the host keeps it in `c`.  A chain is written as consecutive calls with no
// other chain between them.  Subtraction's flag is the borrow.

#if defined(TSTWO_FELT_COUNT_OPS) && !defined(__CUDA_ARCH__)
inline unsigned long long felt_op_count = 0;
#define TSTWO_OP() (++::tstwo::felt_op_count)
#else
#define TSTWO_OP() ((void)0)
#endif

struct Carry {
  uint32_t flag = 0;
};

#if !defined(__CUDA_ARCH__)
inline uint32_t host_add(uint32_t a, uint32_t b, uint32_t cin, Carry& c) {
  const uint64_t s = static_cast<uint64_t>(a) + b + cin;
  c.flag = static_cast<uint32_t>(s >> 32);
  return static_cast<uint32_t>(s);
}
inline uint32_t host_sub(uint32_t a, uint32_t b, uint32_t bin, Carry& c) {
  const uint64_t d = static_cast<uint64_t>(a) - b - bin;
  c.flag = static_cast<uint32_t>(d >> 63);
  return static_cast<uint32_t>(d);
}
#endif

#if defined(__CUDA_ARCH__)
#define TSTWO_PTX3(op, a, b) \
  uint32_t d;                \
  asm volatile(op " %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b)); \
  return d
#endif

TSTWO_HD uint32_t shl(uint32_t a, int n) {
  TSTWO_OP();
  return a << n;
}
TSTWO_HD uint32_t shr(uint32_t a, int n) {
  TSTWO_OP();
  return a >> n;
}
// the high word of (hi:lo) << n, 0 < n < 32
TSTWO_HD uint32_t funnel(uint32_t hi, uint32_t lo, int n) {
  TSTWO_OP();
#if defined(__CUDA_ARCH__)
  return __funnelshift_l(lo, hi, n);
#else
  return (hi << n) | (lo >> (32 - n));
#endif
}
TSTWO_HD uint32_t and_(uint32_t a, uint32_t b) {
  TSTWO_OP();
  return a & b;
}
// all ones if bit 31 of a is set, else 0
TSTWO_HD uint32_t sign_mask(uint32_t a) {
  TSTWO_OP();
  return static_cast<uint32_t>(static_cast<int32_t>(a) >> 31);
}

TSTWO_HD uint32_t add_cc(uint32_t a, uint32_t b, Carry& c) {
  TSTWO_OP();
#if defined(__CUDA_ARCH__)
  TSTWO_PTX3("add.cc.u32", a, b);
#else
  return host_add(a, b, 0, c);
#endif
}
TSTWO_HD uint32_t addc_cc(uint32_t a, uint32_t b, Carry& c) {
  TSTWO_OP();
#if defined(__CUDA_ARCH__)
  TSTWO_PTX3("addc.cc.u32", a, b);
#else
  return host_add(a, b, c.flag, c);
#endif
}
TSTWO_HD uint32_t addc(uint32_t a, uint32_t b, Carry& c) {
  TSTWO_OP();
#if defined(__CUDA_ARCH__)
  TSTWO_PTX3("addc.u32", a, b);
#else
  Carry out;
  return host_add(a, b, c.flag, out);
#endif
}
TSTWO_HD uint32_t sub_cc(uint32_t a, uint32_t b, Carry& c) {
  TSTWO_OP();
#if defined(__CUDA_ARCH__)
  TSTWO_PTX3("sub.cc.u32", a, b);
#else
  return host_sub(a, b, 0, c);
#endif
}
TSTWO_HD uint32_t subc_cc(uint32_t a, uint32_t b, Carry& c) {
  TSTWO_OP();
#if defined(__CUDA_ARCH__)
  TSTWO_PTX3("subc.cc.u32", a, b);
#else
  return host_sub(a, b, c.flag, c);
#endif
}
TSTWO_HD uint32_t subc(uint32_t a, uint32_t b, Carry& c) {
  TSTWO_OP();
#if defined(__CUDA_ARCH__)
  TSTWO_PTX3("subc.u32", a, b);
#else
  Carry out;
  return host_sub(a, b, c.flag, out);
#endif
}
// a * b + x in 64 bits, one IMAD.WIDE.U32; x < 2^32 in every call, so the
// sum never wraps
TSTWO_HD uint64_t mad_wide(uint32_t a, uint32_t b, uint64_t x) {
  TSTWO_OP();
#if defined(__CUDA_ARCH__)
  uint64_t d;
  asm("mad.wide.u32 %0, %1, %2, %3;" : "=l"(d) : "r"(a), "r"(b), "l"(x));
  return d;
#else
  return static_cast<uint64_t>(a) * b + x;
#endif
}
TSTWO_HD uint32_t lo(uint64_t v) { return static_cast<uint32_t>(v); }
TSTWO_HD uint32_t hi(uint64_t v) { return static_cast<uint32_t>(v >> 32); }

// --- Montgomery product and square --------------------------------------

// t = a * b, 16 words, row by row.  Row i forms the 64-bit sums
// P_j = a_j b_i + t[i+j] (one mad.wide each, which cannot overflow) and adds
// them in at word i in one chain: word i+j takes lo(P_j) + hi(P_j-1).  After
// row i the sum fits in words 0 .. i+8, so the chain never carries out of
// its last word.  16 instructions a row, 128 in all.
TSTWO_HD void felt_wide_mul(const Felt& a, const Felt& b, uint32_t t[16]) {
  Carry c;
  uint64_t p[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) p[j] = mad_wide(a.w[j], b.w[i], i == 0 ? 0u : t[i + j]);
    t[i] = lo(p[0]);
    t[i + 1] = add_cc(lo(p[1]), hi(p[0]), c);
#pragma unroll
    for (int j = 2; j < 8; ++j) t[i + j] = addc_cc(lo(p[j]), hi(p[j - 1]), c);
    t[i + 8] = addc(hi(p[7]), 0u, c);
  }
}

// t = a^2, 16 words: the 28 cross products a_i a_j (i < j) row by row as in
// felt_wide_mul (55 instructions), doubled by a one-bit funnel shift of
// words 1 .. 14 (14), then the 8 squares a_i^2 added at words 2i, 2i+1 in
// one chain (23).  92 instructions.
TSTWO_HD void felt_wide_sqr(const Felt& a, uint32_t t[16]) {
  Carry c;
  uint64_t p[8];
#pragma unroll
  for (int i = 0; i < 7; ++i) {
    // row i: a_i a_j for j = i+1 .. 7, into words 2i+1 .. i+8
#pragma unroll
    for (int j = i + 1; j < 8; ++j) p[j] = mad_wide(a.w[i], a.w[j], i == 0 ? 0u : t[i + j]);
    t[2 * i + 1] = lo(p[i + 1]);
    if (i == 6) {
      t[14] = hi(p[7]);
    } else {
      t[2 * i + 2] = add_cc(lo(p[i + 2]), hi(p[i + 1]), c);
#pragma unroll
      for (int j = i + 3; j < 8; ++j) t[i + j] = addc_cc(lo(p[j]), hi(p[j - 1]), c);
      t[i + 8] = addc(hi(p[7]), 0u, c);
    }
  }
  // a < 2^252, so the cross sum is below 2^60 * 2^(32 * 13) and doubled it
  // still leaves word 15 at 0
#pragma unroll
  for (int k = 14; k >= 2; --k) t[k] = funnel(t[k], t[k - 1], 1);
  t[1] = shl(t[1], 1);
#pragma unroll
  for (int i = 0; i < 8; ++i) p[i] = mad_wide(a.w[i], a.w[i], 0u);
  t[0] = lo(p[0]);
  t[1] = add_cc(t[1], hi(p[0]), c);
#pragma unroll
  for (int i = 1; i < 7; ++i) {
    t[2 * i] = addc_cc(t[2 * i], lo(p[i]), c);
    t[2 * i + 1] = addc_cc(t[2 * i + 1], hi(p[i]), c);
  }
  t[14] = addc_cc(t[14], lo(p[7]), c);
  t[15] = addc(hi(p[7]), 0u, c);
}

// t / 2^256 mod p for t < p^2, in 54 instructions.  p = 1 + k * 2^192 with
// k = 17 + 2^59, so p == 1 (mod 2^192) and the Montgomery factor m = t / p
// (mod 2^256) is read off the words as they stand, with nothing computed:
// the result is (t - m p) / 2^256, which lies in (-p, p).
//   A: m_lo = t[0..5]; t - m_lo p zeroes words 0..5 and subtracts
//      X = m_lo * k (8 words: m_lo * 17 by mad.wide, plus m_lo << 59) at
//      word 6 (30);
//   B: m_hi = words 6, 7 as they now stand; subtracting m_hi * 2^192 zeroes
//      them, and Y = m_hi * k (4 words) comes off at word 12 (12);
//   words 8..15 are the result in two's complement: p is added back if it is
//      negative (12).  Borrows out of word 15 fall away (mod 2^512).
TSTWO_HD Felt felt_mont_reduce(uint32_t t[16]) {
  Carry c;
  uint32_t s[8], x[8];
  uint64_t q[6];
  s[1] = shl(t[0], 27);
#pragma unroll
  for (int j = 2; j < 7; ++j) s[j] = funnel(t[j - 1], t[j - 2], 27);
  s[7] = shr(t[5], 5);
#pragma unroll
  for (int j = 0; j < 6; ++j) q[j] = mad_wide(t[j], 17u, j == 0 ? 0u : s[j]);
  x[0] = lo(q[0]);
  x[1] = add_cc(lo(q[1]), hi(q[0]), c);
#pragma unroll
  for (int j = 2; j < 6; ++j) x[j] = addc_cc(lo(q[j]), hi(q[j - 1]), c);
  x[6] = addc_cc(s[6], hi(q[5]), c);
  x[7] = addc(s[7], 0u, c);
  t[6] = sub_cc(t[6], x[0], c);
#pragma unroll
  for (int j = 7; j < 14; ++j) t[j] = subc_cc(t[j], x[j - 6], c);
  t[14] = subc_cc(t[14], 0u, c);
  t[15] = subc(t[15], 0u, c);

  s[1] = shl(t[6], 27);
  s[2] = funnel(t[7], t[6], 27);
  s[3] = shr(t[7], 5);
  q[0] = mad_wide(t[6], 17u, 0u);
  q[1] = mad_wide(t[7], 17u, s[1]);
  uint32_t y[4];
  y[0] = lo(q[0]);
  y[1] = add_cc(lo(q[1]), hi(q[0]), c);
  y[2] = addc_cc(hi(q[1]), s[2], c);
  y[3] = addc(s[3], 0u, c);
  t[12] = sub_cc(t[12], y[0], c);
  t[13] = subc_cc(t[13], y[1], c);
  t[14] = subc_cc(t[14], y[2], c);
  t[15] = subc(t[15], y[3], c);

  const uint32_t neg = sign_mask(t[15]);
  Felt r;
  r.w[0] = add_cc(t[8], and_(neg, 1u), c);
#pragma unroll
  for (int k = 1; k < 6; ++k) r.w[k] = addc_cc(t[8 + k], 0u, c);
  r.w[6] = addc_cc(t[14], and_(neg, felt_p_word(6)), c);
  r.w[7] = addc(t[15], and_(neg, felt_p_word(7)), c);
  return r;
}

// a * b / 2^256 mod p: 182 instructions.
TSTWO_HD Felt felt_mont_mul(const Felt& a, const Felt& b) {
  uint32_t t[16];
  felt_wide_mul(a, b, t);
  return felt_mont_reduce(t);
}

// a^2 / 2^256 mod p: 146 instructions.
TSTWO_HD Felt felt_mont_sqr(const Felt& a) {
  uint32_t t[16];
  felt_wide_sqr(a, t);
  return felt_mont_reduce(t);
}

TSTWO_HD Felt felt_cube(const Felt& a) {
  return felt_mont_mul(felt_mont_sqr(a), a);
}

// The Hades permutation of a state in Montgomery form, in place.  consts:
// kHadesConstFelts felts, see above; every thread of a warp reads the same
// word of them at the same time.
TSTWO_HD void hades_permute(Felt s[3], const uint32_t* consts) {
#pragma unroll 1
  for (int r = 0; r < kHadesRounds; ++r) {
    const uint32_t* ark = consts + 24 * r;
#pragma unroll
    for (int k = 0; k < 3; ++k) s[k] = felt_add(s[k], felt_load(ark + 8 * k));
    if (r < kHadesHalfFull || r >= kHadesRounds - kHadesHalfFull) {
      s[0] = felt_cube(s[0]);
      s[1] = felt_cube(s[1]);
    }
    s[2] = felt_cube(s[2]);
    // MDS: with t = s0 + s1 + s2 the rows are t + 2 s0, t - 2 s1, t - 3 s2
    const Felt t = felt_add(felt_add(s[0], s[1]), s[2]);
    const Felt d2 = felt_add(s[2], s[2]);
    s[0] = felt_add(t, felt_add(s[0], s[0]));
    s[1] = felt_sub(t, felt_add(s[1], s[1]));
    s[2] = felt_sub(t, felt_add(d2, s[2]));
  }
}

// Eight M31 values (each below 2^31) as one felt: the first value highest,
// 31 bits each, 248 bits in all, so the felt is below p.
TSTWO_HD Felt felt_pack_m31(const uint32_t v[8]) {
  Felt r = felt_zero();
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int at = 31 * (7 - j);
    const uint64_t wide = static_cast<uint64_t>(v[j]) << (at % 32);
    r.w[at / 32] |= static_cast<uint32_t>(wide);
    if (at / 32 + 1 < 8) r.w[at / 32 + 1] |= static_cast<uint32_t>(wide >> 32);
  }
  return r;
}

}  // namespace tstwo
