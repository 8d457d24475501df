// Arithmetic in the Starknet prime field, p = 2^251 + 17 * 2^192 + 1, and
// the Hades permutation over it (Poseidon252: m = 3, 8 full and 83 partial
// rounds, S-box x^3, MDS [[3,1,1],[1,-1,1],[1,1,-2]]).
//
// The counterpart of tstwo_tpu/ops/poseidon252.py, which spreads a felt over
// 21 limbs of 12 bits because a TPU lane has no wide multiply.  Hopper has a
// 32 x 32 -> 64 multiply-add, so here a felt is eight 32-bit words, least
// significant first, and a product is 64 of those multiply-adds.
//
// Products are Montgomery products with R = 2^256.  In 32-bit words p is
// {w0: 1, w6: 17, w7: 2^27} and p == 1 (mod 2^32), so the Montgomery factor
// of a step is m = -t[i] and m * p touches word i (where it cancels t[i]) and
// words i+6 .. i+8 only: the reduction is one pass of 64-bit sums over the
// 16 product words.  Every function takes and returns values below p
// (`felt_mont_mul`: in Montgomery form if its inputs are).
//
// The functions compile for the host as well, so that the arithmetic can be
// held against Python integers without a GPU.
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

// a * b / 2^256 mod p.
TSTWO_HD Felt felt_mont_mul(const Felt& a, const Felt& b) {
  // the 16-word product, row by row
  uint32_t t[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) t[i] = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t carry = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      // (2^32 - 1)^2 + 2 (2^32 - 1) = 2^64 - 1: no overflow
      const uint64_t acc = static_cast<uint64_t>(a.w[i]) * b.w[j] + t[i + j] + carry;
      t[i + j] = static_cast<uint32_t>(acc);
      carry = acc >> 32;
    }
    t[i + 8] = static_cast<uint32_t>(carry);
  }
  // Step i adds m_i * p * 2^(32 i) with m_i = -(word i as it stands): word i
  // becomes 0 and m_i * (17 * 2^192 + 2^251) lands on words i+6, i+7, i+8 as
  // u0, u1, u2 (the high bits of 17 m_i and the low bits of m_i << 27 do not
  // overlap).  One pass from word 0 up with a running 64-bit sum does all 8
  // steps; a word receives at most five 32-bit terms and the carry.
  uint32_t u0[8], u1[8], u2[8];
  uint64_t acc = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    acc += t[i];
    if (i >= 6) acc += u0[i - 6];
    if (i >= 7) acc += u1[i - 7];
    const uint32_t m = 0u - static_cast<uint32_t>(acc);
    acc += m;  // the low word is now 0
    acc >>= 32;
    const uint64_t m17 = static_cast<uint64_t>(m) * 17u;
    u0[i] = static_cast<uint32_t>(m17);
    u1[i] = static_cast<uint32_t>(m17 >> 32) | (m << 27);
    u2[i] = m >> 5;
  }
  Felt r;
#pragma unroll
  for (int k = 8; k < 16; ++k) {
    acc += t[k];
    if (k <= 13) acc += u0[k - 6];
    if (k <= 14) acc += u1[k - 7];
    acc += u2[k - 8];
    r.w[k - 8] = static_cast<uint32_t>(acc);
    acc >>= 32;
  }
  // (a b + m p) / 2^256 < p^2 / 2^256 + p < 2p < 2^253: acc is 0 here
  return felt_cond_sub_p(r);
}

TSTWO_HD Felt felt_cube(const Felt& a) {
  return felt_mont_mul(felt_mont_mul(a, a), a);
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
