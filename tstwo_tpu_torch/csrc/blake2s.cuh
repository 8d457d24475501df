// The Blake2s-256 compress and the Fiat-Shamir transcript step, shared by
// csrc/blake2s.cu's kernels.  Compiles with g++ as well as with nvcc: on the
// card a rotation is one funnel shift, on the host two shifts, so
// tests/test_torch_blake2s_transcript_host.py builds this header with g++
// and holds the transcript step against hashlib.
#pragma once

#include <cstdint>

#if defined(__CUDACC__)
#define TSTWO_B2S_HD __host__ __device__ __forceinline__
#else
#define TSTWO_B2S_HD inline
#endif

namespace tstwo {

TSTWO_B2S_HD uint32_t rotr(uint32_t x, int r) {
#if defined(__CUDA_ARCH__)
  return __funnelshift_r(x, x, r);  // one funnel shift
#else
  return (x >> r) | (x << (32 - r));
#endif
}

#define B2S_G(a, b, c, d, x, y)         \
  v[a] = v[a] + v[b] + (x);             \
  v[d] = rotr(v[d] ^ v[a], 16);         \
  v[c] = v[c] + v[d];                   \
  v[b] = rotr(v[b] ^ v[c], 12);         \
  v[a] = v[a] + v[b] + (y);             \
  v[d] = rotr(v[d] ^ v[a], 8);          \
  v[c] = v[c] + v[d];                   \
  v[b] = rotr(v[b] ^ v[c], 7);

#define B2S_ROUND(s0, s1, s2, s3, s4, s5, s6, s7, s8, s9, s10, s11, s12, s13, s14, s15) \
  B2S_G(0, 4, 8, 12, m[s0], m[s1])                                                       \
  B2S_G(1, 5, 9, 13, m[s2], m[s3])                                                       \
  B2S_G(2, 6, 10, 14, m[s4], m[s5])                                                      \
  B2S_G(3, 7, 11, 15, m[s6], m[s7])                                                      \
  B2S_G(0, 5, 10, 15, m[s8], m[s9])                                                      \
  B2S_G(1, 6, 11, 12, m[s10], m[s11])                                                    \
  B2S_G(2, 7, 8, 13, m[s12], m[s13])                                                     \
  B2S_G(3, 4, 9, 14, m[s14], m[s15])

#define B2S_IV0 0x6A09E667u
#define B2S_IV1 0xBB67AE85u
#define B2S_IV2 0x3C6EF372u
#define B2S_IV3 0xA54FF53Au
#define B2S_IV4 0x510E527Fu
#define B2S_IV5 0x9B05688Cu
#define B2S_IV6 0x1F83D9ABu
#define B2S_IV7 0x5BE0CD19u

TSTWO_B2S_HD void compress(uint32_t h[8], const uint32_t m[16], uint64_t t,
                           bool final) {
  uint32_t v[16] = {h[0], h[1], h[2], h[3], h[4], h[5], h[6], h[7],
                    B2S_IV0, B2S_IV1, B2S_IV2, B2S_IV3,
                    B2S_IV4, B2S_IV5, B2S_IV6, B2S_IV7};
  v[12] ^= static_cast<uint32_t>(t);
  v[13] ^= static_cast<uint32_t>(t >> 32);
  if (final) v[14] = ~v[14];
  B2S_ROUND(0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15)
  B2S_ROUND(14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3)
  B2S_ROUND(11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4)
  B2S_ROUND(7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8)
  B2S_ROUND(9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13)
  B2S_ROUND(2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9)
  B2S_ROUND(12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11)
  B2S_ROUND(13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10)
  B2S_ROUND(6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5)
  B2S_ROUND(10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0)
#pragma unroll
  for (int i = 0; i < 8; ++i) h[i] ^= v[i] ^ v[i + 8];
}

// h0 = IV ^ parameter block (digest length 32, fanout 1, depth 1)
#define B2S_H0                                                      \
  {B2S_IV0 ^ 0x01010020u, B2S_IV1, B2S_IV2, B2S_IV3, B2S_IV4, B2S_IV5, \
   B2S_IV6, B2S_IV7}

constexpr uint32_t kM31 = 0x7FFFFFFFu;

// One transcript step (channel/device.py), the body of
// blake2s_transcript_kernel.  If msg_bytes >= 0, the mix
// digest' = blake2s(digest || msg), msg word i at msg[i * msg_stride], its
// bytes past msg_bytes not read, after which n_sent = 0; else n_sent is read
// from n_sent_in[0..1] (LE words).  Then k draws: h = blake2s(digest ||
// LE64(n_sent) || 0^24), n_sent += 1; a hash with any word >= 2P is rejected
// whole and drawn again, else its 8 words, x >= P reduced to x - P, go to
// draws[8i..8i+7].  The outputs may alias the inputs: every input is read
// before the first output is written.
TSTWO_B2S_HD void transcript_step(const uint32_t* digest_in,
                                  const uint32_t* n_sent_in,
                                  const uint32_t* msg, long long msg_stride,
                                  long long msg_bytes, uint32_t* digest_out,
                                  uint32_t* n_sent_out, uint32_t* draws,
                                  int k) {
  uint32_t d[8];
  for (int w = 0; w < 8; ++w) d[w] = digest_in[w];
  unsigned long long n_sent = 0;
  if (msg_bytes >= 0) {
    const long long total = 32 + msg_bytes;
    const long long n_blocks = (total + 63) / 64;
    const long long msg_words = (msg_bytes + 3) / 4;
    uint32_t h[8] = B2S_H0;
    for (long long b = 0; b < n_blocks; ++b) {
      uint32_t m[16];
#pragma unroll
      for (int w = 0; w < 16; ++w) {
        const long long i = 16 * b + w - 8;  // word i of msg
        uint32_t word = 0;
        if (b == 0 && w < 8) {
          word = d[w];
        } else if (i < msg_words) {
          word = msg[i * msg_stride];
          const long long tail = msg_bytes - 4 * i;  // bytes left
          if (tail < 4) word &= (1u << (8 * tail)) - 1u;
        }
        m[w] = word;
      }
      const bool last = b == n_blocks - 1;
      compress(h, m, last ? static_cast<uint64_t>(total)
                          : static_cast<uint64_t>(b + 1) * 64u, last);
    }
    for (int w = 0; w < 8; ++w) d[w] = h[w];
  } else {
    n_sent = static_cast<unsigned long long>(n_sent_in[0]) |
             static_cast<unsigned long long>(n_sent_in[1]) << 32;
  }
  for (int i = 0; i < k; ++i) {
    uint32_t h[8];
    bool rejected;
    do {
      const uint32_t m[16] = {d[0], d[1], d[2], d[3], d[4], d[5], d[6], d[7],
                              static_cast<uint32_t>(n_sent),
                              static_cast<uint32_t>(n_sent >> 32),
                              0u, 0u, 0u, 0u, 0u, 0u};
      const uint32_t h0[8] = B2S_H0;
      for (int w = 0; w < 8; ++w) h[w] = h0[w];
      compress(h, m, 64, true);
      ++n_sent;
      rejected = false;
      for (int w = 0; w < 8; ++w) rejected |= h[w] >= 2 * kM31;
    } while (rejected);
    for (int w = 0; w < 8; ++w) draws[8 * i + w] = h[w] >= kM31 ? h[w] - kM31 : h[w];
  }
  for (int w = 0; w < 8; ++w) digest_out[w] = d[w];
  n_sent_out[0] = static_cast<uint32_t>(n_sent);
  n_sent_out[1] = static_cast<uint32_t>(n_sent >> 32);
}

}  // namespace tstwo
