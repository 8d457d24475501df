// Batched Blake2s-256 of N equal-length messages, word-major.
//
// Replaces tstwo_tpu/ops/blake2s.py::_hash_words_major_pallas_impl
// (kernel bodies _wm_kernel and _wm_kernel_fori).
//
// What bounds it on the H100: integer operations.  A 64-byte block costs
// 10 rounds x 8 G-mixes x 14 add/xor/rotate ops per message against 64
// bytes read, so the ALUs, not device memory, set the rate.  The design
// spends no instruction on anything else: one thread per message, the 16
// state and 16 message words in registers, rotations as one funnel shift
// each, and the message schedule (SIGMA) written out per round so every
// message-word index is a compile-time constant.  Loads are coalesced:
// words are word-major [W, N], so thread i reads words[w * N + i].
//
// Semantics: unkeyed Blake2s-256 (hashlib.blake2s).  Block count, byte
// counter t and final flag are as in _wm_kernel: W = 16 * n_blocks words,
// t = 64 * (b + 1) for a middle block and byte_len for the last one.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ uint32_t rotr(uint32_t x, int r) {
  return __funnelshift_r(x, x, r);
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

__device__ __forceinline__ void compress(uint32_t h[8], const uint32_t m[16],
                                         uint64_t t, bool final) {
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

constexpr int kThreads = 128;

__global__ void blake2s_kernel(const uint32_t* __restrict__ words,
                               uint32_t* __restrict__ out, int n_blocks,
                               long long n, long long byte_len) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  // h0 = IV ^ parameter block (digest length 32, fanout 1, depth 1)
  uint32_t h[8] = {B2S_IV0 ^ 0x01010020u, B2S_IV1, B2S_IV2, B2S_IV3,
                   B2S_IV4, B2S_IV5, B2S_IV6, B2S_IV7};
  for (int b = 0; b < n_blocks; ++b) {
    uint32_t m[16];
#pragma unroll
    for (int w = 0; w < 16; ++w) m[w] = words[static_cast<size_t>(16 * b + w) * n + i];
    const bool final = b == n_blocks - 1;
    const uint64_t t = final ? static_cast<uint64_t>(byte_len)
                             : static_cast<uint64_t>(b + 1) * 64u;
    compress(h, m, t, final);
  }
#pragma unroll
  for (int w = 0; w < 8; ++w) out[static_cast<size_t>(w) * n + i] = h[w];
}

}  // namespace

// words: [16 * n_blocks, n] int32 bit-views of u32; out: [8, n].
// Returns the cudaError_t of the launch, or 0.
extern "C" int tstwo_blake2s(const int32_t* words, int32_t* out, int n_blocks,
                             long long n, long long byte_len, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const unsigned grid = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  blake2s_kernel<<<grid, kThreads, 0, stream>>>(
      reinterpret_cast<const uint32_t*>(words), reinterpret_cast<uint32_t*>(out),
      n_blocks, n, byte_len);
  return cudaGetLastError();
}
