// Batched Blake2s-256 of N equal-length messages, word-major, the Merkle
// layers built from it, the proof-of-work grind (blake2s_grind_kernel) and
// the Fiat-Shamir transcript step (blake2s_transcript_kernel).
//
// Replaces tstwo_tpu/ops/blake2s.py::_hash_words_major_pallas_impl
// (kernel bodies _wm_kernel and _wm_kernel_fori) and, on the Merkle path,
// the tstwo_tpu/ops/pallas/interleave.py::deinterleave_pallas call that
// split the child layer in front of it.
//
// What bounds it on the H100: integer operations.  A 64-byte block costs
// 10 rounds x 8 G-mixes x 12 add/xor/rotate operations per message
// against 64 bytes read, so the ALUs, not device memory, set the rate.
// The compress (csrc/blake2s.cuh) spends no instruction on anything else:
// one thread per message, the 16 state and 16 message words in registers,
// rotations as one funnel shift each, and the message schedule (SIGMA)
// written out per round so every message-word index is a compile-time
// constant.
//
// What the Merkle path lost was around the compress: a deinterleave of the
// child layer, a concatenation with the columns, a zero padding, each a
// pass through device memory and a launch.  So a thread builds its message
// itself:
//   * words 0-15 of a node from the child layer prev[8, 2n]: one aligned
//     8-byte load prev[w, 2i..2i+1] is word w of the left and of the right
//     child, coalesced across threads;
//   * then the rows of the columns that join at this layer, read where
//     they lie: a by-value table of (pointer, row stride, rows) segments,
//     walked in order by a cursor that is the same for every thread (a
//     block that lies within one segment is 16 loads at constant offsets);
//   * words past the message are zero constants, never loaded.
// The top of a tree, where a layer is smaller than the card, is one launch
// of one block (merkle_tail_kernel): every level from the first of at most
// 2^kMaxTailLog nodes down to the root, the level just hashed kept in
// shared memory, __syncthreads() between levels.
//
// Semantics: unkeyed Blake2s-256 (hashlib.blake2s).  Block count, byte
// counter t and final flag are as in _wm_kernel: n_blocks = max(1,
// ceil(byte_len / 64)), t = 64 * (b + 1) for a middle block and byte_len
// for the last one.  node = blake2s(left || right || LE32(column values)).
#include <cuda_runtime.h>

#include <cstdint>

#include "blake2s.cuh"
#include "segments.cuh"

namespace {

using tstwo::Cursor;
using tstwo::Segments;
using tstwo::compress;
using tstwo::open_segment;

constexpr int kThreads = 128;
constexpr int kTailThreads = 1024;
constexpr int kMaxTailLog = 12;  // first tail level: at most 2^12 nodes

__device__ __forceinline__ uint64_t block_counter(int b, int n_blocks,
                                                  long long byte_len) {
  return b == n_blocks - 1 ? static_cast<uint64_t>(byte_len)
                           : static_cast<uint64_t>(b + 1) * 64u;
}

// Message i = [left child || right child, if prev] || segment rows in order
// || zeros up to 16 * n_blocks words.  prev: [8, 2n] words, 8-byte aligned.
__global__ void blake2s_layer_kernel(const uint32_t* __restrict__ prev,
                                     const __grid_constant__ Segments segs,
                                     uint32_t* __restrict__ out, int n_blocks,
                                     long long n, long long byte_len) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t h[8] = B2S_H0;
  Cursor c = {nullptr, 0, 0, 0};
  open_segment(c, segs, i);
  for (int b = 0; b < n_blocks; ++b) {
    uint32_t m[16];
    if (b == 0 && prev != nullptr) {
#pragma unroll
      for (int w = 0; w < 8; ++w) {
        const uint2 pair =
            reinterpret_cast<const uint2*>(prev + static_cast<size_t>(w) * 2 * n)[i];
        m[w] = pair.x;
        m[8 + w] = pair.y;
      }
    } else if (c.left >= 16) {
      // a whole block from one segment: 16 loads at constant row offsets
#pragma unroll
      for (int w = 0; w < 16; ++w) m[w] = c.p[w * c.stride];
      c.p += 16 * c.stride;
      c.left -= 16;
      if (c.left == 0) open_segment(c, segs, i);
    } else {
#pragma unroll
      for (int w = 0; w < 16; ++w) {
        uint32_t word = 0;
        if (c.left > 0) {
          word = *c.p;
          c.p += c.stride;
          if (--c.left == 0) open_segment(c, segs, i);
        }
        m[w] = word;
      }
    }
    compress(h, m, block_counter(b, n_blocks, byte_len), b == n_blocks - 1);
  }
#pragma unroll
  for (int w = 0; w < 8; ++w) out[static_cast<size_t>(w) * n + i] = h[w];
}

// One block hashes the levels log - 1, ..., 0 above prev[8, 2^log]: every
// node the 64-byte message left || right.  out is [8, 2^log - 1]: level l
// is its columns 2^log - 2^(l+1) ... + 2^l, the levels side by side, largest
// first.  Each level also goes into shared memory, where the next level
// reads its children: buf holds two levels, 8 * 2^(log-1) and 8 * 2^(log-2)
// words, used in turn.
__global__ void __launch_bounds__(kTailThreads)
merkle_tail_kernel(const uint32_t* __restrict__ prev, uint32_t* __restrict__ out,
                   int log) {
  extern __shared__ __align__(16) uint32_t buf[];
  const uint32_t* src = prev;
  uint32_t* dst = buf;
  uint32_t* other = buf + (static_cast<size_t>(8) << (log - 1));
  for (int level = log - 1; level >= 0; --level) {
    const int n = 1 << level;
    const int total = (1 << log) - 1;
    uint32_t* level_out = out + (total + 1 - 2 * n);
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      uint32_t h[8] = B2S_H0;
      uint32_t m[16];
#pragma unroll
      for (int w = 0; w < 8; ++w) {
        const uint2 pair = reinterpret_cast<const uint2*>(src + w * 2 * n)[i];
        m[w] = pair.x;
        m[8 + w] = pair.y;
      }
      compress(h, m, 64, true);
#pragma unroll
      for (int w = 0; w < 8; ++w) {
        dst[w * n + i] = h[w];
        level_out[w * total + i] = h[w];
      }
    }
    __syncthreads();
    src = dst;
    uint32_t* const next = other;
    other = dst;
    dst = next;
  }
}

// Proof-of-work grind: thread i hashes nonce = start + i, the one-block
// 40-byte message digest || LE64(nonce) (t = 40, final), and counts the
// trailing zeros of digest words 0-3 as one LE u128 (128 when all four are
// zero).  A nonce with at least pow_bits of them goes into *best by
// atomicMin, so the least hit of the launch wins whichever block finds its
// hit first.  *best starts at all ones; a block whose first nonce lies
// above it returns at once (a hit below exists).
//
// Replaces tstwo_tpu/proof_of_work.py::_grind_batch around
// tstwo_tpu/ops/blake2s.py::_hash_words_major_pallas_impl: the [10, N]
// message it builds is never materialised here.  The digest words are a
// by-value argument, every message word past the nonce a zero constant:
// one compress of integer operations per nonce and 8 bytes written for the
// whole launch, so the integer lanes bound it, as they bound the layers.
struct GrindDigest {
  uint32_t w[8];
};

__global__ void __launch_bounds__(kThreads)
blake2s_grind_kernel(const GrindDigest digest, unsigned long long start,
                     long long count, int pow_bits,
                     unsigned long long* __restrict__ best) {
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x;
  if (*reinterpret_cast<volatile unsigned long long*>(best) <
      start + static_cast<unsigned long long>(first))
    return;
  const long long i = first + threadIdx.x;
  if (i >= count) return;
  const unsigned long long nonce = start + static_cast<unsigned long long>(i);
  uint32_t m[16] = {digest.w[0], digest.w[1], digest.w[2], digest.w[3],
                    digest.w[4], digest.w[5], digest.w[6], digest.w[7],
                    static_cast<uint32_t>(nonce), static_cast<uint32_t>(nonce >> 32),
                    0u, 0u, 0u, 0u, 0u, 0u};
  uint32_t h[8] = B2S_H0;
  compress(h, m, 40, true);
  int tz = 128;
#pragma unroll
  for (int w = 3; w >= 0; --w)
    if (h[w] != 0) tz = 32 * w + __ffs(h[w]) - 1;
  if (tz >= pow_bits) atomicMin(best, nonce);
}

// The Blake2s Fiat-Shamir transcript on the device: one launch is an
// optional mix and then k >= 0 draws, so an FRI layer (mix its root, draw
// alpha) is one launch and the host never reads the state in between.
//
// Replaces tstwo_tpu/channel/device.py::mix_root (:59), mix_u64, mix_felts
// and draw_base_felts (:89), jitted programs with no pallas_call, whose
// whole-hash rejection is a lax.while_loop; here it is a loop in the thread.
//
// The chain is sequential: each hash reads the digest the one before wrote.
// So one block of one thread carries it, its state in registers, and what
// bounds it is the latency of its compresses, each a dependent chain of
// operations, not bytes or the card's rate: a launch's floor, like
// merkle_tail's.
//
//   mix:  digest' = blake2s(digest || msg), msg_bytes >= 0 bytes, then
//         n_sent = 0 (channel/blake2s.py mix_root / mix_u32s / mix_felts);
//   draw: h = blake2s(digest || LE64(n_sent) || 0^24), n_sent += 1; if any
//         word of h is >= 2P the whole hash is rejected and drawn again,
//         else the 8 words, x >= P reduced to x - P, are the draw.
// State: digest words [8] and n_sent as two LE words [2] (out may alias in);
// csrc/blake2s.cuh::transcript_step is the body, which g++ also compiles.
__global__ void __launch_bounds__(1)
blake2s_transcript_kernel(const uint32_t* digest_in, const uint32_t* n_sent_in,
                          const uint32_t* __restrict__ msg, long long msg_stride,
                          long long msg_bytes, uint32_t* digest_out,
                          uint32_t* n_sent_out, uint32_t* __restrict__ draws,
                          int k) {
  tstwo::transcript_step(digest_in, n_sent_in, msg, msg_stride, msg_bytes,
                         digest_out, n_sent_out, draws, k);
}

}  // namespace

// One layer of n messages.  prev: the child layer [8, 2n] (8-byte aligned)
// or null; seg_ptrs / seg_strides / seg_rows: n_segs <= 16 word-major row
// segments (host arrays, null if there is none), appended to the message in
// order; out: [8, n].
// All words are int32 bit-views of u32.  byte_len is the message length;
// the words given must not exceed 16 * max(1, ceil(byte_len / 64)).
// Returns the cudaError_t of the launch, or 0; cudaErrorInvalidValue for
// arguments the kernel does not take.
extern "C" int tstwo_blake2s_layer(const int32_t* prev, const void* const* seg_ptrs,
                                   const long long* seg_strides, const int* seg_rows,
                                   int n_segs, int32_t* out, long long n,
                                   long long byte_len, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n <= 0 || byte_len < 0 || reinterpret_cast<uintptr_t>(prev) % 8 != 0)
    return cudaErrorInvalidValue;
  Segments segs;
  const long long rows = tstwo::fill_segments(segs, seg_ptrs, seg_strides, seg_rows, n_segs);
  if (rows < 0) return cudaErrorInvalidValue;
  const long long words = rows + (prev != nullptr ? 16 : 0);
  const long long n_blocks = byte_len > 64 ? (byte_len + 63) / 64 : 1;
  if (words > 16 * n_blocks || n_blocks > (1 << 20)) return cudaErrorInvalidValue;
  const unsigned grid = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  blake2s_layer_kernel<<<grid, kThreads, 0, stream>>>(
      reinterpret_cast<const uint32_t*>(prev), segs, reinterpret_cast<uint32_t*>(out),
      static_cast<int>(n_blocks), n, byte_len);
  return cudaGetLastError();
}

// The top of a tree in one launch.  prev: [8, 2^log] (8-byte aligned), 1 <=
// log <= kMaxTailLog + 1; out: [8, 2^log - 1], the levels log - 1 ... 0 side
// by side, level l the next 2^l columns.
extern "C" int tstwo_merkle_tail(const int32_t* prev, int32_t* out, int log,
                                 void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (log < 1 || log > kMaxTailLog + 1 || reinterpret_cast<uintptr_t>(prev) % 8 != 0)
    return cudaErrorInvalidValue;
  // two levels in shared memory: 8 * (2^(log-1) + 2^(log-2)) words
  const size_t shared = 4 * ((static_cast<size_t>(8) << (log - 1)) +
                             (log >= 2 ? static_cast<size_t>(8) << (log - 2) : 0));
  static size_t allowed = 48 * 1024;
  if (shared > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        merkle_tail_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shared));
    if (err != cudaSuccess) return err;
    allowed = shared;
  }
  const int nodes = 1 << (log - 1);
  const int threads = nodes < kTailThreads ? (nodes + 31) / 32 * 32 : kTailThreads;
  merkle_tail_kernel<<<1, threads, shared, stream>>>(
      reinterpret_cast<const uint32_t*>(prev), reinterpret_cast<uint32_t*>(out), log);
  return cudaGetLastError();
}

// The least nonce in [start, start + count) whose digest has at least
// pow_bits trailing zeros goes into *best (device, u64), which the caller
// presets to all ones; it stays so if there is none.  digest: 8 host words
// (u32) of the channel digest, passed to the kernel by value.  count <=
// 2^40, start + count <= 2^64.
extern "C" int tstwo_blake2s_grind(const uint32_t* digest, unsigned long long start,
                                   long long count, int pow_bits,
                                   unsigned long long* best, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (digest == nullptr || best == nullptr || count <= 0 || count > (1LL << 40) ||
      pow_bits < 0 || start + static_cast<unsigned long long>(count - 1) < start)
    return cudaErrorInvalidValue;
  GrindDigest d;
  for (int w = 0; w < 8; ++w) d.w[w] = digest[w];
  const unsigned grid = static_cast<unsigned>((count + kThreads - 1) / kThreads);
  blake2s_grind_kernel<<<grid, kThreads, 0, stream>>>(d, start, count, pow_bits, best);
  return cudaGetLastError();
}

// One transcript step on the device: if msg_bytes >= 0, the mix of the
// msg_bytes bytes at msg (device words msg_stride apart, as a Merkle root
// lies in its layer; msg null only when msg_bytes is 0),
// which resets n_sent; else n_sent is read from n_sent_in (device, two LE
// words).  Then k >= 0 draws of 8 words each into draws (device, [k, 8]).
// digest_in / digest_out: device [8] words; n_sent_out: device [2]; the
// outputs may alias the inputs.  All words are int32 bit-views of u32.
extern "C" int tstwo_blake2s_transcript(const int32_t* digest_in,
                                        const int32_t* n_sent_in,
                                        const int32_t* msg, long long msg_stride,
                                        long long msg_bytes,
                                        int32_t* digest_out, int32_t* n_sent_out,
                                        int32_t* draws, int k, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (digest_in == nullptr || digest_out == nullptr || n_sent_out == nullptr ||
      k < 0 || (k > 0 && draws == nullptr) ||
      (msg_bytes < 0 && n_sent_in == nullptr) ||
      (msg_bytes > 0 && msg == nullptr) || msg_bytes > (1LL << 36))
    return cudaErrorInvalidValue;
  blake2s_transcript_kernel<<<1, 1, 0, stream>>>(
      reinterpret_cast<const uint32_t*>(digest_in),
      reinterpret_cast<const uint32_t*>(n_sent_in),
      reinterpret_cast<const uint32_t*>(msg), msg_stride, msg_bytes,
      reinterpret_cast<uint32_t*>(digest_out),
      reinterpret_cast<uint32_t*>(n_sent_out),
      reinterpret_cast<uint32_t*>(draws), k);
  return cudaGetLastError();
}
