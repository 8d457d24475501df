// The Poseidon252 hash on the card: the Hades permutation of a batch of
// states, one layer of a Poseidon252 Merkle tree, and the proof-of-work
// grind of a Poseidon252 channel (below the layer kernel).
//
// Counterparts of two jitted programs of the JAX package (no Pallas kernel
// is involved there): tstwo_tpu/ops/poseidon252.py::hades_permutation and
// tstwo_tpu/vcs/poseidon252_merkle.py::_commit_layer_device (with
// ops/poseidon252.py::pack_m31_columns and ::poseidon_hash_many inside it).
// Carried over as plain PyTorch a permutation is some 10^4 small launches;
// here it is a loop in registers.
//
// What bounds them on the H100: integer operations.  One permutation is 107
// cubes (8 full rounds of three, 83 partial rounds of one), each a square
// and a product with their reductions, and some 1100 modular additions,
// against 32 bytes written and at most a few hundred read per node.  So the
// design spends nothing on memory: one thread a state (a node), the three
// felts of the state in registers as 8 words each (felt252.cuh), the round
// constants in __constant__ memory, where a warp reads one word at a time
// for all its threads.  Values are converted to Montgomery form as they are
// absorbed and back once at the end, never inside the round loop.
//
// A node of a layer hashes, as the host's hash_node does, the sponge of rate
// 2 over [left child, right child (if there is a child layer), the column
// values at the node packed 8 to a felt (first value highest, 31 bits each,
// zero padded), 1, (0 to make the count even)].  The thread reads its two
// children from the child layer [8, 2n] and its column values through the
// same by-value table of segments as the Blake2s layer kernel (segments.cuh):
// no stack, concatenation or padding happens on the card.
//
// Felts in device memory are word-major: word w of felt i at base[w * n + i],
// int32 bit-views of u32, least significant word first; values below p.
#include <cuda_runtime.h>

#include <cstdint>

#include "felt252.cuh"
#include "segments.cuh"

namespace {

using tstwo::Cursor;
using tstwo::Felt;
using tstwo::Segments;

constexpr int kThreads = 128;

__constant__ uint32_t kHadesConsts[8 * tstwo::kHadesConstFelts];

__device__ __forceinline__ Felt const_felt(int index) {
  return tstwo::felt_load(kHadesConsts + 8 * index);
}

// out[k] = Hades(in)[k] for k = 0, 1, 2; in, out: [3, 8, n].
__global__ void __launch_bounds__(kThreads)
hades_permutation_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                         long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Felt r2 = const_felt(tstwo::kHadesR2);
  Felt s[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    Felt v;
#pragma unroll
    for (int w = 0; w < 8; ++w) v.w[w] = in[(static_cast<size_t>(k) * 8 + w) * n + i];
    s[k] = tstwo::felt_mont_mul(v, r2);
  }
  tstwo::hades_permute(s, kHadesConsts);
  Felt one = tstwo::felt_zero();
  one.w[0] = 1;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const Felt v = tstwo::felt_mont_mul(s[k], one);
#pragma unroll
    for (int w = 0; w < 8; ++w) out[(static_cast<size_t>(k) * 8 + w) * n + i] = v.w[w];
  }
}

// Node i of a layer of n nodes.  prev: the child layer [8, 2n] or null;
// n_cols: the rows of all segments together; out: [8, n].
__global__ void __launch_bounds__(kThreads)
poseidon_merkle_layer_kernel(const uint32_t* __restrict__ prev,
                             const __grid_constant__ Segments segs, int n_cols,
                             uint32_t* __restrict__ out, long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int n_children = prev != nullptr ? 2 : 0;
  const int n_blocks = (n_cols + 7) / 8;
  // the felts to absorb: children, blocks, the felt 1; then 0 if odd
  const int n_felts = n_children + n_blocks + 1;
  const Felt r2 = const_felt(tstwo::kHadesR2);
  Cursor c = {nullptr, 0, 0, 0};
  tstwo::open_segment(c, segs, i);
  Felt s[3] = {tstwo::felt_zero(), tstwo::felt_zero(), tstwo::felt_zero()};
#pragma unroll 1
  for (int f = 0; f < n_felts; f += 2) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = f + h;
      if (k >= n_felts) continue;  // the padding 0
      Felt v;
      if (k == n_felts - 1) {
        v = const_felt(tstwo::kHadesOne);
      } else {
        if (k < n_children) {
#pragma unroll
          for (int w = 0; w < 8; ++w) v.w[w] = prev[static_cast<size_t>(w) * 2 * n + 2 * i + k];
        } else {
          uint32_t m31[8];
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            uint32_t word = 0;
            if (c.left > 0) {
              word = *c.p;
              c.p += c.stride;
              if (--c.left == 0) tstwo::open_segment(c, segs, i);
            }
            m31[j] = word;
          }
          v = tstwo::felt_pack_m31(m31);
        }
        v = tstwo::felt_mont_mul(v, r2);
      }
      s[h] = tstwo::felt_add(s[h], v);
    }
    tstwo::hades_permute(s, kHadesConsts);
  }
  Felt one = tstwo::felt_zero();
  one.w[0] = 1;
  const Felt digest = tstwo::felt_mont_mul(s[0], one);
#pragma unroll
  for (int w = 0; w < 8; ++w) out[static_cast<size_t>(w) * n + i] = digest.w[w];
}

// Proof-of-work grind of a Poseidon252 channel: thread i takes nonce =
// start + i and computes the digest the channel's mix_u64(nonce) would set,
// poseidon_hash_many([digest, nonce]): the sponge over [digest, nonce, 1, 0],
// s = Hades(digest, nonce, 0), then Hades(s0 + 1, s1, s2), whose s0 is the
// new digest.  The channel's trailing_zeros reads a digest as 32 big-endian
// bytes and counts the trailing zeros of the first 16 as one little-endian
// u128: words 7, 6, 5, 4 of the felt, each byte-reversed, from the low end
// (128 when all four are zero).  A nonce with at least pow_bits of them goes
// into *best by atomicMin, so the least hit of the launch wins whichever
// block finds its hit first.  *best starts at all ones; a block whose first
// nonce lies above it returns at once (a hit below exists).
//
// Replaces no kernel of the JAX package, whose proof_of_work.py grinds a
// Poseidon252 channel on the host, one nonce at a time.  Two permutations a
// nonce and 8 bytes written a launch: integer operations bound it, as they
// bound the layers, and the design is theirs, one thread a state in
// registers.  The channel digest comes by value, into Montgomery form in
// each thread (one product beside the permutations' 214).
struct GrindFelt {
  uint32_t w[8];
};

__global__ void __launch_bounds__(kThreads)
poseidon_grind_kernel(const GrindFelt digest, unsigned long long start, long long count,
                      int pow_bits, unsigned long long* __restrict__ best) {
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x;
  if (*reinterpret_cast<volatile unsigned long long*>(best) <
      start + static_cast<unsigned long long>(first))
    return;
  const long long i = first + threadIdx.x;
  if (i >= count) return;
  const unsigned long long nonce = start + static_cast<unsigned long long>(i);
  const Felt r2 = const_felt(tstwo::kHadesR2);
  Felt v = tstwo::felt_load(digest.w);
  Felt s[3];
  s[0] = tstwo::felt_mont_mul(v, r2);
  v = tstwo::felt_zero();
  v.w[0] = static_cast<uint32_t>(nonce);
  v.w[1] = static_cast<uint32_t>(nonce >> 32);
  s[1] = tstwo::felt_mont_mul(v, r2);
  s[2] = tstwo::felt_zero();
  tstwo::hades_permute(s, kHadesConsts);
  s[0] = tstwo::felt_add(s[0], const_felt(tstwo::kHadesOne));
  tstwo::hades_permute(s, kHadesConsts);
  Felt one = tstwo::felt_zero();
  one.w[0] = 1;
  const Felt d = tstwo::felt_mont_mul(s[0], one);
  int tz = 128;
#pragma unroll
  for (int k = 3; k >= 0; --k) {
    const uint32_t word = __byte_perm(d.w[7 - k], 0, 0x0123);
    if (word != 0) tz = 32 * k + __ffs(word) - 1;
  }
  if (tz >= pow_bits) atomicMin(best, nonce);
}

}  // namespace

// Copies the constants of felt252.cuh (kHadesConstFelts felts of 8 words, a
// host array) to the current device.  Call once per device before a launch.
extern "C" int tstwo_poseidon_set_constants(const uint32_t* consts, int n_words) {
  if (consts == nullptr || n_words != 8 * tstwo::kHadesConstFelts)
    return cudaErrorInvalidValue;
  return cudaMemcpyToSymbol(kHadesConsts, consts, sizeof(kHadesConsts));
}

// The Hades permutation of n states.  in, out: [3, 8, n] words, values
// below p.  Returns the cudaError_t of the launch, or 0.
extern "C" int tstwo_hades_permutation(const int32_t* in, int32_t* out, long long n,
                                       void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (in == nullptr || out == nullptr || n <= 0) return cudaErrorInvalidValue;
  const unsigned grid = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  hades_permutation_kernel<<<grid, kThreads, 0, stream>>>(
      reinterpret_cast<const uint32_t*>(in), reinterpret_cast<uint32_t*>(out), n);
  return cudaGetLastError();
}

// One Merkle layer of n nodes.  prev: the child layer [8, 2n] or null;
// seg_ptrs / seg_strides / seg_rows: n_segs <= 16 row segments of canonical
// M31 values (host arrays, null if there is none), in hashing order; out:
// [8, n].  Returns the cudaError_t of the launch, or 0; cudaErrorInvalidValue
// for arguments the kernel does not take.
extern "C" int tstwo_poseidon_merkle_layer(const int32_t* prev, const void* const* seg_ptrs,
                                           const long long* seg_strides, const int* seg_rows,
                                           int n_segs, int32_t* out, long long n,
                                           void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (out == nullptr || n <= 0) return cudaErrorInvalidValue;
  Segments segs;
  const long long rows = tstwo::fill_segments(segs, seg_ptrs, seg_strides, seg_rows, n_segs);
  if (rows < 0 || rows > 0x7fffffff) return cudaErrorInvalidValue;  // the kernel takes an int
  const unsigned grid = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  poseidon_merkle_layer_kernel<<<grid, kThreads, 0, stream>>>(
      reinterpret_cast<const uint32_t*>(prev), segs, static_cast<int>(rows),
      reinterpret_cast<uint32_t*>(out), n);
  return cudaGetLastError();
}

// The least nonce in [start, start + count) whose mix_u64 digest has at
// least pow_bits trailing zeros goes into *best (device, u64), which the
// caller presets to all ones; it stays so if there is none.  digest: the 8
// words of the channel's felt (a host array, value below p), passed to the
// kernel by value.  count <= 2^40, start + count <= 2^64.
extern "C" int tstwo_poseidon_grind(const uint32_t* digest, unsigned long long start,
                                    long long count, int pow_bits,
                                    unsigned long long* best, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (digest == nullptr || best == nullptr || count <= 0 || count > (1LL << 40) ||
      pow_bits < 0 || start + static_cast<unsigned long long>(count - 1) < start)
    return cudaErrorInvalidValue;
  GrindFelt d;
  for (int w = 0; w < 8; ++w) d.w[w] = digest[w];
  const unsigned grid = static_cast<unsigned>((count + kThreads - 1) / kThreads);
  poseidon_grind_kernel<<<grid, kThreads, 0, stream>>>(d, start, count, pow_bits, best);
  return cudaGetLastError();
}
