// GKR sum-check rounds: the two round sums of a layer's oracle, and the
// fold of an MLE's first variable.
//
// Replaces no Pallas kernel.  It replaces the jitted programs
// tstwo_tpu/lookups/gkr.py:311 `_eval_grand_product_sum_kernel`, :331
// `_eval_logup_sum_kernel`, :363 `_eval_logup_singles_sum_kernel` and
// tstwo_tpu/lookups/mle.py:27 `_fold_first_variable`, where XLA fused each
// into one pass; run eagerly by PyTorch, a round was some 1,500 int64
// operators (a QM31 product is a Karatsuba chain of widened tensors, some
// 40 launches a LogUp fraction) and an upload of its challenge.
//
// What `round_sums` computes, for a layer of 4 T points (the oracle's
// first variable splits it into halves r0 | r1, each term j reads the pair
// (2j, 2j + 1) of both halves, and the polynomial's value at 2 is
// r2 = 2 r1 - r0):
//
//   s0 = sum_j eq_j g(r0[2j], r0[2j + 1])
//   s2 = sum_j eq_j g(r2[2j], r2[2j + 1])
//
// with the gate g of the layer's kind: GrandProduct a b; LogUpGeneric
// (n_a d_b + n_b d_a) + lambda d_a d_b; LogUpMultiplicities the same with
// base-field numerators (an int32 [4 T] column, no QM31 copy made);
// LogUpSingles (d_a + d_b) + lambda d_a d_b.  Every product is exact in
// M31 and each sum is taken over canonical values in 64 bits and reduced
// once, so the result is the plain version's bit for bit, in any order.
//
// What `mle_fold` computes: out[:, i] = lhs + c (rhs - lhs) over the two
// halves of a [4, n] QM31 MLE (or an [n] base-field one, zero-extended),
// into a fresh [4, n / 2].
//
// What bounds them on the H100: bytes, and at the small layers of the
// last rounds, a launch.  The sums read the eq prefix and the layer once,
// (16 + 64) T bytes for a GrandProduct layer and (16 + 128) T for LogUp:
// 37.7 MB at T = 2^18, 11 us at 3.35 TB/s; a fold reads 32 and writes 16
// bytes a point pair.
//
// What their design does about that:
// - One thread a term in a grid-stride loop, neighbouring threads on
//   neighbouring terms, each coordinate row read where it lies (a row
//   stride a column), so a warp's loads of a row are coalesced.
// - The two QM31 sums add up in uint64 registers a thread (a canonical
//   value is below 2^31, so 2^33 terms cannot overflow), then over the
//   block by warp shuffles, reduced mod P once a block.  The last block
//   to finish (a counter in static device memory, zero when the module
//   loads, which that block resets) adds the blocks' eight words and
//   writes the result: one launch, no memset, no second kernel, no
//   scratch from the caller, and the host fetches eight words.  The
//   scratch is one per device, so round-sum launches on a device run one
//   at a time (stream order).
// - lambda and the fold's challenge come by value, not as an upload.
#include <cuda_runtime.h>

#include <cstdint>

#include "m31.cuh"

namespace {

using tstwo::M31_P;
using tstwo::m31_add;
using tstwo::m31_mul;
using tstwo::m31_sub;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSm = 4;
constexpr int kMaxBlocks = 1024;

// the layer kinds (lookups/gkr_kernels.py KINDS)
constexpr int kGrandProduct = 0;
constexpr int kLogUpGeneric = 1;
constexpr int kLogUpMultiplicities = 2;
constexpr int kLogUpSingles = 3;

// the round sums' scratch: each block's eight words, and the count of
// blocks done (0 between launches)
__device__ uint32_t g_partials[kMaxBlocks * 8];
__device__ unsigned g_done = 0;

struct Cm {
  uint32_t re, im;
};

struct Qm {
  Cm a, b;  // a + b u
};

__device__ __forceinline__ Cm cm_add(Cm x, Cm y) {
  return {m31_add(x.re, y.re), m31_add(x.im, y.im)};
}

__device__ __forceinline__ Cm cm_sub(Cm x, Cm y) {
  return {m31_sub(x.re, y.re), m31_sub(x.im, y.im)};
}

// (a + bi)(c + di), i^2 = -1, with three products
__device__ __forceinline__ Cm cm_mul(Cm x, Cm y) {
  const uint32_t m1 = m31_mul(x.re, y.re);
  const uint32_t m2 = m31_mul(x.im, y.im);
  const uint32_t m3 = m31_mul(m31_add(x.re, x.im), m31_add(y.re, y.im));
  return {m31_sub(m1, m2), m31_sub(m31_sub(m3, m1), m2)};
}

__device__ __forceinline__ Qm qm_add(Qm x, Qm y) {
  return {cm_add(x.a, y.a), cm_add(x.b, y.b)};
}

__device__ __forceinline__ Qm qm_sub(Qm x, Qm y) {
  return {cm_sub(x.a, y.a), cm_sub(x.b, y.b)};
}

// QM31 = CM31[u] / (u^2 - R), R = 2 + i.  Karatsuba: 9 M31 products.
__device__ __forceinline__ Qm qm_mul(Qm x, Qm y) {
  const Cm ac = cm_mul(x.a, y.a);
  const Cm bd = cm_mul(x.b, y.b);
  const Cm t = cm_mul(cm_add(x.a, x.b), cm_add(y.a, y.b));
  const Cm rbd{m31_sub(m31_add(bd.re, bd.re), bd.im),
               m31_add(bd.re, m31_add(bd.im, bd.im))};
  return {cm_add(ac, rbd), cm_sub(t, cm_add(ac, bd))};
}

// x times the base-field value s: each coordinate times s
__device__ __forceinline__ Qm qm_mul_base(Qm x, uint32_t s) {
  return {{m31_mul(x.a.re, s), m31_mul(x.a.im, s)},
          {m31_mul(x.b.re, s), m31_mul(x.b.im, s)}};
}

// the value at 2 of the line through r0 (at 0) and r1 (at 1): 2 r1 - r0
__device__ __forceinline__ uint32_t at_two(uint32_t r0, uint32_t r1) {
  return m31_sub(m31_add(r1, r1), r0);
}

__device__ __forceinline__ Qm qm_at_two(Qm r0, Qm r1) {
  return {{at_two(r0.a.re, r1.a.re), at_two(r0.a.im, r1.a.im)},
          {at_two(r0.b.re, r1.b.re), at_two(r0.b.im, r1.b.im)}};
}

// column i of a [4, n] QM31 array whose rows lie `stride` words apart
__device__ __forceinline__ Qm load(const uint32_t* __restrict__ p,
                                   long long stride, long long i) {
  return {{p[i], p[stride + i]}, {p[2 * stride + i], p[3 * stride + i]}};
}

__device__ __forceinline__ void store(uint32_t* __restrict__ p,
                                      long long stride, long long i, Qm v) {
  p[i] = v.a.re;
  p[stride + i] = v.a.im;
  p[2 * stride + i] = v.b.re;
  p[3 * stride + i] = v.b.im;
}

// a sum below 2^64 -> canonical M31 (2^31 == 1 mod P)
__device__ __forceinline__ uint32_t reduce64(uint64_t x) {
  x = (x & M31_P) + (x >> 31);  // < 2^34
  x = (x & M31_P) + (x >> 31);  // < 2^31 + 8
  const uint32_t s = static_cast<uint32_t>(x);
  return s >= M31_P ? s - M31_P : s;
}

// (n_a d_b + n_b d_a) + lambda d_a d_b
__device__ __forceinline__ Qm frac_acc(Qm na, Qm da, Qm nb, Qm db, Qm lam) {
  const Qm numer = qm_add(qm_mul(na, db), qm_mul(nb, da));
  return qm_add(numer, qm_mul(lam, qm_mul(da, db)));
}

// the same with base-field numerators
__device__ __forceinline__ Qm frac_acc_base(uint32_t na, Qm da, uint32_t nb,
                                            Qm db, Qm lam) {
  const Qm numer = qm_add(qm_mul_base(db, na), qm_mul_base(da, nb));
  return qm_add(numer, qm_mul(lam, qm_mul(da, db)));
}

// (d_a + d_b) + lambda d_a d_b
__device__ __forceinline__ Qm recip_acc(Qm da, Qm db, Qm lam) {
  return qm_add(qm_add(da, db), qm_mul(lam, qm_mul(da, db)));
}

// the gate at 0 and at 2 of term j; `a` is the GrandProduct's values or
// LogUp's numerators, `b` LogUp's denominators
template <int KIND>
__device__ __forceinline__ void term(const uint32_t* __restrict__ a,
                                     long long as, const uint32_t* __restrict__ b,
                                     long long bs, long long n_terms,
                                     long long j, Qm lam, Qm& t0, Qm& t2) {
  const long long i0 = 2 * j, i1 = 2 * j + 1;
  const long long k0 = 2 * n_terms + i0, k1 = 2 * n_terms + i1;
  if constexpr (KIND == kGrandProduct) {
    const Qm r0i0 = load(a, as, i0), r0i1 = load(a, as, i1);
    const Qm r1i0 = load(a, as, k0), r1i1 = load(a, as, k1);
    t0 = qm_mul(r0i0, r0i1);
    t2 = qm_mul(qm_at_two(r0i0, r1i0), qm_at_two(r0i1, r1i1));
  } else if constexpr (KIND == kLogUpSingles) {
    const Qm d0 = load(b, bs, i0), d1 = load(b, bs, i1);
    const Qm d0b = load(b, bs, k0), d1b = load(b, bs, k1);
    t0 = recip_acc(d0, d1, lam);
    t2 = recip_acc(qm_at_two(d0, d0b), qm_at_two(d1, d1b), lam);
  } else {
    const Qm d0 = load(b, bs, i0), d1 = load(b, bs, i1);
    const Qm d0b = load(b, bs, k0), d1b = load(b, bs, k1);
    const Qm d0_2 = qm_at_two(d0, d0b), d1_2 = qm_at_two(d1, d1b);
    if constexpr (KIND == kLogUpMultiplicities) {
      const uint32_t n0 = a[i0], n1 = a[i1], n0b = a[k0], n1b = a[k1];
      t0 = frac_acc_base(n0, d0, n1, d1, lam);
      t2 = frac_acc_base(at_two(n0, n0b), d0_2, at_two(n1, n1b), d1_2, lam);
    } else {
      const Qm n0 = load(a, as, i0), n1 = load(a, as, i1);
      const Qm n0b = load(a, as, k0), n1b = load(a, as, k1);
      t0 = frac_acc(n0, d0, n1, d1, lam);
      t2 = frac_acc(qm_at_two(n0, n0b), d0_2, qm_at_two(n1, n1b), d1_2, lam);
    }
  }
}

// acc summed over the block; the result in thread 0
__device__ __forceinline__ void block_sum(uint64_t acc[8]) {
  __shared__ uint64_t warp_sums[kWarps][8];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off /= 2) {
      acc[k] += __shfl_down_sync(
          0xffffffffu, static_cast<unsigned long long>(acc[k]), off);
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < 8; ++k) warp_sums[warp][k] = acc[k];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      uint64_t s = 0;
      for (int w = 0; w < kWarps; ++w) s += warp_sums[w][k];
      acc[k] = s;
    }
  }
  __syncthreads();
}

template <int KIND>
__global__ void __launch_bounds__(kThreads)
round_sums_kernel(const uint32_t* __restrict__ eq, long long eq_stride,
                  const uint32_t* __restrict__ a, long long as,
                  const uint32_t* __restrict__ b, long long bs,
                  long long n_terms, Qm lam, uint32_t* __restrict__ out) {
  uint64_t acc[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long j = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       j < n_terms; j += stride) {
    Qm t0, t2;
    term<KIND>(a, as, b, bs, n_terms, j, lam, t0, t2);
    const Qm e = load(eq, eq_stride, j);
    const Qm s0 = qm_mul(e, t0), s2 = qm_mul(e, t2);
    acc[0] += s0.a.re;
    acc[1] += s0.a.im;
    acc[2] += s0.b.re;
    acc[3] += s0.b.im;
    acc[4] += s2.a.re;
    acc[5] += s2.a.im;
    acc[6] += s2.b.re;
    acc[7] += s2.b.im;
  }
  block_sum(acc);
  __shared__ bool last;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      g_partials[8 * blockIdx.x + k] = reduce64(acc[k]);
    }
    __threadfence();
    last = atomicAdd(&g_done, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  // the last block: every block's words are written and visible
  __threadfence();
#pragma unroll
  for (int k = 0; k < 8; ++k) acc[k] = 0;
  for (unsigned blk = threadIdx.x; blk < gridDim.x; blk += blockDim.x) {
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[k] += __ldcg(g_partials + 8 * blk + k);
  }
  block_sum(acc);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < 8; ++k) out[k] = reduce64(acc[k]);
    g_done = 0;  // ready for the next launch
  }
}

template <bool BASE>
__global__ void mle_fold_kernel(const uint32_t* __restrict__ src,
                                long long stride, long long half, Qm c,
                                uint32_t* __restrict__ out) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < half; i += step) {
    if constexpr (BASE) {
      const uint32_t lhs = src[i], d = m31_sub(src[half + i], lhs);
      const Qm v = qm_mul_base(c, d);
      store(out, half, i, {{m31_add(lhs, v.a.re), v.a.im}, v.b});
    } else {
      const Qm lhs = load(src, stride, i), rhs = load(src, stride, half + i);
      store(out, half, i, qm_add(lhs, qm_mul(c, qm_sub(rhs, lhs))));
    }
  }
}

// Enough blocks to fill every SM, and no more than the items need.
unsigned grid_for(long long n, int cap) {
  int device = 0;
  int sms = 132;
  if (cudaGetDevice(&device) == cudaSuccess) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  const long long want = (n + kThreads - 1) / kThreads;
  long long most = static_cast<long long>(sms) * kBlocksPerSm;
  if (most > cap) most = cap;
  return static_cast<unsigned>(want < most ? want : most);
}

Qm qm_of(uint32_t c0, uint32_t c1, uint32_t c2, uint32_t c3) {
  return {{c0, c1}, {c2, c3}};
}

}  // namespace

// The two round sums of an oracle of `kind` (0 GrandProduct, 1
// LogUpGeneric, 2 LogUpMultiplicities, 3 LogUpSingles) over n_terms >= 1
// terms: eq [4, >= n_terms] (rows eq_stride words apart); a the
// GrandProduct's values or LogUp's numerators ([4, 4 n_terms], rows `as`
// apart; LogUpMultiplicities: [4 n_terms] base values), b LogUp's
// denominators ([4, 4 n_terms], rows `bs` apart); lambda by value.  out:
// the 8 words s0, s2.  Returns the cudaError_t of the launch, or 0.
extern "C" int tstwo_gkr_round_sums(int kind, const uint32_t* eq,
                                    long long eq_stride, const uint32_t* a,
                                    long long as, const uint32_t* b,
                                    long long bs, long long n_terms,
                                    uint32_t lam0, uint32_t lam1,
                                    uint32_t lam2, uint32_t lam3,
                                    uint32_t* out, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const unsigned grid = grid_for(n_terms, kMaxBlocks);
  const Qm lam = qm_of(lam0, lam1, lam2, lam3);
  switch (kind) {
    case kGrandProduct:
      round_sums_kernel<kGrandProduct><<<grid, kThreads, 0, stream>>>(
          eq, eq_stride, a, as, b, bs, n_terms, lam, out);
      break;
    case kLogUpGeneric:
      round_sums_kernel<kLogUpGeneric><<<grid, kThreads, 0, stream>>>(
          eq, eq_stride, a, as, b, bs, n_terms, lam, out);
      break;
    case kLogUpMultiplicities:
      round_sums_kernel<kLogUpMultiplicities><<<grid, kThreads, 0, stream>>>(
          eq, eq_stride, a, as, b, bs, n_terms, lam, out);
      break;
    case kLogUpSingles:
      round_sums_kernel<kLogUpSingles><<<grid, kThreads, 0, stream>>>(
          eq, eq_stride, a, as, b, bs, n_terms, lam, out);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// out [4, half] = lhs + c (rhs - lhs) over the halves of src: [4, 2 half]
// QM31 values, rows `stride` words apart, or (base != 0) [2 half] base
// values.  half >= 1.  Returns the cudaError_t of the launch, or 0.
extern "C" int tstwo_mle_fold(const uint32_t* src, long long stride,
                              long long half, int base, uint32_t c0,
                              uint32_t c1, uint32_t c2, uint32_t c3,
                              uint32_t* out, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const unsigned grid = grid_for(half, 1 << 30);
  const Qm c = qm_of(c0, c1, c2, c3);
  if (base) {
    mle_fold_kernel<true><<<grid, kThreads, 0, stream>>>(src, stride, half, c,
                                                         out);
  } else {
    mle_fold_kernel<false><<<grid, kThreads, 0, stream>>>(src, stride, half,
                                                          c, out);
  }
  return cudaGetLastError();
}
