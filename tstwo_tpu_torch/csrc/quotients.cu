// DEEP quotients over the domain: one launch accumulates every sample batch
// of a group of committed columns of one size into the [4, n] quotient
// evaluation that FRI's first layer commits.
//
// Replaces no Pallas kernel.  It replaces the jitted
// tstwo_tpu/pcs/quotients.py:149 `_accumulate_quotients_kernel`, where XLA
// fused the pass over the domain; run eagerly by PyTorch, the same pass
// was some 12 int64 operators and 3 uploads a column on [4, n] stacks, a
// copy of the columns (torch.stack) and an upload of the domain's points.
//
// What it computes, for row i of the bit-reversed domain and each sample
// batch (a point p and its columns j, sampled at p), in order:
//
//   S   = sum_j alpha^j F_j(i)                    (QM31 weights, M31 values)
//   num = c * S - A * y - B                       (c = conj(p.y) - p.y,
//                                                  A = sum_j alpha^j a_j,
//                                                  B = sum_j alpha^j b_j)
//   den = (p.x.c0 - x) * p.y.c1 - (p.y.c0 - y) * p.x.c1   (CM31)
//       = K - x * p.y.c1 + y * p.x.c1,  K = p.x.c0 p.y.c1 - p.y.c0 p.x.c1
//   acc = acc * alpha^(columns of the batch) + num / den
//
// which is the sum over the batch's columns of the line-coefficient form
// c_j F_j - a_j y - b_j (pcs/quotients.py `complex_conjugate_line_coeffs`,
// whose c_j = alpha^j c for every column of a batch), exact in M31, so the
// result is the plain version's (`_accumulate_rows`) bit for bit.
//
// What bounds it on the H100: bytes.  Every column value is read once a
// batch that samples it and every output word written once: 100 x 2^21 +
// 4 x 2^22 values and [4, 2^22] + [4, 2^21] outputs for the 2^20-row wide
// Fibonacci, 1.007 GB, 0.30 ms at 3.35 TB/s; 1296 x 2^18 + 4 x 2^20 values
// for Poseidon2 at 2^17, 1.397 GB, 0.42 ms.  Neither fits the 50 MB L2.
//
// What its design does about that:
// - A thread takes 4 consecutive bit-reversed rows (a "quad") and reads
//   each column with one 16-byte load, neighbouring threads on
//   neighbouring quads; sixteen loads a thread are in flight (four in a
//   group's last few columns).  Columns are read where they lie, through
//   a table of their pointers.
// - The products alpha^j F_j add up in uint64, unreduced: a product of
//   two canonical values is below 2^62, and a fold (2^31 == 1 mod P) after
//   every fourth keeps the sum below 2^64.  One reduction a batch a row.
// - The weights alpha^j and the column pointers pass through shared
//   memory in chunks of up to kMaxChunk entries, read by every thread of
//   a block at the same address (a broadcast).
// - The domain's points are made here, not read: rows 4m .. 4m + 3 are
//   (x, y), (x, -y), (-x, -y), (-x, y) for the half-coset point
//   initial + rev(m) * step (the coset's point of order 2 is (-1, 0)).
//   With 2^g threads, thread t's quads are t + rev(j) * 2^g, whose points
//   are its first one plus j times a fixed step multiple: one point
//   addition serves four rows.  Only the initial point and the log n - 2
//   multiples step * 2^b come in, by value.
// - The denominators' inverses of a thread's four rows and up to kInv
//   batches are taken with one Montgomery batch inversion: one M31
//   exponentiation where there are 4 kInv norms.  The four rows' points
//   differ in signs alone, so their denominators are K +- u +- v from one
//   u = x * (-p.y.c1) and v = y * p.x.c1, and A y is one product a quad.
// - What a row costs besides its columns is arithmetic (the [4, 2^22]
//   composition group reads 16 bytes a row): the products there add up
//   in 64 bits and reduce once a coordinate, and c = conj(p.y) - p.y, whose
//   CM31 part 0 is zero, multiplies S as one CM31 number.
#include <cuda_runtime.h>

#include <cstdint>

#include "m31.cuh"

namespace {

using tstwo::M31_P;
using tstwo::m31_add;
using tstwo::m31_mul;
using tstwo::m31_sub;

constexpr int kThreads = 256;
constexpr int kMaxPoints = 32;    // the initial point and the step multiples
constexpr int kMaxBatches = 64;   // pcs/quotients.py MAX_BATCHES
constexpr int kBatchWords = 20;   // pcs/quotients.py BATCH_WORDS
constexpr int kInv = 2;           // batches a joint inversion
constexpr int kUnroll = 16;       // column loads in flight a thread
constexpr int kMaxChunk = 2048;   // entries in shared memory at once
constexpr int kMaxLogThreads = 16;

// A batch's words (pcs/quotients.py `pack_quotient_constants`): CM31
// values K, -p.y.c1, p.x.c1 and c.c1, then QM31 values.
constexpr int kK = 0, kNegPiy = 2, kPix = 4, kC1 = 6;
constexpr int kA = 8, kB = 12, kCoeff = 16;
constexpr int kSlotWords = 3;  // a denominator and its norm, then its inverse

struct Points {
  uint32_t xy[2 * kMaxPoints];  // x0, y0, x1, y1, ...
};

__device__ __forceinline__ uint32_t m31_neg(uint32_t a) {
  return a == 0 ? 0 : M31_P - a;
}

// x == hi * 2^31 + lo == hi + lo (mod P)
__device__ __forceinline__ uint64_t fold64(uint64_t x) {
  return (x & M31_P) + (x >> 31);
}

// a sum below 2^64 -> canonical M31
__device__ __forceinline__ uint32_t reduce64(uint64_t x) {
  x = fold64(fold64(x));  // < 2^34, then < 2^31 + 8
  const uint32_t s = static_cast<uint32_t>(x);
  return s >= M31_P ? s - M31_P : s;
}

// x^(P - 2): x^(2^29 - 1) by an addition chain, then ^4 * x; 0 -> 0
__device__ __forceinline__ uint32_t m31_inv(uint32_t x) {
  auto sqn = [](uint32_t v, int n) {
    for (int i = 0; i < n; ++i) v = m31_mul(v, v);
    return v;
  };
  const uint32_t t2 = m31_mul(sqn(x, 1), x);      // 2^2 - 1
  const uint32_t t4 = m31_mul(sqn(t2, 2), t2);    // 2^4 - 1
  const uint32_t t8 = m31_mul(sqn(t4, 4), t4);    // 2^8 - 1
  const uint32_t t16 = m31_mul(sqn(t8, 8), t8);   // 2^16 - 1
  const uint32_t t24 = m31_mul(sqn(t16, 8), t8);  // 2^24 - 1
  const uint32_t t28 = m31_mul(sqn(t24, 4), t4);  // 2^28 - 1
  const uint32_t t29 = m31_mul(sqn(t28, 1), x);   // 2^29 - 1
  return m31_mul(sqn(t29, 2), x);                 // 2^31 - 3
}

struct Cm {
  uint32_t re, im;
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

// QM31 = CM31[u] / (u^2 - R), R = 2 + i; coordinates (a.re, a.im, b.re,
// b.im) of a + bu.  Karatsuba: 9 M31 products.
__device__ __forceinline__ void qm31_mul(const uint32_t x[4],
                                         const uint32_t y[4], uint32_t out[4]) {
  const Cm a{x[0], x[1]}, b{x[2], x[3]}, c{y[0], y[1]}, d{y[2], y[3]};
  const Cm ac = cm_mul(a, c);
  const Cm bd = cm_mul(b, d);
  const Cm t = cm_mul(cm_add(a, b), cm_add(c, d));
  const Cm rbd{m31_sub(m31_add(bd.re, bd.re), bd.im),
               m31_add(bd.re, m31_add(bd.im, bd.im))};
  const Cm lo = cm_add(ac, rbd);
  const Cm hi = cm_sub(t, cm_add(ac, bd));
  out[0] = lo.re;
  out[1] = lo.im;
  out[2] = hi.re;
  out[3] = hi.im;
}

// (x, y) += (sx, sy) on the circle x^2 + y^2 = 1
__device__ __forceinline__ void point_add(uint32_t& x, uint32_t& y,
                                          uint32_t sx, uint32_t sy) {
  const uint32_t nx = m31_sub(m31_mul(x, sx), m31_mul(y, sy));
  y = m31_add(m31_mul(x, sy), m31_mul(y, sx));
  x = nx;
}

// x * y with the products added in 64 bits: 4 products, 2 reductions
__device__ __forceinline__ Cm cm_mul_lazy(Cm x, Cm y) {
  return {reduce64(static_cast<uint64_t>(x.re) * y.re +
                   static_cast<uint64_t>(M31_P - x.im) * y.im),
          reduce64(static_cast<uint64_t>(x.re) * y.im +
                   static_cast<uint64_t>(x.im) * y.re)};
}

// a CM31 number times an M31 one
__device__ __forceinline__ Cm cm_scale(const uint32_t* x, uint32_t s) {
  return {m31_mul(x[0], s), m31_mul(x[1], s)};
}

// x * R, R = 2 + i: (2 re - im) + (re + 2 im) i
__device__ __forceinline__ Cm cm_mul_r(Cm x) {
  return {m31_sub(m31_add(x.re, x.re), x.im),
          m31_add(x.re, m31_add(x.im, x.im))};
}

__device__ __forceinline__ void mac(uint64_t (&s)[4][4], const uint4& w,
                                    const uint4& v) {
  const uint32_t vr[4] = {v.x, v.y, v.z, v.w};
  const uint32_t wc[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      s[r][c] += static_cast<uint64_t>(wc[c]) * vr[r];
    }
  }
}

__device__ __forceinline__ void fold_all(uint64_t (&s)[4][4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int c = 0; c < 4; ++c) s[r][c] = fold64(s[r][c]);
  }
}

size_t smem_bytes(int chunk, int n_batches) {
  return static_cast<size_t>(chunk) * (sizeof(uint4) + sizeof(void*)) +
         static_cast<size_t>(kBatchWords * n_batches + n_batches + 1) * 4 +
         static_cast<size_t>(2 * kMaxPoints) * 4 +
         static_cast<size_t>(kInv * 4 * kSlotWords * kThreads) * 4;
}

// table (32-bit words): the n_cols column pointers (64-bit), the batches'
// words, the n_batches + 1 entry offsets (padded to 4 words, so that the
// weights start 16-byte aligned), the entries' weights (4 words each) and
// their columns (an index into the pointers).
//
// Thread t (of 2^log_threads) takes the quads t + rev(j) 2^log_threads of
// the 2^log_quads that `out` ([4, 4 * 2^log_quads]) holds, the first of
// which is quad quad0 of the 2^(log_n - 2) of the domain.
__global__ void __launch_bounds__(kThreads, 2)
accumulate_quotients_kernel(const uint32_t* __restrict__ table, int n_cols,
                            int n_batches, int n_entries, Points pts,
                            int log_n, long long quad0, int log_quads,
                            int log_threads, int chunk,
                            uint32_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint4* w_s = reinterpret_cast<uint4*>(smem_raw);
  const uint4** p_s = reinterpret_cast<const uint4**>(w_s + chunk);
  uint32_t* bw_s = reinterpret_cast<uint32_t*>(p_s + chunk);
  int* off_s = reinterpret_cast<int*>(bw_s + kBatchWords * n_batches);
  uint32_t* pt_s = reinterpret_cast<uint32_t*>(off_s + n_batches + 1);
  uint32_t* inv_s = pt_s + 2 * kMaxPoints;

  const auto* ptrs = reinterpret_cast<const unsigned long long*>(table);
  const uint32_t* bw = table + 2 * n_cols;
  const int* offs = reinterpret_cast<const int*>(bw + kBatchWords * n_batches);
  const int w_word = (2 * n_cols + kBatchWords * n_batches + n_batches + 1 + 3) & ~3;
  const uint4* wts = reinterpret_cast<const uint4*>(table + w_word);
  const int* idx = reinterpret_cast<const int*>(table + w_word + 4 * n_entries);

  const int tid = threadIdx.x;
  for (int i = tid; i < kBatchWords * n_batches; i += blockDim.x) bw_s[i] = bw[i];
  for (int i = tid; i <= n_batches; i += blockDim.x) off_s[i] = offs[i];
  for (int i = tid; i < 2 * kMaxPoints; i += blockDim.x) pt_s[i] = pts.xy[i];
  auto load_chunk = [&](int base) {
    for (int e = tid; e < chunk && base + e < n_entries; e += blockDim.x) {
      w_s[e] = wts[base + e];
      p_s[e] = reinterpret_cast<const uint4*>(ptrs[idx[base + e]]);
    }
  };
  int chunk_base = 0;
  int chunk_end = n_entries < chunk ? n_entries : chunk;
  load_chunk(0);
  __syncthreads();

  // the thread's first half-coset point: initial + rev(quad0 + t) * step
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + tid;
  const int kbits = log_n - 2;
  const uint32_t k0 =
      kbits > 0 ? __brev(static_cast<uint32_t>(quad0 + t)) >> (32 - kbits) : 0;
  uint32_t px = pt_s[0], py = pt_s[1];
  for (int b = 0; b < kbits; ++b) {
    if ((k0 >> b) & 1) point_add(px, py, pt_s[2 + 2 * b], pt_s[3 + 2 * b]);
  }
  const int log_j = log_quads - log_threads;
  const int inc = 1 + kbits - log_quads;  // the point of step * 2^(kbits - log_quads)
  const long long n_rows = 4LL << log_quads;
  uint32_t* const my_inv = inv_s + tid;

  for (long long j = 0; j < (1LL << log_j); ++j) {
    const long long jr =
        log_j > 0 ? __brev(static_cast<uint32_t>(j)) >> (32 - log_j) : 0;
    const long long m = t + (jr << log_threads);  // the quad, in `out`
    uint32_t acc[4][4];

    for (int b0 = 0; b0 < n_batches; b0 += kInv) {
      const int nb = n_batches - b0 < kInv ? n_batches - b0 : kInv;
      // slot i = 4 * batch + row: its denominator and norm, then the
      // denominator's inverse, in shared memory
      uint32_t pre[kInv * 4];
      uint32_t run = 1;
#pragma unroll
      for (int bi = 0; bi < kInv; ++bi) {
        if (bi < nb) {
          const uint32_t* const bq = bw_s + kBatchWords * (b0 + bi);
          const Cm k{bq[kK], bq[kK + 1]};
          const Cm u = cm_scale(bq + kNegPiy, px), v = cm_scale(bq + kPix, py);
          const Cm ku = cm_add(k, u), kmu = cm_sub(k, u);
          const Cm d[4] = {cm_add(ku, v), cm_sub(ku, v), cm_sub(kmu, v),
                           cm_add(kmu, v)};
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            uint32_t* const slot = my_inv + (4 * bi + r) * kSlotWords * kThreads;
            const uint32_t norm =
                reduce64(static_cast<uint64_t>(d[r].re) * d[r].re +
                         static_cast<uint64_t>(d[r].im) * d[r].im);
            slot[0] = d[r].re;
            slot[kThreads] = d[r].im;
            slot[2 * kThreads] = norm;
            pre[4 * bi + r] = run;
            if (norm != 0) run = m31_mul(run, norm);
          }
        }
      }
      uint32_t inv = m31_inv(run);
#pragma unroll
      for (int i = kInv * 4 - 1; i >= 0; --i) {
        if (i / 4 < nb) {
          uint32_t* const slot = my_inv + i * kSlotWords * kThreads;
          const uint32_t norm = slot[2 * kThreads];
          const uint32_t ninv = norm == 0 ? 0 : m31_mul(inv, pre[i]);
          if (norm != 0) inv = m31_mul(inv, norm);
          slot[0] = m31_mul(slot[0], ninv);  // conj(d) / norm
          slot[kThreads] = m31_mul(m31_neg(slot[kThreads]), ninv);
        }
      }

      for (int bi = 0; bi < nb; ++bi) {
        const int b = b0 + bi;
        uint64_t s[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
#pragma unroll
          for (int c = 0; c < 4; ++c) s[r][c] = 0;
        }
        const int end = off_s[b + 1];
        for (int e = off_s[b]; e < end;) {
          if (e < chunk_base || e >= chunk_end) {  // the same e in every thread
            __syncthreads();
            chunk_base = e;
            chunk_end = n_entries - e < chunk ? n_entries : e + chunk;
            load_chunk(e);
            __syncthreads();
          }
          const int k_end = (end < chunk_end ? end : chunk_end) - chunk_base;
          int k = e - chunk_base;
          for (; k + kUnroll <= k_end; k += kUnroll) {
            uint4 v[kUnroll];
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) v[u] = __ldg(p_s[k + u] + m);
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) {
              mac(s, w_s[k + u], v[u]);
              if (u % 4 == 3) fold_all(s);
            }
          }
          for (; k + 4 <= k_end; k += 4) {  // the last 4 to 15 columns
            uint4 v[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) v[u] = __ldg(p_s[k + u] + m);
#pragma unroll
            for (int u = 0; u < 4; ++u) mac(s, w_s[k + u], v[u]);
            fold_all(s);
          }
          if (k < k_end) {  // at most 3 more products on a folded sum
            for (; k < k_end; ++k) mac(s, w_s[k], __ldg(p_s[k] + m));
            fold_all(s);
          }
          e = k + chunk_base;
        }

        const uint32_t* const bq = bw_s + kBatchWords * b;
        const Cm c1{bq[kC1], bq[kC1 + 1]};
        uint32_t ay[4];  // A y; rows 1 and 2 have -y
#pragma unroll
        for (int c = 0; c < 4; ++c) ay[c] = m31_mul(bq[kA + c], py);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          // c S = R c1 S.c1 + c1 S.c0 u
          const Cm s0{reduce64(s[r][0]), reduce64(s[r][1])};
          const Cm s1{reduce64(s[r][2]), reduce64(s[r][3])};
          const Cm lo = cm_mul_r(cm_mul_lazy(c1, s1));
          const Cm hi = cm_mul_lazy(c1, s0);
          const bool up = r == 0 || r == 3;
          uint32_t num[4] = {lo.re, lo.im, hi.re, hi.im};
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            num[c] = m31_sub(up ? m31_sub(num[c], ay[c]) : m31_add(num[c], ay[c]),
                             bq[kB + c]);
          }
          const uint32_t* const slot = my_inv + (4 * bi + r) * kSlotWords * kThreads;
          const Cm dinv{slot[0], slot[kThreads]};
          const Cm q0 = cm_mul_lazy(Cm{num[0], num[1]}, dinv);
          const Cm q1 = cm_mul_lazy(Cm{num[2], num[3]}, dinv);
          if (b == 0) {
            acc[r][0] = q0.re;
            acc[r][1] = q0.im;
            acc[r][2] = q1.re;
            acc[r][3] = q1.im;
          } else {
            uint32_t h[4];
            qm31_mul(acc[r], bq + kCoeff, h);
            acc[r][0] = m31_add(h[0], q0.re);
            acc[r][1] = m31_add(h[1], q0.im);
            acc[r][2] = m31_add(h[2], q1.re);
            acc[r][3] = m31_add(h[3], q1.im);
          }
        }
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      reinterpret_cast<uint4*>(out + c * n_rows)[m] =
          make_uint4(acc[0][c], acc[1][c], acc[2][c], acc[3][c]);
    }
    if (log_j > 0) point_add(px, py, pt_s[2 * inc], pt_s[2 * inc + 1]);
  }
}

}  // namespace

// table: the device table above; points: 2 * (log_n - 1) host words, the
// x, y of the half coset's initial point and of step * 2^b, b < log_n - 2;
// out: int32 [4, n_rows] for rows row0 .. row0 + n_rows of the
// bit-reversed domain of 2^log_n points (n_rows a power of two, at least 4,
// dividing row0).  Every weight, batch word and column value is a
// canonical M31.  2 <= log_n <= 31; 1 <= n_batches <= kMaxBatches.
// Returns the cudaError_t of the launch, or 0.
extern "C" int tstwo_accumulate_quotients(const int32_t* table, int n_cols,
                                          int n_batches, int n_entries,
                                          const uint32_t* points, int log_n,
                                          long long row0, long long n_rows,
                                          int32_t* out, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (log_n < 2 || log_n > 31 || n_cols < 1 || n_entries < 1 ||
      n_batches < 1 || n_batches > kMaxBatches || n_rows < 4 ||
      (n_rows & (n_rows - 1)) != 0 || row0 < 0 || row0 % n_rows != 0 ||
      row0 + n_rows > (1LL << log_n)) {
    return cudaErrorInvalidValue;
  }
  Points pts{};
  for (int i = 0; i < 2 * (log_n - 1); ++i) pts.xy[i] = points[i];
  int log_quads = 0;
  while ((4LL << log_quads) < n_rows) ++log_quads;
  const int chunk = n_entries < kMaxChunk ? n_entries : kMaxChunk;
  const size_t smem = smem_bytes(chunk, n_batches);
  auto kernel = accumulate_quotients_kernel;
  if (smem > 48 * 1024) {  // on the current device, every call
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  // as many threads as are resident at once, a power of two, at most one
  // a quad
  int device = 0, sms = 132, per_sm = 1;
  if (cudaGetDevice(&device) == cudaSuccess) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  const cudaError_t occ = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, kThreads, smem);
  if (occ != cudaSuccess) return occ;
  if (per_sm < 1) per_sm = 1;
  const long long resident = static_cast<long long>(sms) * per_sm * kThreads;
  int log_threads = 0;
  while (log_threads < log_quads && log_threads < kMaxLogThreads &&
         (2LL << log_threads) <= resident) {
    ++log_threads;
  }
  const int threads = log_threads < 8 ? 1 << log_threads : kThreads;
  const unsigned grid = static_cast<unsigned>((1LL << log_threads) / threads);
  kernel<<<grid, threads, smem, stream>>>(
      reinterpret_cast<const uint32_t*>(table), n_cols, n_batches, n_entries,
      pts, log_n, row0 / 4, log_quads, log_threads, chunk,
      reinterpret_cast<uint32_t*>(out));
  return cudaGetLastError();
}
