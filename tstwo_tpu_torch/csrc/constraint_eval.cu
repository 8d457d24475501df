// Constraint programs over the evaluation domain: one launch evaluates every
// constraint of a component on every row and adds the quotients into the
// composition accumulator.
//
// Replaces no Pallas kernel.  It replaces the jitted
// tstwo_tpu/constraint_framework/__init__.py `_domain_kernel`, where XLA
// fused the whole-domain evaluation of `FrameworkEval.evaluate` against
// `DomainEvaluator`; run eagerly by PyTorch, the same evaluation was some
// 10,800 int64 operators a proof (100-column wide Fibonacci), each
// streaming a whole-column temporary through device memory.
//
// What it runs: a constraint program (constraint_framework/program.py,
// instruction set in ops/constraint_eval.py), straight-line register code
// lowered once from the AIR's own `evaluate`.  A block copies a table of
// its loads (the host's `load_table`, each row turned into its column's
// address) and the per-proof scalars (random coefficients, secure
// parameters, cumsum shift, constants, denominator inverses) into shared
// memory, then walks tiles of kRows * 128 rows.  The program passes
// through shared memory in chunks of at most kMaxChunk instructions: a
// program of one chunk (wide Fibonacci's 493 instructions) is copied once a
// block, a longer one (Poseidon2's 19,899, 318 KB, more than a block's 227
// KB of shared memory) chunk by chunk for each tile, from L2, between two
// barriers.  Every thread runs
// the same instruction, so the dispatch never diverges, on kRows rows at
// once, so that one decode serves all of them; instructions are taken two a
// turn, each one's read from shared memory in flight while the other runs.
// The program's slots live in shared memory, laid out so that a warp reads
// 32 consecutive words (no bank conflicts); each thread reads and writes
// only its own.  Column reads run kDepth loads ahead of the instruction
// that stores them, so a read's latency overlaps the instructions between.
// The constraint sum stays in 64 bits, unreduced: each term adds a product
// below 2^62 to a sum kept below 2^34 by a fold (2^31 == 1 mod P) after
// every third constraint, which the program marks.  A mask at a nonzero
// offset computes its source row from the row's index (`source_row`), where
// the eager path uploaded a 2^n permutation a proof.  At the end of a row
// the sum is reduced, multiplied by `denom[row >> trace_log]` and added
// into the accumulator in place.
//
// What bounds it on the H100: integer operations.  The 100-column wide
// Fibonacci program at 2^21 rows needs 6,231 a row (9 an M31 product, 3 an
// addition: ConstraintProgram.ops_per_row), 1.3e10 in all, 0.78 ms at
// 1.675e13/s, against 0.27 ms for its 0.91 GB of columns and accumulator.
// Measured on the H100 80GB HBM3 at 700 W (chip_smoke.py phase 8b): 1.37-
// 1.42 ms at 4 rows a thread (4 blocks an SM), 55-57% of that bound; 2.3-
// 2.6 ms at 1 row, 1.5-1.7 ms at 2, 1.4-1.7 ms at 8 (128 registers, some
// spilled).  Before the loads ran ahead and the instructions two a turn it
// took 1.8 ms (42%); the eager PyTorch evaluation of the same program took
// 170 ms.
#include <cuda_runtime.h>

#include <cstdint>

#include "m31.cuh"

namespace {

using tstwo::M31_P;
using tstwo::m31_add;
using tstwo::m31_mul;
using tstwo::m31_sub;

constexpr int kThreads = 128;
constexpr int kMaxInteractions = 8;  // ops/constraint_eval.py MAX_INTERACTIONS
constexpr int kDefaultRows = 4;
constexpr int kDepth = 3;  // loads in flight ahead of the one stored
constexpr int kMaxChunk = 1024;  // instructions in shared memory at once
constexpr int kMinChunk = 64;

// ops/constraint_eval.py: the opcodes, FOLD
enum Op : int {
  kLoad = 0, kConstB, kScalarS, kAddB, kSubB, kMulB, kSqrB, kNegB, kAddS,
  kSubS, kMulS, kNegS, kPromote, kCombineLo, kCombineHi, kAccumB, kAccumS
};
constexpr int kFold = 1 << 8;

struct Interactions {
  const uint32_t* ptr[kMaxInteractions];
  long long stride[kMaxInteractions];
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
// b.im) of a + bu.  Karatsuba: 9 M31 products and 29 additions.
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

// The row that a mask `offset` trace steps away reads for row i of the
// bit-reversed evaluation domain (constraint_framework `_offset_perm`;
// ops/constraint_eval.py `offset_source_rows` is its plain twin).
__device__ __forceinline__ uint32_t source_row(uint32_t i, int log_n,
                                               int trace_log, int offset) {
  const uint32_t n = 1u << log_n;
  const uint32_t rev = __brev(i) >> (32 - log_n);
  uint32_t pos;
  if (trace_log == log_n) {  // walk the canonic coset order
    const uint32_t k = rev < n / 2 ? 2 * rev : 2 * (n - 1 - rev) + 1;
    const uint32_t k2 = (k + static_cast<uint32_t>(offset)) & (n - 1);
    pos = (k2 & 1) == 0 ? k2 >> 1 : (2 * n - k2) >> 1;
  } else {
    const uint32_t half = n >> 1;
    const uint32_t step =
        static_cast<uint32_t>(offset) * (1u << (log_n - trace_log - 1));
    pos = rev < half ? (rev + step) & (half - 1)
                     : ((rev - step) & (half - 1)) + half;
  }
  return __brev(pos) >> (32 - log_n);
}

// A load of the program: its column's first word and its mask offset.
struct LoadDesc {
  const uint32_t* col;
  int offset;
  int pad;
};

// The load's M31 value at each of a thread's rows.
template <int kRows>
__device__ __forceinline__ void issue_load(const LoadDesc& load,
                                           const uint32_t (&row)[kRows],
                                           int log_n, int trace_log,
                                           uint32_t (&out)[kRows]) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const uint32_t src = load.offset == 0
                             ? row[r]
                             : source_row(row[r], log_n, trace_log, load.offset);
    out[r] = __ldg(load.col + src);
  }
}

// Slot s, row r of a thread lies at its base + (s * kRows + r) * kThreads;
// a secure value's coordinate j at slot s + j.  Loads run kDepth ahead:
// the global read of the program's (k + kDepth)-th load is issued when the
// k-th stores its value, from registers, into its slot.
template <int kRows>
__global__ void __launch_bounds__(kThreads, 4)
constraint_eval_kernel(const int4* __restrict__ program, int n_instr,
                       const int4* __restrict__ load_rows, int n_loads,
                       const uint32_t* __restrict__ scalars, int n_scalars,
                       int denom_off, Interactions tab,
                       uint32_t* __restrict__ acc, int log_n, int trace_log,
                       int chunk) {
  constexpr int kSlot = kRows * kThreads;  // words between two slots
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int4* prog = reinterpret_cast<int4*>(smem_raw);  // the current chunk
  LoadDesc* loads = reinterpret_cast<LoadDesc*>(prog + chunk);  // in order
  uint32_t* sc = reinterpret_cast<uint32_t*>(loads + n_loads);
  uint32_t* regs = sc + ((n_scalars + 3) & ~3);
  const bool one_chunk = n_instr <= chunk;
  if (one_chunk) {
    for (int i = threadIdx.x; i < n_instr; i += kThreads) prog[i] = program[i];
  }
  for (int i = threadIdx.x; i < n_scalars; i += kThreads) sc[i] = scalars[i];
  for (int k = threadIdx.x; k < n_loads; k += kThreads) {
    const int4 row = load_rows[k];  // (interaction, column, offset, 0)
    const int i = row.x < kMaxInteractions ? row.x : 0;
    loads[k] = {tab.ptr[i] + row.y * tab.stride[i], row.z, 0};
  }
  __syncthreads();

  const long long n = 1LL << log_n;
  uint32_t* const my = regs + threadIdx.x;
  for (long long tile = static_cast<long long>(blockIdx.x) * kSlot; tile < n;
       tile += static_cast<long long>(gridDim.x) * kSlot) {
    uint32_t row[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const long long i = tile + r * kThreads + threadIdx.x;
      row[r] = i < n ? static_cast<uint32_t>(i) : 0;  // past n: row 0, unsaved
    }
    uint64_t sum[kRows][4];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
      for (int j = 0; j < 4; ++j) sum[r][j] = 0;
    }
    uint32_t ahead[kDepth][kRows];
#pragma unroll
    for (int q = 0; q < kDepth; ++q) {
      if (q < n_loads) issue_load<kRows>(loads[q], row, log_n, trace_log, ahead[q]);
    }
    int next_load = kDepth;  // the next load to issue, its descriptor read
    LoadDesc next_desc = loads[next_load < n_loads ? next_load : 0];
    auto step = [&](const int4& ins) {
      // slot operands (an instruction that reads a value or column index
      // there never dereferences these)
      uint32_t* const d = my + static_cast<unsigned>(ins.y) * kSlot;
      const uint32_t* const a = my + static_cast<unsigned>(ins.z) * kSlot;
      const uint32_t* const b = my + static_cast<unsigned>(ins.w) * kSlot;
      switch (ins.x & 0xff) {
        case kLoad: {
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            d[r * kThreads] = ahead[0][r];
#pragma unroll
            for (int q = 0; q + 1 < kDepth; ++q) ahead[q][r] = ahead[q + 1][r];
          }
          if (next_load < n_loads) {
            issue_load<kRows>(next_desc, row, log_n, trace_log, ahead[kDepth - 1]);
            if (++next_load < n_loads) next_desc = loads[next_load];
          }
          break;
        }
        case kConstB:
#pragma unroll
          for (int r = 0; r < kRows; ++r) d[r * kThreads] = ins.z;
          break;
        case kScalarS:
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const uint32_t v = sc[ins.z + j];
#pragma unroll
            for (int r = 0; r < kRows; ++r) d[j * kSlot + r * kThreads] = v;
          }
          break;
        case kAddB:
#pragma unroll
          for (int r = 0; r < kRows; ++r)
            d[r * kThreads] = m31_add(a[r * kThreads], b[r * kThreads]);
          break;
        case kSubB:
#pragma unroll
          for (int r = 0; r < kRows; ++r)
            d[r * kThreads] = m31_sub(a[r * kThreads], b[r * kThreads]);
          break;
        case kMulB:
#pragma unroll
          for (int r = 0; r < kRows; ++r)
            d[r * kThreads] = m31_mul(a[r * kThreads], b[r * kThreads]);
          break;
        case kSqrB:
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            const uint32_t x = a[r * kThreads];
            d[r * kThreads] = m31_mul(x, x);
          }
          break;
        case kNegB:
#pragma unroll
          for (int r = 0; r < kRows; ++r) d[r * kThreads] = m31_neg(a[r * kThreads]);
          break;
        case kAddS:
#pragma unroll
          for (int k = 0; k < 4 * kRows; ++k)
            d[k * kThreads] = m31_add(a[k * kThreads], b[k * kThreads]);
          break;
        case kSubS:
#pragma unroll
          for (int k = 0; k < 4 * kRows; ++k)
            d[k * kThreads] = m31_sub(a[k * kThreads], b[k * kThreads]);
          break;
        case kNegS:
#pragma unroll
          for (int k = 0; k < 4 * kRows; ++k)
            d[k * kThreads] = m31_neg(a[k * kThreads]);
          break;
        case kMulS:
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            uint32_t x[4], y[4], z[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              x[j] = a[j * kSlot + r * kThreads];
              y[j] = b[j * kSlot + r * kThreads];
            }
            qm31_mul(x, y, z);
#pragma unroll
            for (int j = 0; j < 4; ++j) d[j * kSlot + r * kThreads] = z[j];
          }
          break;
        case kPromote:
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            d[r * kThreads] = a[r * kThreads];
#pragma unroll
            for (int j = 1; j < 4; ++j) d[j * kSlot + r * kThreads] = 0;
          }
          break;
        case kCombineLo:
        case kCombineHi: {
          uint32_t* const e = d + ((ins.x & 0xff) == kCombineHi ? 2 * kSlot : 0);
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            e[r * kThreads] = a[r * kThreads];
            e[kSlot + r * kThreads] = b[r * kThreads];
          }
          break;
        }
        case kAccumB: {
          const uint32_t c0 = sc[ins.w], c1 = sc[ins.w + 1];
          const uint32_t c2 = sc[ins.w + 2], c3 = sc[ins.w + 3];
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            const uint64_t v = a[r * kThreads];
            sum[r][0] += v * c0;
            sum[r][1] += v * c1;
            sum[r][2] += v * c2;
            sum[r][3] += v * c3;
          }
          if (ins.x & kFold) {
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
#pragma unroll
              for (int j = 0; j < 4; ++j) sum[r][j] = fold64(sum[r][j]);
            }
          }
          break;
        }
        case kAccumS: {
          const uint32_t c[4] = {sc[ins.w], sc[ins.w + 1], sc[ins.w + 2],
                                 sc[ins.w + 3]};
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            uint32_t x[4], z[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) x[j] = a[j * kSlot + r * kThreads];
            qm31_mul(x, c, z);
#pragma unroll
            for (int j = 0; j < 4; ++j) sum[r][j] += z[j];
          }
          if (ins.x & kFold) {
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
#pragma unroll
              for (int j = 0; j < 4; ++j) sum[r][j] = fold64(sum[r][j]);
            }
          }
          break;
        }
        default:
          break;
      }
    };
    for (int base = 0; base < n_instr; base += chunk) {
      const int len = n_instr - base < chunk ? n_instr - base : chunk;
      if (!one_chunk) {  // every thread is past the last chunk's reads
        __syncthreads();
        for (int i = threadIdx.x; i < len; i += kThreads) {
          prog[i] = program[base + i];
        }
        __syncthreads();
      }
      // two instructions a turn: each one's read from shared memory is in
      // flight while the other runs, and no copy passes between them
      int4 ins = prog[0];
      for (int pc = 0; pc < len; pc += 2) {
        const int4 other = prog[pc + 1 < len ? pc + 1 : pc];
        step(ins);
        if (pc + 1 >= len) break;
        ins = prog[pc + 2 < len ? pc + 2 : pc];
        step(other);
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (tile + r * kThreads + threadIdx.x >= n) continue;
      const uint32_t i = row[r];
      const uint32_t dinv = sc[denom_off + (i >> trace_log)];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t* const out = acc + j * n + i;
        *out = m31_add(*out, m31_mul(reduce64(sum[r][j]), dinv));
      }
    }
  }
}

size_t smem_bytes(int rows, int chunk, int n_loads, int n_scalars,
                  int n_slots) {
  return static_cast<size_t>(chunk) * sizeof(int4) +
         static_cast<size_t>(n_loads) * sizeof(LoadDesc) +
         static_cast<size_t>((n_scalars + 3) & ~3) * 4 +
         static_cast<size_t>(n_slots) * rows * kThreads * 4;
}

template <int kRows>
int launch(const int4* program, int n_instr, const int4* loads, int n_loads,
           const uint32_t* scalars, int n_scalars, int denom_off,
           const Interactions& tab, uint32_t* acc, int log_n, int trace_log,
           int chunk, size_t smem, cudaStream_t stream) {
  auto kernel = constraint_eval_kernel<kRows>;
  if (smem > 48 * 1024) {  // on the current device, every call
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  int device = 0, sms = 132, per_sm = 1;
  if (cudaGetDevice(&device) == cudaSuccess) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  const cudaError_t occ = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, kThreads, smem);
  if (occ != cudaSuccess) return occ;
  if (per_sm < 1) per_sm = 1;
  const long long tiles = ((1LL << log_n) + kRows * kThreads - 1) / (kRows * kThreads);
  const long long resident = static_cast<long long>(sms) * per_sm;
  const unsigned grid = static_cast<unsigned>(tiles < resident ? tiles : resident);
  kernel<<<grid, kThreads, smem, stream>>>(program, n_instr, loads, n_loads,
                                           scalars, n_scalars, denom_off, tab,
                                           acc, log_n, trace_log, chunk);
  return cudaGetLastError();
}

// The rows a thread and the instructions a chunk of a launch: kDefaultRows
// (or the rows asked for) halved, then the chunk halved, until shared
// memory holds them on the current device.  False where nothing fits.
bool launch_shape(int n_instr, int n_loads, int n_scalars, int n_slots,
                  int rows_per_thread, int* rows, int* chunk) {
  int device = 0, limit = 48 * 1024;
  if (cudaGetDevice(&device) == cudaSuccess) {
    cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  }
  *rows = rows_per_thread > 0 ? rows_per_thread : kDefaultRows;
  *chunk = n_instr < kMaxChunk ? (n_instr > 0 ? n_instr : 1) : kMaxChunk;
  constexpr size_t kStaticSmem = 16;
  const auto fits = [&] {
    return smem_bytes(*rows, *chunk, n_loads, n_scalars, n_slots) +
               kStaticSmem <= static_cast<size_t>(limit);
  };
  while (*rows > 1 && !fits()) *rows /= 2;
  while (*chunk > kMinChunk && !fits()) *chunk /= 2;
  return fits();
}

}  // namespace

// The launch's rows a thread and instructions a chunk (out[0], out[1]) for
// a program of these sizes on the current device; 0, or
// cudaErrorInvalidValue where its slots and tables do not fit.
extern "C" int tstwo_constraint_eval_shape(int n_instr, int n_loads,
                                           int n_scalars, int n_slots,
                                           int rows_per_thread, int* out) {
  return launch_shape(n_instr, n_loads, n_scalars, n_slots, rows_per_thread,
                      &out[0], &out[1])
             ? 0
             : cudaErrorInvalidValue;
}

// program: n_instr instructions (int32 x 4 each); loads: its n_loads LOAD
// rows (interaction, column, offset, 0), in program order (ops/
// constraint_eval.py load_table); scalars: n_scalars words,
// the denominator inverses from denom_off; ptrs, strides: the extended
// columns of each of up to 8 interactions ([B, 2^log_n] rows at `stride`
// words, null for an interaction the program does not read); acc: [4,
// 2^log_n], updated in place.  n_slots: the program's slots.
// rows_per_thread: 1, 2, 4 or 8, or 0 for the default; fewer are taken
// where the slots do not fit in shared memory, then a smaller chunk of the
// program.  1 <= log_n <= 30.  Returns the cudaError_t of the launch, or 0.
extern "C" int tstwo_constraint_eval(const int32_t* program, int n_instr,
                                     const int32_t* loads, int n_loads,
                                     const int32_t* scalars, int n_scalars,
                                     int denom_off, const void* const* ptrs,
                                     const long long* strides, int32_t* acc,
                                     int log_n, int trace_log, int n_slots,
                                     int rows_per_thread, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (log_n < 1 || log_n > 30 || trace_log < 0 || trace_log > log_n ||
      n_instr < 0 || n_loads < 0 || n_loads > n_instr || n_scalars < 0 ||
      n_slots < 0) {
    return cudaErrorInvalidValue;
  }
  Interactions tab;
  for (int i = 0; i < kMaxInteractions; ++i) {
    tab.ptr[i] = static_cast<const uint32_t*>(ptrs[i]);
    tab.stride[i] = strides[i];
  }
  int rows = 0, chunk = 0;
  if (!launch_shape(n_instr, n_loads, n_scalars, n_slots, rows_per_thread,
                    &rows, &chunk)) {
    return cudaErrorInvalidValue;
  }
  const size_t smem = smem_bytes(rows, chunk, n_loads, n_scalars, n_slots);
  const auto* prog = reinterpret_cast<const int4*>(program);
  const auto* ld = reinterpret_cast<const int4*>(loads);
  const auto* sc = reinterpret_cast<const uint32_t*>(scalars);
  auto* out = reinterpret_cast<uint32_t*>(acc);
  switch (rows) {
    case 1:
      return launch<1>(prog, n_instr, ld, n_loads, sc, n_scalars, denom_off,
                         tab, out, log_n, trace_log, chunk, smem, stream);
    case 2:
      return launch<2>(prog, n_instr, ld, n_loads, sc, n_scalars, denom_off,
                         tab, out, log_n, trace_log, chunk, smem, stream);
    case 4:
      return launch<4>(prog, n_instr, ld, n_loads, sc, n_scalars, denom_off,
                         tab, out, log_n, trace_log, chunk, smem, stream);
    case 8:
      return launch<8>(prog, n_instr, ld, n_loads, sc, n_scalars, denom_off,
                         tab, out, log_n, trace_log, chunk, smem, stream);
    default:
      return cudaErrorInvalidValue;
  }
}
