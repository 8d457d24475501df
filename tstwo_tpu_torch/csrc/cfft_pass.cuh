// The CFFT's pass kernel and its instances, shared by cfft.cu (the entry
// points and the inverse's instances) and cfft_forward.cu (the forward's):
// two translation units, so that the 42 instances compile in two nvcc
// processes side by side.  The design is described at the top of cfft.cu.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "m31.cuh"

namespace tstwo {
namespace cfft {


constexpr int kChunkLog = 12;     // words of a contiguous tile: 2^12
constexpr int kSmallChunkLog = 10;  // ... and 2^10 for transforms up to 2^10
constexpr int kMaxStridedLog = 10;  // rows of a strided tile: at most 2^10
constexpr int kMinStridedLog = 4;   // and at least one full window
constexpr int kMinWidthLog = 3;     // W >= 8 words: a 32-byte sector
constexpr int kBlockThreads = 512;  // most threads of a block (16 words each)
constexpr int kSharedBytes = 32 << 10;  // largest tile: 2^10 rows x 8 words
constexpr int kTargetBlocks = 1024;  // grid size the column walk aims at
constexpr int kMaxCols = 16;         // most columns a block walks over
constexpr int kMaxPasses = 3;
constexpr int kMaxWindows = 3;     // 12 layers of a pass, 4 a window

static_assert((4 << (kMaxStridedLog + kMinWidthLog)) <= kSharedBytes, "tile");
static_assert((4 << kChunkLog) <= kSharedBytes, "chunk");
static_assert((1 << (kMaxStridedLog + kMinWidthLog - 4)) <= kBlockThreads,
              "threads");

struct Pass {
  int contiguous;  // 1: the contiguous pass, 0: a strided one
  int first;       // lowest layer of the pass (s)
  int layers;      // number of layers
  int rows_log;    // K: the tile has 2^K rows ...
  int width_log;   // ... of 2^width_log words
};

// The passes in the order the inverse runs them; their count.
inline int make_plan(int log_n, Pass* p) {
  if (log_n <= kChunkLog) {
    p[0] = {1, 0, log_n, log_n <= kSmallChunkLog ? kSmallChunkLog : kChunkLog, 0};
    return 1;
  }
  auto strided = [](int first, int k) {
    const int w = kChunkLog - k > kMinWidthLog ? kChunkLog - k : kMinWidthLog;
    return Pass{0, first, k, k, w};
  };
  if (log_n <= kChunkLog + kMaxStridedLog) {
    const int k = log_n - kChunkLog > kMinStridedLog ? log_n - kChunkLog
                                                     : kMinStridedLog;
    p[0] = {1, 0, log_n - k, kChunkLog, 0};
    p[1] = strided(log_n - k, k);
    return 2;
  }
  const int ka = (log_n - kChunkLog) / 2;
  p[0] = {1, 0, kChunkLog, kChunkLog, 0};
  p[1] = strided(kChunkLog, ka);
  p[2] = strided(kChunkLog + ka, log_n - kChunkLog - ka);
  return 3;
}

inline int columns_per_block(int batch, int log_n, const Pass& p) {
  const int tile_log = p.rows_log + p.width_log;
  if (log_n < tile_log) return 1;  // a tile already holds whole columns
  const long long blocks = static_cast<long long>(batch) << (log_n - tile_log);
  long long cols = blocks / kTargetBlocks;
  if (cols > kMaxCols) cols = kMaxCols;
  if (cols > batch) cols = batch;
  return cols < 1 ? 1 : static_cast<int>(cols);
}

struct PassArgs {
  const uint32_t* src;
  uint32_t* dst;
  const uint32_t* tw;
  int log_n;      // a column of dst has 2^log_n words
  int log_m;      // a column of src has 2^log_m; words past it read as zero
  int batch;
  int cols;       // columns a block walks over
  int s;          // lowest layer of the pass
  int flat;       // the tile holds whole columns (a column is shorter)
  int vec_load;   // 16-byte loads allowed
  int vec_store;  // 16-byte stores allowed
  uint32_t scale;  // multiplied in before the store unless 1
};

template <bool kInverse>
__device__ __forceinline__ void butterfly(uint32_t& v0, uint32_t& v1,
                                          uint32_t t) {
  if (!kInverse) {
    const uint32_t p = m31_mul(v1, t);
    const uint32_t a = v0;
    v0 = m31_add(a, p);
    v1 = m31_sub(a, p);
  } else {
    const uint32_t a = v0;
    v0 = m31_add(a, v1);
    v1 = m31_mul(m31_sub(a, v1), t);
  }
}

// A window: row bits [start, start + 4) in registers, of which the pass
// still has to do bits [start + r_lo, start + r_hi).  Window w of a pass
// does layers 4w .. 4w+3; the top one is moved down to fit the tile.  The
// tile's shape is a template parameter, so all of this folds to constants.
struct Window {
  int start, r_lo, r_hi;
};

__host__ __device__ constexpr Window window_of(int w, int rows_log, int layers) {
  const int start = 4 * w < rows_log - 4 ? 4 * w : rows_log - 4;
  const int hi = 4 * w + 4 < layers ? 4 * w + 4 : layers;
  return {start, 4 * w - start, hi - start};
}

// Row of a thread's register m in a window that starts at bit `start`:
// the thread's other row bits `rest` are split around the window.
__device__ __forceinline__ uint32_t row_of(uint32_t rest, int start, int m) {
  return (rest & ((1u << start) - 1)) | (uint32_t(m) << start) |
         ((rest >> start) << (start + 4));
}

// Twiddle slots of a window: bit r uses 8 >> r twiddles from 16 - (16 >> r).
__host__ __device__ constexpr int tw_slot(int r) { return 16 - (16 >> r); }

// Where word f of the tile lies in shared memory (see the header).
template <int kWidthLog>
__device__ __forceinline__ uint32_t swizzle(uint32_t f) {
  constexpr uint32_t mask = kWidthLog < 5 ? (32u >> kWidthLog) - 1 : 0;
  return f ^ (((f >> (4 + kWidthLog)) & mask) << kWidthLog);
}

// One pass: a tile of 2^kRowsLog rows by 2^kWidthLog words, layers
// s .. s + kLayers - 1 on row bits 0 .. kLayers - 1.
template <bool kInverse, int kRowsLog, int kLayers, int kWidthLog>
__global__ void
__launch_bounds__(1 << (kRowsLog + kWidthLog - 4),
                  kBlockThreads >> (kRowsLog + kWidthLog - 4))
cfft_pass_kernel(const PassArgs a) {
  extern __shared__ uint32_t tile[];
  constexpr int kWindows = (kLayers + 3) / 4;
  static_assert(kWindows <= kMaxWindows && kRowsLog >= 4, "windows");
  const uint32_t rest = threadIdx.x >> kWidthLog;
  // the tile: rows hi * 2^K .. of the rows 2^s apart, words lo0 .. of them
  const int lo_tiles_log = a.flat ? 0 : a.s - kWidthLog;
  const uint32_t hi = blockIdx.x >> lo_tiles_log;
  const uint32_t lo0 = (blockIdx.x & ((1u << lo_tiles_log) - 1)) << kWidthLog;
  const uint32_t n = 1u << a.log_n;
  const uint32_t row_mask = (n >> a.s) - 1;  // rows wrap where the tile holds columns

  // this thread's twiddles, for all the columns it walks over
  uint32_t tw[kWindows][15];
#pragma unroll
  for (int e = 0; e < kWindows; ++e) {
    const Window win = window_of(kInverse ? e : kWindows - 1 - e, kRowsLog, kLayers);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      if (r >= win.r_lo && r < win.r_hi) {
        const int b = win.start + r;
        const uint32_t* layer = a.tw + (n - (n >> (a.s + b)));
#pragma unroll
        for (int q = 0; q < (8 >> r); ++q) {
          const uint32_t row = ((hi << kRowsLog) |
                                row_of(rest, win.start, q << (r + 1))) & row_mask;
          tw[e][tw_slot(r) + q] = __ldg(layer + (row >> (b + 1)));
        }
      }
    }
  }

  constexpr Window first = window_of(kInverse ? 0 : kWindows - 1, kRowsLog, kLayers);
  constexpr Window last = window_of(kInverse ? kWindows - 1 : 0, kRowsLog, kLayers);
  const size_t total = size_t(a.batch) << a.log_n;
  const bool zero_extends = a.log_m < a.log_n;
  const int col_end = a.flat ? 1
      : (int(blockIdx.y + 1) * a.cols < a.batch ? int(blockIdx.y + 1) * a.cols : a.batch);
  for (int col = a.flat ? 0 : blockIdx.y * a.cols; col < col_end; ++col) {
    // The addresses below do not depend on the column.  Hoisted out of
    // this loop they would hold some 60 registers beside the 45 twiddles
    // and spill, so they are derived anew from a thread index that the
    // compiler cannot see through, and live only where they are used.
    uint32_t tid = threadIdx.x;
    asm volatile("" : "+r"(tid));
    const uint32_t cx = tid & ((1u << kWidthLog) - 1);
    const uint32_t crest = tid >> kWidthLog;
    // register m of a window holds position pos + (row << s) of the column
    const uint32_t pos = (hi << (a.s + kRowsLog)) + lo0 + cx;
    uint32_t v[16];
    if (a.flat) {
#pragma unroll
      for (int m = 0; m < 16; ++m) {
        const size_t g = (size_t(hi) << kRowsLog) + row_of(crest, first.start, m);
        const size_t i = g & (n - 1);
        v[m] = (g < total && (i >> a.log_m) == 0)
                   ? a.src[((g >> a.log_n) << a.log_m) + i] : 0u;
      }
    } else {
      const uint32_t* src = a.src + (size_t(col) << a.log_m);
      if (kWidthLog == 0 && first.start == 0 && a.vec_load) {
        const uint32_t i0 = pos + row_of(crest, 0, 0);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          uint4 w = make_uint4(0u, 0u, 0u, 0u);
          if (((i0 + 4 * q) >> a.log_m) == 0)
            w = *reinterpret_cast<const uint4*>(src + i0 + 4 * q);
          v[4 * q] = w.x, v[4 * q + 1] = w.y, v[4 * q + 2] = w.z, v[4 * q + 3] = w.w;
        }
      } else {
        const uint32_t i0 = pos + (row_of(crest, first.start, 0) << a.s);
        const uint32_t step = 1u << (first.start + a.s);
        if (zero_extends) {
#pragma unroll
          for (int m = 0; m < 16; ++m)
            v[m] = ((i0 + m * step) >> a.log_m) == 0 ? src[i0 + m * step] : 0u;
        } else {
#pragma unroll
          for (int m = 0; m < 16; ++m) v[m] = src[i0 + m * step];
        }
      }
    }

#pragma unroll
    for (int e = 0; e < kWindows; ++e) {
      const Window win = window_of(kInverse ? e : kWindows - 1 - e, kRowsLog, kLayers);
      if (e > 0) {
        // exchange: the previous window's registers out, this one's in.
        // A thread writes only words that it read itself in the exchange
        // before, so one barrier an exchange is enough inside a column.
        // The layout is linear over xor, and register m only sets bits
        // that the rest leaves clear: one xor with a constant a word.
        const Window prev = window_of(kInverse ? e - 1 : kWindows - e, kRowsLog, kLayers);
        const uint32_t out0 =
            swizzle<kWidthLog>((row_of(crest, prev.start, 0) << kWidthLog) | cx);
#pragma unroll
        for (int m = 0; m < 16; ++m)
          tile[out0 ^ swizzle<kWidthLog>(uint32_t(m) << (prev.start + kWidthLog))] = v[m];
        __syncthreads();
        const uint32_t in0 =
            swizzle<kWidthLog>((row_of(crest, win.start, 0) << kWidthLog) | cx);
#pragma unroll
        for (int m = 0; m < 16; ++m)
          v[m] = tile[in0 ^ swizzle<kWidthLog>(uint32_t(m) << (win.start + kWidthLog))];
      }
#pragma unroll
      for (int step = 0; step < 4; ++step) {
        const int r = kInverse ? step : 3 - step;
        if (r >= win.r_lo && r < win.r_hi) {
#pragma unroll
          for (int p = 0; p < 8; ++p) {
            const int m0 = ((p >> r) << (r + 1)) | (p & ((1 << r) - 1));
            butterfly<kInverse>(v[m0], v[m0 | (1 << r)], tw[e][tw_slot(r) + (p >> r)]);
          }
        }
      }
    }
    // the next column's first write must not overtake this column's reads
    if (kWindows > 1 && col + 1 < col_end) __syncthreads();

    if (a.scale != 1u) {
#pragma unroll
      for (int m = 0; m < 16; ++m) v[m] = m31_mul(v[m], a.scale);
    }
    if (a.flat) {
#pragma unroll
      for (int m = 0; m < 16; ++m) {
        const size_t g = (size_t(hi) << kRowsLog) + row_of(crest, last.start, m);
        if (g < total) a.dst[g] = v[m];
      }
    } else {
      uint32_t* dst = a.dst + (size_t(col) << a.log_n);
      if (kWidthLog == 0 && last.start == 0 && a.vec_store) {
        uint4* out = reinterpret_cast<uint4*>(dst + pos + row_of(crest, 0, 0));
#pragma unroll
        for (int q = 0; q < 4; ++q)
          out[q] = make_uint4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
      } else {
        const uint32_t i0 = pos + (row_of(crest, last.start, 0) << a.s);
        const uint32_t step = 1u << (last.start + a.s);
#pragma unroll
        for (int m = 0; m < 16; ++m) dst[i0 + m * step] = v[m];
      }
    }
  }
}

using PassKernel = void (*)(const PassArgs);

// The kernel of a pass: one instance a tile shape (14 contiguous ones, by
// their number of layers and tile; 7 strided ones, by their rows).
template <bool kInverse>
PassKernel kernel_of(const Pass& p) {
#define TSTWO_CONTIGUOUS(L) \
  case L: return cfft_pass_kernel<kInverse, kChunkLog, L, 0>;
#define TSTWO_SMALL(L) \
  case L: return cfft_pass_kernel<kInverse, kSmallChunkLog, L, 0>;
#define TSTWO_STRIDED(K)                                              \
  case K: return cfft_pass_kernel<kInverse, K, K,                      \
                                  (kChunkLog - K > kMinWidthLog       \
                                       ? kChunkLog - K : kMinWidthLog)>;
  if (p.contiguous && p.rows_log == kSmallChunkLog) {
    switch (p.layers) {
      TSTWO_SMALL(1) TSTWO_SMALL(2) TSTWO_SMALL(3) TSTWO_SMALL(4) TSTWO_SMALL(5)
      TSTWO_SMALL(6) TSTWO_SMALL(7) TSTWO_SMALL(8) TSTWO_SMALL(9) TSTWO_SMALL(10)
    }
  } else if (p.contiguous) {
    switch (p.layers) {
      TSTWO_CONTIGUOUS(9) TSTWO_CONTIGUOUS(10) TSTWO_CONTIGUOUS(11)
      TSTWO_CONTIGUOUS(12)
    }
  } else {
    switch (p.layers) {
      TSTWO_STRIDED(4) TSTWO_STRIDED(5) TSTWO_STRIDED(6) TSTWO_STRIDED(7)
      TSTWO_STRIDED(8) TSTWO_STRIDED(9) TSTWO_STRIDED(10)
    }
  }
#undef TSTWO_CONTIGUOUS
#undef TSTWO_SMALL
#undef TSTWO_STRIDED
  return nullptr;
}

// Defined in cfft_forward.cu and cfft.cu, each instantiating one direction.
PassKernel forward_kernel_of(const Pass& p);
PassKernel inverse_kernel_of(const Pass& p);

}  // namespace cfft
}  // namespace tstwo
