// Circle FFT, forward and inverse, over a batch of M31 columns.
//
// Replaces tstwo_tpu/ops/pallas/fft_kernels.py::fft_large (its forward
// _fft_large_impl and its inverse _ifft_large_u_impl, with scale_n_inv) and
// ::fft_fused.  It computes the layered transform of ops/fft.py::fft_plain
// bit for bit: layer l pairs index i0 = h * 2^(l+1) + low with i0 + 2^l
// under twiddle h; forward runs layers log_n-1 .. 0, inverse 0 .. log_n-1.
//
// What bounds it on the H100.  A butterfly is 16 integer instructions (one
// M31 product, one modular add, one modular subtract) on 8 bytes read and 8
// written.  With one pass over device memory for every layer the bytes
// bound it; once a pass does ten or more layers on chip the integer
// instructions do (16 * log_n / 2 a word against 8 bytes a word and pass).
// So the design is (a) few passes and (b) nothing but butterflies in them.
//
// Pass plan (the same as ops/fft.py::cfft_plan, which the tests pin):
//   log_n <= 12        one contiguous pass, all layers (a tile of 2^10
//                      words up to log_n = 10, so that a few thousand
//                      points still spread over many SMs);
//   log_n 13 .. 22     a contiguous pass (layers 0 .. c-1) and a strided
//                      pass (the k = max(4, log_n - 12) layers above,
//                      c = log_n - k);
//   log_n 23 .. 30     a contiguous pass (c = 12) and two strided passes
//                      that halve the rest (at most 9 layers each).
// The inverse runs them in this order, the forward in the reverse order.
// Every pass reads its tile from device memory once, does all of its
// layers on chip, and writes the tile once; a block reads all of its tile
// before it writes any of it, so a pass is safe in place.  The first pass
// reads the caller's array and writes `dst`, the later ones run on `dst`.
//
// Tiles.  A contiguous pass gives a block 2^12 (or 2^10) consecutive words (of one
// column, or of several whole columns when a column is shorter: the
// [batch, n] array is one flat run of words).  A strided pass over layers
// s .. s+k-1 gives a block 2^k rows, 2^s words apart, by W consecutive
// words, W = max(8, 2^12 / 2^k): every access to device memory is a whole
// 32-byte sector, a whole 128-byte line from W = 32.  Both are one kernel:
// a tile of 2^K rows by W words in which the layers act on the row index
// (K = 12, W = 1, s = 0 for the contiguous pass).
//
// Registers first.  A thread holds 16 values, the 16 settings of 4 row
// bits (a "window"), and does up to 4 layers on them in registers; a pass
// of up to 12 layers is at most 3 windows.  The first window is loaded
// from device memory straight into registers and the last is stored from
// them (16-byte accesses where the 16 values are consecutive words, which
// is the contiguous pass's low window); values cross threads through
// shared memory only between windows: two exchanges and two barriers for
// 12 layers, against a round trip and a barrier a layer.  The tile's shape
// and the number of layers are template parameters (14 contiguous and 7
// strided instances a direction), so the windows, the register pairs of
// every butterfly and the exchange offsets are constants: what is left at
// run time is the butterflies and one address a word.  The contiguous
// pass was also tried with its number of layers read at run time (2 + 7
// instances a direction, the last window's layers under a predicate that
// is the same for every thread): no spills at 105-117 registers, and yet
// 9-23% more time at every shape from 2^16 to 2^24 points and 45-60% more
// at 2^10 and 2^6 (H100 80GB HBM3, 700 W), for 1.5-2 s less compile time.
// So the layers stay a template parameter.
//
// Shared-memory layout.  Word f = row * W + x of the tile lies at
// f ^ (((f >> (4 + log W)) & (32 / W - 1)) * W) for W < 32, at f otherwise:
// row bits 4.. are xor-ed into the bank bits that x leaves free.  In every
// window the 32 lanes of a warp differ in x and in the lowest row bits
// outside the window; those are row bits 0.. (banks by position) or row
// bits 4.. (banks by the xor), so the 32 lanes of each access hit 32
// banks: no padding, no conflicts, and the same formula for every W.  It
// is linear over xor, so register m's address is the thread's base xor a
// constant.
//
// Twiddles once for many columns.  The twiddle of layer l depends only on
// the row (i0 >> (l+1)), not on the column or on x.  A thread loads the at
// most 15 twiddles of each of its windows into registers once (45 for 12
// layers) and then walks over `cols` columns of the batch at the same
// tile.  The launcher picks `cols` so that the grid still has about 1024
// blocks (132 SMs, 2 blocks of 256 threads each at up to 128 registers):
// 1 for a batch of one column, up to 16 for wide traces.  Registers are
// the scarce resource: 16 values, 45 twiddles and the addresses fit only
// because the addresses are recomputed in every column (see the loop).
//
// Inside the kernel, as in the TPU kernel: the inverse's last pass
// multiplies by `scale` (1/N; 1 means none) before its store, and the
// forward's first pass reads words at or past the coefficient length
// m = 2^log_m as zero (the layers above log_m then copy, which the same
// butterfly computes exactly with a zero product).
//
// Twiddles: one buffer per (twiddle tree, domain size, direction), the
// circle layer (n/2 values) followed by line layers 1..log_n-1 (n/4, ...,
// 1 values), so layer l starts at n - (n >> l).
//
// Files: the kernel and the plan are in cfft_pass.cuh; this file holds the
// C entry points and the inverse's 21 instances, cfft_forward.cu the
// forward's, so that two nvcc processes share the compile.
#include "cfft_pass.cuh"

using namespace tstwo;
using namespace tstwo::cfft;

namespace tstwo {
namespace cfft {

PassKernel inverse_kernel_of(const Pass& p) { return kernel_of<true>(p); }

}  // namespace cfft
}  // namespace tstwo

namespace {

long long g_kernel_launches = 0;

}  // namespace

// Kernel launches made by tstwo_cfft since the library was loaded.
extern "C" long long tstwo_cfft_kernel_launches() { return g_kernel_launches; }

// The passes of one transform in the order they are launched, 6 ints each:
// contiguous (1 or 0), first layer, layers, rows of the tile, words of a
// row, columns a block walks over.  Returns their count.
extern "C" int tstwo_cfft_describe(int batch, int log_n, int inverse, int* out) {
  Pass plan[kMaxPasses];
  const int count = make_plan(log_n, plan);
  for (int i = 0; i < count; ++i) {
    const Pass& p = plan[inverse ? i : count - 1 - i];
    int* row = out + 6 * i;
    row[0] = p.contiguous;
    row[1] = p.first;
    row[2] = p.layers;
    row[3] = p.contiguous ? 1 : 1 << p.rows_log;
    row[4] = p.contiguous ? 1 << p.rows_log : 1 << p.width_log;
    row[5] = columns_per_block(batch, log_n, p);
  }
  return count;
}

// src: [batch, 2^log_m] (log_m == log_n for the inverse), dst: [batch,
// 2^log_n], both contiguous; src is only read.  Returns the cudaError_t of
// the first failed launch, or 0.
extern "C" int tstwo_cfft(const int32_t* src, int32_t* dst,
                          const int32_t* twiddles, int batch, int log_n,
                          int log_m, int inverse, unsigned scale,
                          void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  Pass plan[kMaxPasses];
  const int count = make_plan(log_n, plan);
  PassArgs a;
  a.src = reinterpret_cast<const uint32_t*>(src);
  a.dst = reinterpret_cast<uint32_t*>(dst);
  a.tw = reinterpret_cast<const uint32_t*>(twiddles);
  a.log_n = log_n;
  a.log_m = log_m;
  a.batch = batch;
  for (int i = 0; i < count; ++i) {
    const Pass& p = plan[inverse ? i : count - 1 - i];
    const int tile_log = p.rows_log + p.width_log;
    a.cols = columns_per_block(batch, log_n, p);
    a.s = p.first;
    a.flat = log_n < tile_log;
    a.vec_load = reinterpret_cast<uintptr_t>(a.src) % 16 == 0 && a.log_m >= 2;
    a.vec_store = reinterpret_cast<uintptr_t>(a.dst) % 16 == 0;
    a.scale = (i == count - 1) ? scale : 1u;
    dim3 grid;
    if (a.flat) {
      const size_t total = size_t(batch) << log_n;
      grid = dim3(static_cast<unsigned>((total + (size_t(1) << tile_log) - 1) >> tile_log));
    } else {
      grid = dim3(1u << (log_n - tile_log),
                  static_cast<unsigned>((batch + a.cols - 1) / a.cols));
    }
    const int threads = 1 << (tile_log - 4);
    const size_t smem = p.layers > 4 ? sizeof(uint32_t) << tile_log : 0;
    const PassKernel kernel = inverse ? inverse_kernel_of(p) : forward_kernel_of(p);
    if (kernel == nullptr) return cudaErrorInvalidValue;
    kernel<<<grid, threads, smem, stream>>>(a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    ++g_kernel_launches;
    a.src = a.dst;
    a.log_m = log_n;
  }
  return cudaSuccess;
}
