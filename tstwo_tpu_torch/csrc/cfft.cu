// Circle FFT, forward and inverse, over a batch of M31 columns.
//
// Replaces tstwo_tpu/ops/pallas/fft_kernels.py::fft_large (its forward
// _fft_large_impl and its inverse _ifft_large_u_impl) and ::fft_fused.
//
// What bounds it on the H100: device-memory bytes.  A butterfly is one
// M31 multiply and two adds on 8 bytes read and 8 written, far below the
// card's ratio of operations to bytes, so the cost is how many times the
// column crosses device memory.  The design keeps that to a few passes:
//   * block-resident stage: one thread block loads a 2^c chunk of one
//     column into shared memory (8 KB), applies every layer with stride
//     < 2^c there -- for a column of at most 2^c values that is the whole
//     transform, fft_fused's job -- and writes it back: one pass;
//   * global stage: each layer with stride >= 2^c is one launch with one
//     thread per butterfly, neighbouring threads on neighbouring words.
// Forward runs the global layers with decreasing stride, then the block
// stage; inverse runs the block stage, then the global layers with
// increasing stride (natural DIT order: the TPU's bit-reversed "u-space"
// inverse was a Mosaic workaround and is not needed here).  The inverse
// leaves out the 1/N scaling, as the JAX caller does.
//
// Twiddles: one buffer per (twiddle tree, domain size, direction), the
// circle layer (n/2 values) followed by line layers 1..log_n-1 (n/4, ...,
// 1 values), so layer l starts at n - (n >> l).  Layer l pairs index
// i0 = h * 2^(l+1) + low with i0 + 2^l and uses twiddle h.
//
// Batch: columns are rows of a contiguous [batch, n] int32 array; the
// batch runs on gridDim.y.  src may equal dst (the transform is in place
// after the first launch).
#include <cuda_runtime.h>

#include <cstdint>

#include "m31.cuh"

using namespace tstwo;

namespace {

constexpr int kChunkLog = 11;      // 2^11 values = 8 KB of shared memory
constexpr int kBlockThreads = 512;  // each does 2 butterflies a layer
constexpr int kLayerThreads = 256;

__device__ __forceinline__ void butterfly(uint32_t& v0, uint32_t& v1,
                                          uint32_t t, bool inverse) {
  if (!inverse) {
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

__global__ void cfft_block_kernel(const uint32_t* src, uint32_t* dst,
                                  const uint32_t* __restrict__ tw, int log_n,
                                  int c, bool inverse) {
  extern __shared__ uint32_t s[];
  const int chunk = 1 << c;
  const size_t n = size_t(1) << log_n;
  const size_t base = size_t(blockIdx.x) << c;
  const size_t row = size_t(blockIdx.y) * n;
  for (int i = threadIdx.x; i < chunk; i += blockDim.x) s[i] = src[row + base + i];
  __syncthreads();
  for (int step = 0; step < c; ++step) {
    const int l = inverse ? step : c - 1 - step;
    const uint32_t* t = tw + (n - (n >> l));
    for (int b = threadIdx.x; b < chunk / 2; b += blockDim.x) {
      const int low = b & ((1 << l) - 1);
      const int i0 = ((b >> l) << (l + 1)) | low;
      const int i1 = i0 + (1 << l);
      uint32_t v0 = s[i0], v1 = s[i1];
      butterfly(v0, v1, t[(base + i0) >> (l + 1)], inverse);
      s[i0] = v0;
      s[i1] = v1;
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < chunk; i += blockDim.x) dst[row + base + i] = s[i];
}

__global__ void cfft_layer_kernel(const uint32_t* src, uint32_t* dst,
                                  const uint32_t* __restrict__ tw, int log_n,
                                  int l, bool inverse) {
  const size_t n = size_t(1) << log_n;
  const size_t b = size_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= n / 2) return;
  const size_t row = size_t(blockIdx.y) * n;
  const size_t h = b >> l;
  const size_t i0 = (h << (l + 1)) | (b & ((size_t(1) << l) - 1));
  const size_t i1 = i0 + (size_t(1) << l);
  uint32_t v0 = src[row + i0], v1 = src[row + i1];
  butterfly(v0, v1, tw[(n - (n >> l)) + h], inverse);
  dst[row + i0] = v0;
  dst[row + i1] = v1;
}

}  // namespace

// Returns the cudaError_t of the first failed launch, or 0.
extern "C" int tstwo_cfft(const int32_t* src, int32_t* dst,
                          const int32_t* twiddles, int batch, int log_n,
                          int inverse, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const uint32_t* in = reinterpret_cast<const uint32_t*>(src);
  uint32_t* out = reinterpret_cast<uint32_t*>(dst);
  const uint32_t* tw = reinterpret_cast<const uint32_t*>(twiddles);
  const size_t n = size_t(1) << log_n;
  const int c = log_n < kChunkLog ? log_n : kChunkLog;
  const int block_threads = (1 << c) / 2 < kBlockThreads ? (1 << c) / 2 : kBlockThreads;
  const dim3 block_grid(static_cast<unsigned>(n >> c), batch);
  const dim3 layer_grid(static_cast<unsigned>((n / 2 + kLayerThreads - 1) / kLayerThreads),
                        batch);
  const size_t smem = sizeof(uint32_t) << c;
  cudaError_t err;
  if (!inverse) {
    for (int l = log_n - 1; l >= c; --l) {
      cfft_layer_kernel<<<layer_grid, kLayerThreads, 0, stream>>>(in, out, tw, log_n, l, false);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
      in = out;
    }
    cfft_block_kernel<<<block_grid, block_threads, smem, stream>>>(in, out, tw, log_n, c, false);
    return cudaGetLastError();
  }
  cfft_block_kernel<<<block_grid, block_threads, smem, stream>>>(in, out, tw, log_n, c, true);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  for (int l = c; l < log_n; ++l) {
    cfft_layer_kernel<<<layer_grid, kLayerThreads, 0, stream>>>(out, out, tw, log_n, l, true);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}
