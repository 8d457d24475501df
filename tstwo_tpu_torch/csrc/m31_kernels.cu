// M31 probe kernels: an elementwise product and a dependent product chain.
//
// Replaces tstwo_tpu/ops/pallas/m31_kernels.py::mul (body _mul_body) and
// ::mul_chain (body _mul_chain_body), the roofline probes of the M31
// multiply.
//
// What bounds them on the H100: `mul` moves 12 bytes per product (two
// reads, one write) and is bound by device-memory bandwidth.  `mul_chain`
// applies `reps` dependent products to each element with one read of each
// input and one write, so at reps 8 it does 8x the arithmetic per byte;
// that is the compute-leaning shape.  The product is m31_mul of m31.cuh
// (one 32x32->64 multiply, two folds): the TPU's 16-bit-limb split existed
// only because the TPU has no widening multiply.  Neither kernel needs the
// TPU's N % 1024 tiling: a grid-stride loop takes any N >= 1, neighbouring
// threads on neighbouring elements.  `reps` is a run-time argument and each
// step reads the previous one's result, so nvcc can neither fold the chain
// nor hoist it.
#include <cuda_runtime.h>

#include <cstdint>

#include "m31.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

__global__ void m31_mul_kernel(const uint32_t* __restrict__ a,
                               const uint32_t* __restrict__ b,
                               uint32_t* __restrict__ out, long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    out[i] = tstwo::m31_mul(a[i], b[i]);
  }
}

__global__ void m31_mul_chain_kernel(const uint32_t* __restrict__ a,
                                     const uint32_t* __restrict__ b,
                                     uint32_t* __restrict__ out, long long n,
                                     int reps) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    uint32_t x = a[i];
    const uint32_t y = b[i];
    for (int r = 0; r < reps; ++r) x = tstwo::m31_mul(x, y);
    out[i] = x;
  }
}

// Enough blocks to fill every SM, and no more than the elements need.
unsigned grid_for(long long n) {
  int device = 0;
  int sms = 132;
  if (cudaGetDevice(&device) == cudaSuccess) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  const long long want = (n + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(sms) * kBlocksPerSm;
  return static_cast<unsigned>(want < cap ? want : cap);
}

}  // namespace

// a, b, out: n canonical M31 values each (n >= 1).  Returns the
// cudaError_t of the launch, or 0.
extern "C" int tstwo_m31_mul(const uint32_t* a, const uint32_t* b, uint32_t* out,
                             long long n, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  m31_mul_kernel<<<grid_for(n), kThreads, 0, stream>>>(a, b, out, n);
  return cudaGetLastError();
}

// out[i] = a[i] * b[i]^reps, as `reps` dependent products (reps >= 0).
extern "C" int tstwo_m31_mul_chain(const uint32_t* a, const uint32_t* b,
                                   uint32_t* out, long long n, int reps,
                                   void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  m31_mul_chain_kernel<<<grid_for(n), kThreads, 0, stream>>>(
      a, b, out, n, reps);
  return cudaGetLastError();
}
