// Even/odd split of the last axis: (x[..., 0::2], x[..., 1::2]).
//
// Replaces tstwo_tpu/ops/pallas/interleave.py::deinterleave_pallas
// (_deinterleave_pallas_impl, body _body).
//
// What bounds it on the H100: device-memory bytes; it computes nothing.
// The TPU kernel routed the pair bit through a transpose because a
// stride-2 lane gather is slow there.  Here each thread loads one aligned
// 8-byte pair and stores its two halves, neighbouring threads on
// neighbouring pairs, so every load and store is coalesced and the column
// crosses device memory once each way.  Rows of a contiguous [R, n] array
// with n even are consecutive pairs, so the kernel is one flat pass over
// R * n / 2 pairs; n % 256 was the TPU's tiling, not a need here.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__global__ void deinterleave_kernel(const int2* __restrict__ src,
                                    int32_t* __restrict__ even,
                                    int32_t* __restrict__ odd, long long pairs) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= pairs) return;
  const int2 p = src[i];
  even[i] = p.x;
  odd[i] = p.y;
}

}  // namespace

// src: 8-byte aligned, `pairs` int32 pairs; even, odd: `pairs` int32 each.
// Returns the cudaError_t of the launch, or 0.
extern "C" int tstwo_deinterleave(const int32_t* src, int32_t* even, int32_t* odd,
                                  long long pairs, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const unsigned grid = static_cast<unsigned>((pairs + kThreads - 1) / kThreads);
  deinterleave_kernel<<<grid, kThreads, 0, stream>>>(
      reinterpret_cast<const int2*>(src), even, odd, pairs);
  return cudaGetLastError();
}
