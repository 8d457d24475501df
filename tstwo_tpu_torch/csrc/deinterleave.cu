// Even/odd split of the last axis: (x[..., 0::2], x[..., 1::2]).
//
// Replaces tstwo_tpu/ops/pallas/interleave.py::deinterleave_pallas
// (_deinterleave_pallas_impl, body _body).
//
// What bounds it on the H100: device-memory bytes; it computes nothing.
// The TPU kernel routed the pair bit through a transpose because a
// stride-2 lane gather is slow there.  Here a thread loads 16 aligned
// bytes, two pairs, and stores 8 bytes to each half, neighbouring threads
// on neighbouring addresses, so every load and store is coalesced and the
// data crosses device memory once each way.  Rows of a contiguous [R, n]
// array with n even are consecutive pairs, so the kernel is one flat pass
// over R * n / 2 pairs; n % 256 was the TPU's tiling, not a need here.
// Measured on the H100 80GB HBM3 at 700 W (chip_smoke.py phase 3, 256
// threads a block): where source and halves fit in the 50 MB L2 a grid
// capped at 8 blocks per SM that strides over the rest is the faster one
// (2^22 values: 7.4 us against 9.0 us for one 8-byte pair a thread), and
// above that one block per 256 loads is (2^25 values: 92.1 us against
// 99.9 us capped), so the launch picks by size.  A source that is
// only 8-byte aligned, or an odd count of pairs (the halves then are not
// both 8-byte aligned), takes one pair a thread.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr long long kResidentBlocks = 132 * 8;  // 8 blocks on each SM
constexpr long long kStrideUpTo = 8 * kResidentBlocks;

__global__ void deinterleave2_kernel(const int4* __restrict__ src,
                                     int2* __restrict__ even,
                                     int2* __restrict__ odd, long long quads) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < quads; i += step) {
    const int4 q = src[i];
    even[i] = make_int2(q.x, q.z);
    odd[i] = make_int2(q.y, q.w);
  }
}

__global__ void deinterleave1_kernel(const int2* __restrict__ src,
                                     int32_t* __restrict__ even,
                                     int32_t* __restrict__ odd, long long pairs) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < pairs; i += step) {
    const int2 p = src[i];
    even[i] = p.x;
    odd[i] = p.y;
  }
}

// One block per kThreads items; a call of up to kStrideUpTo such blocks runs
// as kResidentBlocks blocks that stride over the items.
unsigned grid_for(long long items) {
  const long long blocks = (items + kThreads - 1) / kThreads;
  const bool stride = (blocks > kResidentBlocks && blocks <= kStrideUpTo) ||
                      blocks > 0x7fffffffLL;  // the largest grid
  return static_cast<unsigned>(stride ? kResidentBlocks : blocks);
}

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

// src: 8-byte aligned, `pairs` int32 pairs; even, odd: `pairs` int32 each.
// Returns the cudaError_t of the launch, or 0.
extern "C" int tstwo_deinterleave(const int32_t* src, int32_t* even, int32_t* odd,
                                  long long pairs, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (pairs <= 0 || !aligned(src, 8)) return cudaErrorInvalidValue;
  if (pairs % 2 == 0 && aligned(src, 16) && aligned(even, 8) && aligned(odd, 8)) {
    const long long quads = pairs / 2;
    deinterleave2_kernel<<<grid_for(quads), kThreads, 0, stream>>>(
        reinterpret_cast<const int4*>(src), reinterpret_cast<int2*>(even),
        reinterpret_cast<int2*>(odd), quads);
  } else {
    deinterleave1_kernel<<<grid_for(pairs), kThreads, 0, stream>>>(
        reinterpret_cast<const int2*>(src), even, odd, pairs);
  }
  return cudaGetLastError();
}
