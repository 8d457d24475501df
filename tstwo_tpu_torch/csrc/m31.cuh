// M31 = GF(2^31 - 1) arithmetic shared by the CUDA kernels.
//
// Replaces the 16-bit-limb product of tstwo_tpu/ops/m31.py::mul (and the
// probe kernels tstwo_tpu/ops/pallas/m31_kernels.py::mul, ::mul_chain,
// which use it): the TPU has no widening multiply, Hopper does.  The
// product is one 32x32->64 multiply folded twice with 2^31 == 1 (mod P).
// Inputs are canonical (< P); outputs are canonical, with P mapped to 0.
#pragma once

#include <cstdint>

namespace tstwo {

constexpr uint32_t M31_P = 0x7fffffffu;

__device__ __forceinline__ uint32_t m31_add(uint32_t a, uint32_t b) {
  const uint32_t s = a + b;  // < 2P - 1 < 2^32
  return s >= M31_P ? s - M31_P : s;
}

__device__ __forceinline__ uint32_t m31_sub(uint32_t a, uint32_t b) {
  const uint32_t s = a + (M31_P - b);  // in (0, 2P)
  return s >= M31_P ? s - M31_P : s;
}

__device__ __forceinline__ uint32_t m31_mul(uint32_t a, uint32_t b) {
  const uint64_t p = static_cast<uint64_t>(a) * b;  // < 2^62
  // p = hi * 2^31 + lo == hi + lo; the sum is < 2^32
  uint32_t s = static_cast<uint32_t>(p & M31_P) + static_cast<uint32_t>(p >> 31);
  s = (s & M31_P) + (s >> 31);  // <= 2^31
  return s >= M31_P ? s - M31_P : s;
}

}  // namespace tstwo
