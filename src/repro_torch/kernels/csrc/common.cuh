// Shared device helpers for the MGD kernels: the murmur3 counter hash that
// regenerates the Rademacher perturbation at the parameter, and f32/bf16
// loads and stores.  The hash must stay bit-identical to
// repro_torch/core/perturbations.py (and to the JAX package's
// repro/core/perturbations.py): uint32 arithmetic, wrapping.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mgd {

constexpr uint32_t kGolden = 0x9E3779B9u;
constexpr uint32_t kM1 = 0x85EBCA6Bu;
constexpr uint32_t kM2 = 0xC2B2AE35u;

// dtype codes shared with the Python wrappers
constexpr int kF32 = 0;
constexpr int kBF16 = 1;

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= kM1;
  x ^= x >> 13;
  x *= kM2;
  x ^= x >> 16;
  return x;
}

// ±1 sign of the element with row-major linear index `idx` under `lseed`:
// 1 − 2·(fmix32(idx·G + lseed) >> 31).
__device__ __forceinline__ float rademacher_sign(uint32_t idx, uint32_t lseed) {
  return (fmix32(idx * kGolden + lseed) >> 31) ? -1.0f : 1.0f;
}

// Bit 31 of fmix32(x), in place (0 or 0x80000000u).  fmix32's last step,
// x ^= x >> 16, leaves bit 31 as it is, so it is skipped.
__device__ __forceinline__ uint32_t sign_bit(uint32_t x) {
  x ^= x >> 16;
  x *= kM1;
  x ^= x >> 13;
  x *= kM2;
  return x & 0x80000000u;
}

// t·(1 − 2·(bit >> 31)) for bit = sign_bit(x): a sign flip, exact, so it
// equals the f32 product by the ±1 of rademacher_sign bit for bit.
__device__ __forceinline__ float apply_sign(float t, uint32_t bit) {
  return __uint_as_float(__float_as_uint(t) ^ bit);
}

__device__ __forceinline__ float load_f32(const float* p, long long i) {
  return p[i];
}
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_f32(float* p, long long i, float v) {
  p[i] = v;
}
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, long long i, float v) {
  p[i] = __float2bfloat16(v);  // round to nearest even, as torch's .to()
}

}  // namespace mgd
