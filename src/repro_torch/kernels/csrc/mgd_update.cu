// MGD parameter updates on Hopper (sm_90a): two entry points.
//
// 1. Exact-order window update.  Replaces the Pallas TPU kernel
//    src/repro/kernels/mgd_update.py::mgd_update_window (_window_kernel):
//
//   for j = 0..J−1 in order:  W ← W + S_j·term_j,   term_j = α·(Δθ·coef_j)
//   S_j[i] = 1 − 2·(fmix32(i·0x9E3779B9 + lseed_j) >> 31), i the row-major
//   linear index of the element (uint32, wrapping)
//
// The terms arrive precomputed in f32 by the wrapper, in the reference's
// association; the sign multiplies last, so S_j·term_j is exact and the
// one rounding per step is the add.  __fadd_rn/__fmul_rn keep the compiler
// from contracting them (an FMA would give the same value here, but the
// intrinsics make the contract explicit).  The result is bitwise equal to
// the plain sequential-axpy version.
//
// What bounds it on an H100: device-memory bytes — one read and one write
// of W per update whatever J is, against J·(hash + add) integer and f32
// operations per element, far under the card's compute rates for the J of
// the MGD window (1 at τ_θ = 1, τ_θ in replay).  The design is one thread
// per element in a grid-stride loop, W kept in a register across the J
// loop, seeds and terms read through the read-only cache.
//
// 2. Sum-then-subtract update.  Replaces the Pallas TPU kernel
//    src/repro/kernels/mgd_update.py::mgd_update (_kernel):
//
//   acc = Σ_j coef_j·S_j  (f32, j = 0..J−1 in order),   W ← W − scale·acc,
//   scale = f32(η/Δθ)
//
// the reference's association: the sum first in an f32 accumulator, then
// one multiply and one subtract (__fmul_rn/__fsub_rn, so no FMA contracts
// them).  Same bound and design as the window update: bytes, one read and
// one write of W, a grid-stride loop over 64-bit element indices with the
// uint32 sign index (uint32)i = r·N + c mod 2³², the accumulator in a
// register across the J loop.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS)
mgd_update_window_kernel(const T* __restrict__ w, T* __restrict__ out,
                         const int* __restrict__ lseeds,
                         const float* __restrict__ terms, int J, long long numel) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < numel;
       i += stride) {
    float v = mgd::load_f32(w, i);
    const uint32_t g = (uint32_t)i * mgd::kGolden;
    for (int j = 0; j < J; ++j) {
      const uint32_t h = mgd::fmix32(g + (uint32_t)__ldg(lseeds + j));
      const float sg = (h >> 31) ? -1.0f : 1.0f;
      v = __fadd_rn(v, __fmul_rn(sg, __ldg(terms + j)));
    }
    mgd::store_f32(out, i, v);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
mgd_update_kernel(const T* __restrict__ w, T* __restrict__ out,
                  const int* __restrict__ lseeds, const float* __restrict__ coefs,
                  int J, float scale, long long numel) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < numel;
       i += stride) {
    const uint32_t g = (uint32_t)i * mgd::kGolden;
    float acc = 0.0f;
    for (int j = 0; j < J; ++j) {
      const uint32_t h = mgd::fmix32(g + (uint32_t)__ldg(lseeds + j));
      const float sg = (h >> 31) ? -1.0f : 1.0f;
      acc = __fadd_rn(acc, __fmul_rn(__ldg(coefs + j), sg));
    }
    mgd::store_f32(out, i, __fsub_rn(mgd::load_f32(w, i), __fmul_rn(scale, acc)));
  }
}

long long grid_blocks(long long numel) {
  const long long blocks = (numel + THREADS - 1) / THREADS;
  return blocks > 132LL * 16 ? 132LL * 16 : blocks;  // grid-stride beyond 16 per SM
}

template <typename T>
cudaError_t launch_sum(const void* w, void* out, const void* lseeds,
                       const void* coefs, int J, float scale, long long numel,
                       cudaStream_t stream) {
  mgd_update_kernel<T><<<(unsigned)grid_blocks(numel), THREADS, 0, stream>>>(
      static_cast<const T*>(w), static_cast<T*>(out),
      static_cast<const int*>(lseeds), static_cast<const float*>(coefs), J, scale,
      numel);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_typed(const void* w, void* out, const void* lseeds,
                         const void* terms, int J, long long numel,
                         cudaStream_t stream) {
  mgd_update_window_kernel<T><<<(unsigned)grid_blocks(numel), THREADS, 0, stream>>>(
      static_cast<const T*>(w), static_cast<T*>(out),
      static_cast<const int*>(lseeds), static_cast<const float*>(terms), J, numel);
  return cudaGetLastError();
}

}  // namespace

// C interface (bound with ctypes).  w/out: `numel` contiguous elements of
// dtype w_dtype (0 f32, 1 bf16) on the current device; lseeds: [J] int32
// holding the uint32 seed bit patterns; terms: [J] f32.  Launches on
// `stream`, allocates nothing, returns cudaGetLastError().
extern "C" int mgd_update_window_launch(const void* w, void* out, const void* lseeds,
                                        const void* terms, int J, long long numel,
                                        int w_dtype, void* stream) {
  if (numel <= 0 || J < 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (w_dtype == mgd::kF32)
    return (int)launch_typed<float>(w, out, lseeds, terms, J, numel, st);
  if (w_dtype == mgd::kBF16)
    return (int)launch_typed<__nv_bfloat16>(w, out, lseeds, terms, J, numel, st);
  return (int)cudaErrorInvalidValue;
}

// C interface of the sum-then-subtract update: as above, with coefs [J] f32
// (the C̃ of each window step) and scale = f32(η/Δθ).
extern "C" int mgd_update_launch(const void* w, void* out, const void* lseeds,
                                 const void* coefs, int J, float scale,
                                 long long numel, int w_dtype, void* stream) {
  if (numel <= 0 || J < 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (w_dtype == mgd::kF32)
    return (int)launch_sum<float>(w, out, lseeds, coefs, J, scale, numel, st);
  if (w_dtype == mgd::kBF16)
    return (int)launch_sum<__nv_bfloat16>(w, out, lseeds, coefs, J, scale, numel, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* mgd_update_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
