// Perturbed matmul for MGD probes on Hopper (sm_90a), SIMT f32.
//
// Replaces the Pallas TPU kernels of the JAX package:
//   src/repro/kernels/perturbed_matmul.py::perturbed_matmul      (_kernel)
//   src/repro/kernels/perturbed_matmul.py::perturbed_matmul_pair (_pair_kernel)
//
//   single:  y  = x  @ (W + amp·S)
//   pair:    yp = xp @ (W + Δθ·S),  ym = xm @ (W − Δθ·S)   (one read of W)
//   S[r,c] = 1 − 2·(fmix32((r·n_cols + c)·0x9E3779B9 + lseed) >> 31),  uint32
//
// n_cols ≥ N is the row stride of the sign index (the reference's
// `n_cols`): N for a whole leaf, the leaf's N for a column block of it (its
// offset folds into lseed, perturbations.shifted_leaf_seed).
//
// The perturbation θ̃ = amp·S never exists in device memory: each W tile
// is perturbed while it is staged into shared memory, from the element's
// global (r, c) and the leaf seed, so a probe reads W exactly as inference
// does and the pair reads it once for both streams.
//
// What bounds it on an H100: at the MGD MLP's shapes (x [B,49]·W [49,4],
// B ≤ 8) the work is a few hundred FLOPs and the launch itself is the
// cost; at LM widths (x [256,5120]·W [5120,17408]) it is the f32 SIMT
// rate (67 TFLOP/s), since f32 accumulation must stay IEEE (TF32 would
// break the 1e-4 parity with the plain version) and so cannot use the
// tensor cores.  The design is the plain, correct form of a SIMT GEMM:
// 64×64 output tiles, a K loop of 16-deep tiles through shared memory,
// 4×4 outputs per thread accumulated with FFMA, the ragged edge masked to
// 0 in the loads.  Register blocking deeper than 4×4, double buffering and
// vectorised loads are left for later work.
#include "common.cuh"

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256

struct PMArgs {
  const void* x0;
  const void* x1;
  const void* w;
  void* y0;
  void* y1;
  int M, K, N, n_cols;
  uint32_t lseed;
  float amp0, amp1;
};

// NS streams (1: single probe, 2: antithetic pair) share each W tile.
template <int NS, typename TX, typename TW, typename TY>
__global__ void __launch_bounds__(THREADS)
perturbed_matmul_kernel(const TX* __restrict__ x0, const TX* __restrict__ x1,
                        const TW* __restrict__ w, TY* __restrict__ y0,
                        TY* __restrict__ y1, int M, int K, int N, int n_cols,
                        uint32_t lseed, float amp0, float amp1) {
  // x tiles are stored transposed, padded by one column against bank
  // conflicts on the transposing store
  __shared__ float As[NS][BK][BM + 1];
  __shared__ float Bs[NS][BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  float acc[NS][TM][TN];
#pragma unroll
  for (int s = 0; s < NS; ++s)
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[s][i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int r = e / BK;
      const int c = e % BK;
      const int gm = m0 + r;
      const int gk = k0 + c;
      const bool ok = gm < M && gk < K;
      const long long off = (long long)gm * K + gk;
      As[0][c][r] = ok ? mgd::load_f32(x0, off) : 0.0f;
      if constexpr (NS == 2) As[1][c][r] = ok ? mgd::load_f32(x1, off) : 0.0f;
    }
#pragma unroll
    for (int e = tid; e < BK * BN; e += THREADS) {
      const int r = e / BN;
      const int c = e % BN;
      const int gk = k0 + r;
      const int gn = n0 + c;
      float wp0 = 0.0f;
      float wp1 = 0.0f;
      if (gk < K && gn < N) {
        const float wv = mgd::load_f32(w, (long long)gk * N + gn);
        // sign index over the row stride n_cols, in uint32 arithmetic
        const float sg =
            mgd::rademacher_sign((uint32_t)gk * (uint32_t)n_cols + (uint32_t)gn, lseed);
        // amp·sg is exact (sg = ±1): one rounding, as in the plain version
        wp0 = __fadd_rn(wv, __fmul_rn(amp0, sg));
        if constexpr (NS == 2) wp1 = __fadd_rn(wv, __fmul_rn(amp1, sg));
      }
      Bs[0][r][c] = wp0;
      if constexpr (NS == 2) Bs[1][r][c] = wp1;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        float a[TM];
        float b[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = As[s][kk][ty * TM + i];
#pragma unroll
        for (int j = 0; j < TN; ++j) b[j] = Bs[s][kk][tx * TN + j];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[s][i][j] = fmaf(a[i], b[j], acc[s][i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int s = 0; s < NS; ++s) {
    TY* y = (s == 0) ? y0 : y1;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int gm = m0 + ty * TM + i;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int gn = n0 + tx * TN + j;
        if (gm < M && gn < N) mgd::store_f32(y, (long long)gm * N + gn, acc[s][i][j]);
      }
    }
  }
}

template <int NS, typename TX, typename TW, typename TY>
cudaError_t launch_typed(const PMArgs& a, cudaStream_t stream) {
  const dim3 grid((a.N + BN - 1) / BN, (a.M + BM - 1) / BM);
  perturbed_matmul_kernel<NS, TX, TW, TY><<<grid, THREADS, 0, stream>>>(
      static_cast<const TX*>(a.x0), static_cast<const TX*>(a.x1),
      static_cast<const TW*>(a.w), static_cast<TY*>(a.y0),
      static_cast<TY*>(a.y1), a.M, a.K, a.N, a.n_cols, a.lseed, a.amp0, a.amp1);
  return cudaGetLastError();
}

template <int NS, typename TX, typename TW>
cudaError_t launch_y(int y_dtype, const PMArgs& a, cudaStream_t stream) {
  if (y_dtype == mgd::kF32) return launch_typed<NS, TX, TW, float>(a, stream);
  if (y_dtype == mgd::kBF16) return launch_typed<NS, TX, TW, __nv_bfloat16>(a, stream);
  return cudaErrorInvalidValue;
}

template <int NS, typename TX>
cudaError_t launch_w(int w_dtype, int y_dtype, const PMArgs& a, cudaStream_t stream) {
  if (w_dtype == mgd::kF32) return launch_y<NS, TX, float>(y_dtype, a, stream);
  if (w_dtype == mgd::kBF16) return launch_y<NS, TX, __nv_bfloat16>(y_dtype, a, stream);
  return cudaErrorInvalidValue;
}

template <int NS>
cudaError_t launch_x(int x_dtype, int w_dtype, int y_dtype, const PMArgs& a,
                     cudaStream_t stream) {
  if (x_dtype == mgd::kF32) return launch_w<NS, float>(w_dtype, y_dtype, a, stream);
  if (x_dtype == mgd::kBF16) return launch_w<NS, __nv_bfloat16>(w_dtype, y_dtype, a, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// C interface (bound with ctypes).  n_streams is 1 (single) or 2 (pair);
// x1/y1 are unused for a single stream.  x: [M,K], W: [K,N], y: [M,N], all
// contiguous row-major on the current device; n_cols ≥ N is the signs' row
// stride.  Launches on `stream`,
// allocates nothing, and returns cudaGetLastError().
extern "C" int pm_launch(int n_streams, const void* x0, const void* x1, const void* w,
                         void* y0, void* y1, int M, int K, int N, int n_cols, int x_dtype,
                         int w_dtype, int y_dtype, unsigned int lseed, float amp0,
                         float amp1, void* stream) {
  if (M <= 0 || N <= 0 || K < 0 || n_cols < N) return (int)cudaErrorInvalidValue;
  if ((M + BM - 1) / BM > 65535) return (int)cudaErrorInvalidConfiguration;
  const PMArgs a{x0, x1, w, y0, y1, M, K, N, n_cols, (uint32_t)lseed, amp0, amp1};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_streams == 1) return (int)launch_x<1>(x_dtype, w_dtype, y_dtype, a, st);
  if (n_streams == 2) return (int)launch_x<2>(x_dtype, w_dtype, y_dtype, a, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* pm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
