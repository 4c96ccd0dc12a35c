// MGD parameter updates on Hopper (sm_90a): two kernels over one body.
//
// 1. Exact-order window update, mgd_update_window_kernel.  Replaces the
//    Pallas TPU kernel src/repro/kernels/mgd_update.py::mgd_update_window
//    (_window_kernel, pallas_call at :159):
//
//      for j = 0..J−1 in order:  W ← W + S_j·term_j,  term_j = α·(Δθ·coef_j)
//      S_j[i] = 1 − 2·(fmix32(i·0x9E3779B9 + lseed_j) >> 31), i the row-major
//      linear index of the element in its leaf (uint32, wrapping); for a
//      block of a wider leaf (a column shard), viewed as [rows, cols] with
//      the leaf's row stride n_cols > cols (the reference's `n_cols`), i is
//      (r·n_cols + c) for the block's element (r, c)
//
//    The kernel forms term_j itself, from coef_j on the device and f32 α and
//    Δθ by value, in the reference's association (__fmul_rn twice).  The
//    sign flips term_j's sign bit, which is exact, so the one rounding per
//    step is the __fadd_rn.  Bitwise equal to the plain sequential-axpy
//    version, kernels/ref.py::mgd_update_window_ref.
//
// 2. Sum-then-subtract update, mgd_update_kernel.  Replaces the Pallas TPU
//    kernel src/repro/kernels/mgd_update.py::mgd_update (_kernel,
//    pallas_call at :75):
//
//      acc = Σ_j S_j·coef_j (f32, j in order),  W ← W − scale·acc,
//      scale = f32(η/Δθ)
//
//    the sum first, then one __fmul_rn and one __fsub_rn (no FMA contracts
//    them), as kernels/ref.py::mgd_update_ref does.
//
// What bounds them on an H100: at J = 1 the device-memory bytes, one read
// and one write of W.  As J grows, the integer issue rate: a sign costs
// about eight integer instructions an element a step (cuobjdump -sass of
// the J loop), about five of them on the INT32 lanes (the IMADs issue to
// the FMA pipe), against the card's 64 INT32 lanes an SM (~16.7e12/s over
// 132 SMs), so the hashing outlasts the bytes from J = 4 on for bf16 and
// from J = 8 on for f32.
//
// Design:
// * 16-byte vectors (4 f32 or 8 bf16 elements), UNROLL of them a thread,
//   read and written with the evict-first streaming hints (ld/st.global.cs:
//   every byte is touched once).  A tile's loads are all issued before its
//   arithmetic, so a CTA keeps THREADS·UNROLL·16 = 8 KB of loads in flight,
//   and at 31-40 registers a thread an SM holds 6-8 CTAs, 48-64 KB;
// * a persistent grid (SM count × resident CTAs an SM, from the occupancy
//   calculator) walks one flat list of tiles over every leaf of the launch.
//   The leaves come in a table in the kernel's parameter space (up to
//   MAX_LEAVES, by value: no copy, no sync), and a CTA finds the leaf of its
//   next tile by scanning the table's prefix tile offsets forward;
// * vectors are aligned to the input.  A head of fewer than one vector
//   before the input's first 16-byte boundary, and a tail after its last
//   whole vector, take scalar accesses in the leaf's first tile; an output
//   not aligned like its input takes scalar stores;
// * the sign is bit 31 after fmix32's second multiply (mgd::sign_bit),
//   XORed into the f32 addend.  A vector's hash inputs are one per-vector
//   base plus constants: the index advances by 0x9E3779B9 an element, and
//   the seed is added once a step;
// * element offsets are 64-bit, and the uint32 sign index wraps at 2³²;
// * a block of a wider leaf runs in kernels of its own (the *_strided_
//   ones, their table holding each block's cols and n_cols), so the
//   whole-leaf kernels' code is as it was.  There a vector's base index
//   costs one 64-bit division, outside the J loop, when cols is a
//   multiple of the vector width and the data starts on a 16-byte
//   boundary (no vector then crosses a row); otherwise the block's
//   elements all take the scalar path.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 2;                    // vectors a thread per tile
constexpr int TILE_VECS = THREADS * UNROLL;
constexpr int VEC_BYTES = 16;
constexpr int MAX_LEAVES = 64;
constexpr int MAX_STRIDED = 48;              // blocks a strided launch: the
                                             // table stays within 4 KB
constexpr int MAX_DEVICES = 64;

struct Leaf {
  const void* in;
  void* out;
  long long numel;
  long long tile0;   // the leaf's first tile in the launch's tile list
  long long nvec;    // whole vectors from element `head` on
  int head;          // scalar elements before the input's 16-byte boundary
  int tail;          // scalar elements after the last whole vector
  int seeds;         // offset of the leaf's J seeds in lseeds
  int vec_store;     // the output is 16-byte aligned where the input is
};

struct Table {
  Leaf leaf[MAX_LEAVES];
  long long tiles;
  int count;
};

// a block of a wider leaf: the signs' row stride differs from its rows'
struct StridedLeaf {
  Leaf f;
  int cols;     // the block's row length
  int n_cols;   // the signs' row stride, > cols
  int scalar;   // its rows split 16-byte vectors: every element is scalar
                // (head = tail = 0, nvec counts groups of N elements)
};

struct StridedTable {
  StridedLeaf leaf[MAX_STRIDED];
  long long tiles;
  int count;
};

__device__ __forceinline__ const Leaf& base(const Leaf& l) { return l; }
__device__ __forceinline__ const Leaf& base(const StridedLeaf& l) {
  return l.f;
}

// the sign index of element i: i itself, or for a block of a wider leaf
// (i / cols)·n_cols + i % cols, wrapped to uint32
__device__ __forceinline__ uint32_t sign_index(const Leaf&, long long i) {
  return (uint32_t)i;
}
__device__ __forceinline__ uint32_t sign_index(const StridedLeaf& l,
                                               long long i) {
  return (uint32_t)((unsigned long long)(i / l.cols) *
                        (unsigned long long)l.n_cols +
                    (unsigned long long)(i % l.cols));
}

__device__ __forceinline__ bool all_scalar(const Leaf&) { return false; }
__device__ __forceinline__ bool all_scalar(const StridedLeaf& l) {
  return l.scalar;
}

template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void unpack(const uint4& r, float* v) {
    v[0] = __uint_as_float(r.x);
    v[1] = __uint_as_float(r.y);
    v[2] = __uint_as_float(r.z);
    v[3] = __uint_as_float(r.w);
  }
  __device__ __forceinline__ static uint4 pack(const float* v) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                      __float_as_uint(v[2]), __float_as_uint(v[3]));
  }
};

// element 2k is the low half of word k; bf16 → f32 is exact, and f32 → bf16
// rounds to nearest even (cvt.rn.bf16x2.f32), as __float2bfloat16 does
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void unpack(const uint4& r, float* v) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[2 * k] = __uint_as_float(w[k] << 16);
      v[2 * k + 1] = __uint_as_float(w[k] & 0xFFFF0000u);
    }
  }
  __device__ __forceinline__ static uint4 pack(const float* v) {
    uint32_t w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
      w[k] = *reinterpret_cast<const uint32_t*>(&h);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

// the f32 addend of step j: the window's α·(Δθ·coef_j), the sum's coef_j
template <bool kSum>
__device__ __forceinline__ float addend(const float* __restrict__ coefs, int j,
                                        float a, float b) {
  const float c = __ldg(coefs + j);
  return kSum ? c : __fmul_rn(a, __fmul_rn(b, c));
}

// the updated value from W and the J steps' result v (the sum's scale is a)
template <bool kSum>
__device__ __forceinline__ float finish(float w, float v, float a) {
  return kSum ? __fsub_rn(w, __fmul_rn(a, v)) : v;
}

// one element i of leaf l, scalar: the head and the tail
template <typename T, bool kSum, typename L>
__device__ __forceinline__ void update_element(
    const L& l, long long i, const int* __restrict__ lseeds,
    const float* __restrict__ coefs, int J, float a, float b) {
  const Leaf& f = base(l);
  const float w = mgd::load_f32(static_cast<const T*>(f.in), i);
  const uint32_t g = sign_index(l, i) * mgd::kGolden;
  float v = kSum ? 0.0f : w;
  for (int j = 0; j < J; ++j) {
    const uint32_t seed = (uint32_t)__ldg(lseeds + f.seeds + j);
    v = __fadd_rn(v, mgd::apply_sign(addend<kSum>(coefs, j, a, b),
                                      mgd::sign_bit(g + seed)));
  }
  mgd::store_f32(static_cast<T*>(f.out), i, finish<kSum>(w, v, a));
}

template <typename T, bool kSum, typename Tab>
__device__ __forceinline__ void update_tiles(
    const Tab& tab, const int* __restrict__ lseeds,
    const float* __restrict__ coefs, int J, float a, float b) {
  using V = Vec<T>;
  constexpr int N = V::N;
  int l = 0;
  for (long long t = blockIdx.x; t < tab.tiles; t += gridDim.x) {
    while (l + 1 < tab.count && base(tab.leaf[l + 1]).tile0 <= t) ++l;
    const auto& leaf = tab.leaf[l];
    const Leaf& f = base(leaf);
    const T* in = static_cast<const T*>(f.in) + f.head;
    T* out = static_cast<T*>(f.out) + f.head;
    const long long k0 = (t - f.tile0) * TILE_VECS + threadIdx.x;
    if (all_scalar(leaf)) {
#pragma unroll 1
      for (int u = 0; u < UNROLL; ++u) {
        const long long k = k0 + (long long)u * THREADS;
        for (int e = 0; e < N && k < f.nvec; ++e)
          if (k * N + e < f.numel)
            update_element<T, kSum>(leaf, k * N + e, lseeds, coefs, J, a, b);
      }
      continue;
    }
    uint4 raw[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long k = k0 + (long long)u * THREADS;
      raw[u] = k < f.nvec ? __ldcs(reinterpret_cast<const uint4*>(in + k * N))
                          : make_uint4(0u, 0u, 0u, 0u);
    }
    float v[UNROLL][N];
    uint32_t g[UNROLL];   // (uint32)(index of the vector's first element)·G
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (kSum) {
#pragma unroll
        for (int e = 0; e < N; ++e) v[u][e] = 0.0f;
      } else {
        V::unpack(raw[u], v[u]);
      }
      g[u] = sign_index(leaf, f.head + (k0 + (long long)u * THREADS) * N) *
             mgd::kGolden;
    }
#pragma unroll 1
    for (int j = 0; j < J; ++j) {
      const uint32_t seed = (uint32_t)__ldg(lseeds + f.seeds + j);
      const float c = addend<kSum>(coefs, j, a, b);
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const uint32_t base = g[u] + seed;
#pragma unroll
        for (int e = 0; e < N; ++e)
          v[u][e] = __fadd_rn(v[u][e], mgd::apply_sign(c, mgd::sign_bit(
                                           base + (uint32_t)e * mgd::kGolden)));
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long k = k0 + (long long)u * THREADS;
      if (k >= f.nvec) continue;
      if (kSum) {
        float w[N];
        V::unpack(raw[u], w);
#pragma unroll
        for (int e = 0; e < N; ++e) v[u][e] = finish<true>(w[e], v[u][e], a);
      }
      if (f.vec_store) {
        __stcs(reinterpret_cast<uint4*>(out + k * N), V::pack(v[u]));
      } else {
#pragma unroll
        for (int e = 0; e < N; ++e) mgd::store_f32(out, k * N + e, v[u][e]);
      }
    }
    if (t == f.tile0) {   // the leaf's scalar head and tail
      const int i = threadIdx.x;
      if (i < f.head)
        update_element<T, kSum>(leaf, i, lseeds, coefs, J, a, b);
      else if (i >= THREADS - f.tail)
        update_element<T, kSum>(leaf, f.numel - (THREADS - i), lseeds, coefs,
                                J, a, b);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
mgd_update_window_kernel(const __grid_constant__ Table tab,
                         const int* __restrict__ lseeds,
                         const float* __restrict__ coefs, int J, float alpha,
                         float dtheta) {
  update_tiles<T, false>(tab, lseeds, coefs, J, alpha, dtheta);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
mgd_update_kernel(const __grid_constant__ Table tab,
                  const int* __restrict__ lseeds,
                  const float* __restrict__ coefs, int J, float scale) {
  update_tiles<T, true>(tab, lseeds, coefs, J, scale, 0.0f);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
mgd_update_window_strided_kernel(const __grid_constant__ StridedTable tab,
                                 const int* __restrict__ lseeds,
                                 const float* __restrict__ coefs, int J,
                                 float alpha, float dtheta) {
  update_tiles<T, false>(tab, lseeds, coefs, J, alpha, dtheta);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
mgd_update_strided_kernel(const __grid_constant__ StridedTable tab,
                          const int* __restrict__ lseeds,
                          const float* __restrict__ coefs, int J,
                          float scale) {
  update_tiles<T, true>(tab, lseeds, coefs, J, scale, 0.0f);
}

// CTAs of the kernel resident on all SMs of the current device, cached
template <typename T, bool kSum, bool kStrided>
cudaError_t persistent_grid(int* grid) {
  static int cached[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!cached[dev]) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    if (kStrided && kSum)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, mgd_update_strided_kernel<T>, THREADS, 0);
    else if (kStrided)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, mgd_update_window_strided_kernel<T>, THREADS, 0);
    else if (kSum)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, mgd_update_kernel<T>, THREADS, 0);
    else
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, mgd_update_window_kernel<T>, THREADS, 0);
    if (err != cudaSuccess) return err;
    cached[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  *grid = cached[dev];
  return cudaSuccess;
}

// the table entry of leaf l and its tiles; false for operands the kernels
// do not take.  A strided leaf whose rows split 16-byte vectors is scalar.
template <typename T>
bool fill(Leaf& f, int* scalar, int l, const void* const* ins,
          void* const* outs, const long long* numels, const long long* cols,
          const long long* n_cols, const int* rows, int J, long long* tiles) {
  constexpr int N = Vec<T>::N;
  const uintptr_t in = reinterpret_cast<uintptr_t>(ins[l]);
  const uintptr_t out = reinterpret_cast<uintptr_t>(outs[l]);
  if (numels[l] <= 0 || rows[l] < 0 || in % sizeof(T) || out % sizeof(T) ||
      cols[l] <= 0 || numels[l] % cols[l] || n_cols[l] < cols[l] ||
      n_cols[l] > 0x7FFFFFFFLL)
    return false;
  f.in = ins[l];
  f.out = outs[l];
  f.numel = numels[l];
  const long long head = (long long)((VEC_BYTES - in % VEC_BYTES) %
                                     VEC_BYTES / sizeof(T));
  f.head = (int)(head < f.numel ? head : f.numel);
  f.nvec = (f.numel - f.head) / N;
  f.tail = (int)(f.numel - f.head - f.nvec * N);
  f.seeds = rows[l] * J;
  f.vec_store = (out - in) % VEC_BYTES == 0;
  if (scalar) {
    *scalar = f.head != 0 || cols[l] % N != 0;
    if (*scalar) {
      f.head = f.tail = 0;
      f.nvec = (f.numel + N - 1) / N;
    }
  }
  f.tile0 = *tiles;
  *tiles += f.nvec > 0 ? (f.nvec + TILE_VECS - 1) / TILE_VECS : 1;
  return true;
}

// one launch over the leaves, all whole (n_cols == cols) or all blocks of
// wider leaves (n_cols > cols: the strided kernels)
template <typename T, bool kSum>
cudaError_t launch(int count, const void* const* ins, void* const* outs,
                   const long long* numels, const long long* cols,
                   const long long* n_cols, const int* rows,
                   const int* lseeds, const float* coefs, int J, float a,
                   float b, cudaStream_t stream) {
  const bool strided = n_cols[0] != cols[0];
  for (int l = 0; l < count; ++l)
    if ((n_cols[l] != cols[l]) != strided) return cudaErrorInvalidValue;
  long long tiles = 0;
  int grid = 0;
  if (!strided) {
    Table tab = {};
    for (int l = 0; l < count; ++l)
      if (!fill<T>(tab.leaf[l], nullptr, l, ins, outs, numels, cols, n_cols,
                   rows, J, &tiles))
        return cudaErrorInvalidValue;
    tab.tiles = tiles;
    tab.count = count;
    const cudaError_t err = persistent_grid<T, kSum, false>(&grid);
    if (err != cudaSuccess) return err;
    if (grid > tiles) grid = (int)tiles;
    if (kSum)
      mgd_update_kernel<T><<<grid, THREADS, 0, stream>>>(tab, lseeds, coefs,
                                                        J, a);
    else
      mgd_update_window_kernel<T><<<grid, THREADS, 0, stream>>>(
          tab, lseeds, coefs, J, a, b);
    return cudaGetLastError();
  }
  if (count > MAX_STRIDED) return cudaErrorInvalidValue;
  StridedTable tab = {};
  for (int l = 0; l < count; ++l) {
    StridedLeaf& s = tab.leaf[l];
    if (!fill<T>(s.f, &s.scalar, l, ins, outs, numels, cols, n_cols, rows, J,
                 &tiles))
      return cudaErrorInvalidValue;
    s.cols = (int)cols[l];
    s.n_cols = (int)n_cols[l];
  }
  tab.tiles = tiles;
  tab.count = count;
  const cudaError_t err = persistent_grid<T, kSum, true>(&grid);
  if (err != cudaSuccess) return err;
  if (grid > tiles) grid = (int)tiles;
  if (kSum)
    mgd_update_strided_kernel<T><<<grid, THREADS, 0, stream>>>(
        tab, lseeds, coefs, J, a);
  else
    mgd_update_window_strided_kernel<T><<<grid, THREADS, 0, stream>>>(
        tab, lseeds, coefs, J, a, b);
  return cudaGetLastError();
}

}  // namespace

// C interface (bound with ctypes).  One launch updates `count` leaves of
// dtype w_dtype (0 f32, 1 bf16), out of place: leaf l has numels[l]
// contiguous elements at ins[l], written to outs[l], viewed as rows of
// cols[l] elements whose signs' row stride is n_cols[l] ≥ cols[l], and its
// J seeds in row rows[l] of lseeds ([rows, J] int32 holding the uint32
// bit patterns); coefs is [J] f32.  Either every leaf is whole (n_cols ==
// cols; 1 to MAX_LEAVES of them) or every leaf is a block of a wider one
// (n_cols > cols; 1 to MAX_STRIDED).  kind 0 is the window update (a =
// f32 α, b = f32 Δθ), kind 1 the sum-then-subtract update (a = f32 η/Δθ).
// All pointers but the host arrays are on the current device.  Launches on
// `stream`, allocates nothing, returns cudaGetLastError().
extern "C" int mgd_update_group_launch(int kind, int count,
                                       const void* const* ins,
                                       void* const* outs,
                                       const long long* numels,
                                       const long long* cols,
                                       const long long* n_cols,
                                       const int* rows, const void* lseeds,
                                       const void* coefs, int J, float a,
                                       float b, int w_dtype, void* stream) {
  if (count < 1 || count > MAX_LEAVES || J < 0 || (kind != 0 && kind != 1))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* s = static_cast<const int*>(lseeds);
  const float* c = static_cast<const float*>(coefs);
  if (w_dtype == mgd::kF32)
    return (int)(kind ? launch<float, true>(count, ins, outs, numels, cols,
                                            n_cols, rows, s, c, J, a, b, st)
                      : launch<float, false>(count, ins, outs, numels, cols,
                                             n_cols, rows, s, c, J, a, b,
                                             st));
  if (w_dtype == mgd::kBF16)
    return (int)(kind ? launch<__nv_bfloat16, true>(count, ins, outs, numels,
                                                    cols, n_cols, rows, s, c,
                                                    J, a, b, st)
                      : launch<__nv_bfloat16, false>(count, ins, outs,
                                                     numels, cols, n_cols,
                                                     rows, s, c, J, a, b,
                                                     st));
  return (int)cudaErrorInvalidValue;
}

// elements a thread updates per step of the J loop (UNROLL vectors)
extern "C" int mgd_update_vector_elems(int w_dtype) {
  return UNROLL * (w_dtype == mgd::kBF16 ? Vec<__nv_bfloat16>::N
                                         : Vec<float>::N);
}

extern "C" const char* mgd_update_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
