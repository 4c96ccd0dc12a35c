// Perturbed matmul for MGD probes on Hopper tensor cores (sm_90a), bf16.
//
// Replaces the Pallas TPU kernels of the JAX package, for bf16 x and W:
//   src/repro/kernels/perturbed_matmul.py::perturbed_matmul      (_kernel)
//   src/repro/kernels/perturbed_matmul.py::perturbed_matmul_pair (_pair_kernel)
// (f32, mixed and unaligned operands take the SIMT kernel in
// perturbed_matmul.cu; kernels/perturbed_matmul.py::route decides.)
//
//   single:  y  = x  @ (W + amp·S)
//   pair:    yp = xp @ (W + Δθ·S),  ym = xm @ (W − Δθ·S)
//   S[r,c] = 1 − 2·(fmix32((r·n_cols + c)·0x9E3779B9 + lseed) >> 31),  uint32
//   (n_cols ≥ N the signs' row stride: N for a whole leaf, the leaf's N for
//   a column block of it; the tensor maps, tiling and clusters follow the
//   local [K, N] alone)
//
// Exact split form.  The TPU kernel forms x_f32 @ (W_f32 + amp·S) in f32.
// That equals x·W + amp·(x·S): with bf16 x and W and S = ±1 every product
// of both terms is exact in the tensor cores, which sum in f32, so
// y = acc_W + amp·acc_S (one f32 FMA, one rounding to the output type) is
// the reference's function up to the order of the f32 sums.  θ̃ is never
// rounded to bf16 and never exists in device memory.
//
// What bounds it on an H100: at the transformer's shapes (x [512,5120] ·
// W [5120,17408]) the bf16 tensor-core rate; the split form does twice the
// multiply-adds of x·W, so its bound is twice the plain product's.  The
// signs cost ~8 integer instructions each (the hash below), about as many
// issue slots per stage as the stage's wgmmas take tensor-core time, so a
// cluster of CM CTAs along M shares each sign tile (below).
//
// Design (one CTA: 128 rows × 128 columns of output):
// * warpgroups 0-1 are consumers: each owns 64 rows (the pair gives
//   warpgroup 0 the x₊ rows and warpgroup 1 the x₋ rows of one 64-row
//   block, so one W tile and one S tile serve both streams) and keeps two
//   f32 accumulator sets, acc_W and acc_S, from wgmma m64n128k16 with B =
//   the W tile and B = the sign tile, both read MN-major from shared memory;
// * warpgroup 2 produces: its first thread issues the TMA loads of the x
//   and W tiles (64-deep K steps, 128-byte swizzle, zero fill past the
//   edges) into a ring of STAGES shared-memory stages, completed on
//   mbarriers; all its 128 threads hash the sign tile of the same stage
//   into shared memory, in the W tile's swizzled layout, while the
//   consumers' wgmmas run on earlier stages;
// * the CM CTAs of a cluster (consecutive row blocks, one column tile)
//   split each stage's sign tile and W tile by K rows: each hashes 64/CM
//   rows of signs into its own shared memory and sends them to the others
//   with bulk shared-to-shared copies (DSMEM), and loads 64/CM rows of each
//   W box with one TMA multicast to all of them.  So each sign is hashed
//   once per cluster and each W tile read from L2 once per cluster.  Every
//   transfer into a stage, the peers' signs included, completes on that
//   stage's full barrier as TMA bytes; its empty barrier counts every
//   consumer warp of the cluster, since any CTA may write into the stage;
// * the epilogue stores y masked; M is free, K and N must be multiples of 8
//   (TMA's 16-byte row stride).  A sign past K multiplies a zero x column.
#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the driver at run time

#include "common.cuh"

namespace {

constexpr int WG_ROWS = 64;      // rows of x per consumer warpgroup (wgmma m64)
constexpr int BN = 128;          // output columns per CTA (wgmma n128)
constexpr int BK = 64;           // K depth of a stage: one 128-byte bf16 row
constexpr int HALF_N = 64;       // columns of one W/S box (128 bytes)
constexpr int STAGES = 4;
constexpr int CONSUMER_WGS = 2;
constexpr int CONSUMER_WARPS = 4 * CONSUMER_WGS;
constexpr int HASH_THREADS = 128;
constexpr int THREADS = 128 * CONSUMER_WGS + HASH_THREADS;   // 384
constexpr int TILE_BYTES = 64 * 64 * 2;                      // one 64×64 bf16 box
// a stage: x of warpgroup 0, x of warpgroup 1, W (two N halves), S (two halves)
constexpr int STAGE_BYTES = 6 * TILE_BYTES;                  // 48 KB
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 1024 + 2 * STAGES * 8;
constexpr int HASH_BARRIER = 1;   // named barrier of the hashing warpgroup
// a wait that has not completed after this many polls traps (a launch
// error) instead of hanging the card
constexpr uint32_t kWaitPollLimit = 1u << 26;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t polls = 0;; ++polls) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == kWaitPollLimit) __trap();
  }
}

// this CTA's rank in its cluster, and the address of `addr` (a shared::cta
// address of this CTA) in the shared memory of the cluster's CTA `rank`
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t map_to_rank(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}
__device__ __forceinline__ void mbar_arrive_remote(uint32_t remote_bar) {
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];" ::"r"(remote_bar) : "memory");
}

// bulk copy of `bytes` from this CTA's shared memory to another CTA's
// (remote_dst, from map_to_rank), completing on its barrier remote_bar
__device__ __forceinline__ void copy_to_peer(uint32_t remote_dst, uint32_t src,
                                             uint32_t bytes, uint32_t remote_bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];" ::"r"(remote_dst),
      "r"(src), "r"(bytes), "r"(remote_bar)
      : "memory");
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;" ::: "memory");
}

// 2-D TMA load of one box at (c0 = column, c1 = row) into shared memory
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// the same, written to the same offset in every CTA of `mask`, each
// completing on its own barrier at `bar`'s offset
__device__ __forceinline__ void tma_load_2d_multicast(uint32_t dst, const CUtensorMap* map,
                                                      uint32_t bar, int c0, int c1,
                                                      uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%3, %4}], [%2], %5;" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "h"(mask)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle.  K-major (x): SBO is
// the 8-row group stride, LBO unused.  MN-major (W, S): LBO is the stride
// between 64-column boxes along N, SBO the 8-row group stride along K.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFFu) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFFu) << 32 |
         static_cast<uint64_t>(1) << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator accesses across the async wgmma
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64] += A (64×16, K-major) · B (16×128, MN-major), bf16 in, f32 accumulate
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// fmix32 up to its last step: that step (x ^= x >> 16) leaves bit 31, the
// sign bit of mgd::rademacher_sign, as it is
__device__ __forceinline__ uint32_t sign_word(uint32_t h) {
  h ^= h >> 16;
  h *= mgd::kM1;
  h ^= h >> 13;
  h *= mgd::kM2;
  return h;
}

// two bf16 ±1 from the sign bits of a (low element) and b (high element):
// 0x3F80 is +1, 0xBF80 is −1
__device__ __forceinline__ uint32_t pack_signs(uint32_t a, uint32_t b) {
  return (__byte_perm(a, b, 0x7030) & 0x80008000u) | 0x3F803F80u;
}

template <typename TY>
__device__ __forceinline__ void store2(TY* y, long long off, float v0, float v1);
template <>
__device__ __forceinline__ void store2<float>(float* y, long long off, float v0, float v1) {
  *reinterpret_cast<float2*>(y + off) = make_float2(v0, v1);
}
template <>
__device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* y, long long off,
                                                      float v0, float v1) {
  // round to nearest even, as torch's .to()
  *reinterpret_cast<__nv_bfloat162*>(y + off) = __floats2bfloat162_rn(v0, v1);
}

// NS streams: 1 (single probe) or 2 (antithetic pair).  Grid: x over
// row blocks (128 rows of x for one stream, or 64 rows of each of two),
// padded to a multiple of the cluster size CM; y over 128-column tiles of
// N.  map_w's box is 64 columns × 64/CM rows.
template <int NS, int CM, typename TY>
__global__ void __launch_bounds__(THREADS, 1)
perturbed_matmul_tc_kernel(const __grid_constant__ CUtensorMap map_x0,
                           const __grid_constant__ CUtensorMap map_x1,
                           const __grid_constant__ CUtensorMap map_w,
                           TY* __restrict__ y0, TY* __restrict__ y1, int M, int K,
                           int N, int n_cols, uint32_t lseed, float amp0, float amp1) {
  extern __shared__ uint8_t smem_raw[];
  // 128-byte swizzled boxes need 1024-byte alignment
  const uint32_t smem = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t full_bar = smem + STAGES * STAGE_BYTES;   // [STAGES] x 8 bytes
  const uint32_t empty_bar = full_bar + STAGES * 8;

  const int n0 = blockIdx.y * BN;
  const int row0 = NS == 2 ? blockIdx.x * WG_ROWS : blockIdx.x * 2 * WG_ROWS;
  const int row1 = NS == 2 ? row0 : row0 + WG_ROWS;   // warpgroup 1's rows
  const int kt_count = (K + BK - 1) / BK;
  const int wg = threadIdx.x / 128;
  constexpr int SHARE_ROWS = BK / CM;   // K rows of each stage this CTA signs and loads
  const uint32_t rank = CM == 1 ? 0u : cluster_rank();

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      // the producer's expect-tx, then its signal that the local signs
      // are stored; the bytes of TMA and of the peers' sign copies
      mbar_init(full_bar + 8 * s, 2);
      mbar_init(empty_bar + 8 * s, CONSUMER_WARPS * CM);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if constexpr (CM > 1) {
    cluster_sync();   // every barrier of the cluster is set up
  } else {
    __syncthreads();
  }

  if (wg < CONSUMER_WGS) {
    // ---- consumers: acc_W = x·W and acc_S = x·S on the tensor cores ----
    float accw[64];
    float accs[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      accw[i] = 0.0f;
      accs[i] = 0.0f;
    }
    const int lane = threadIdx.x & 31;
    for (int kt = 0; kt < kt_count; ++kt) {
      const int s = kt % STAGES;
      mbar_wait(full_bar + 8 * s, (kt / STAGES) & 1);
      const uint32_t st = smem + s * STAGE_BYTES;
      const uint32_t xa = st + wg * TILE_BYTES;
      const uint32_t wb = st + 2 * TILE_BYTES;
      const uint32_t sb = st + 4 * TILE_BYTES;
      fence_acc(accw);
      fence_acc(accs);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        // K-major x: a 16-deep slice is 32 bytes along the swizzled row;
        // MN-major W/S: 16 rows of 128 bytes
        const uint64_t da = sw128_desc(xa + kk * 32, 16, 1024);
        wgmma_m64n128k16(accw, da, sw128_desc(wb + kk * 2048, TILE_BYTES, 1024));
        wgmma_m64n128k16(accs, da, sw128_desc(sb + kk * 2048, TILE_BYTES, 1024));
      }
      wgmma_commit();
      fence_acc(accw);
      fence_acc(accs);
      // the previous stage's wgmmas are done: hand its buffers back
      wgmma_wait<1>();
      fence_acc(accw);
      fence_acc(accs);
      if (kt > 0 && lane == 0) {
        const uint32_t bar = empty_bar + 8 * ((kt - 1) % STAGES);
        if constexpr (CM > 1) {
#pragma unroll
          for (int d = 0; d < CM; ++d) mbar_arrive_remote(map_to_rank(bar, d));
        } else {
          mbar_arrive(bar);
        }
      }
    }
    wgmma_wait<0>();
    fence_acc(accw);
    fence_acc(accs);

    // ---- epilogue: y = acc_W + amp·acc_S, rounded once, stored masked ----
    // wgmma's accumulator layout: warp w of the warpgroup holds rows
    // 16w + lane/4 (+8); register 4j + {0,1} (+{2,3} for row +8) holds
    // columns 8j + 2·(lane%4) + {0,1}
    const int warp = (threadIdx.x & 127) >> 5;
    const int r = (wg == 0 ? row0 : row1) + 16 * warp + (lane >> 2);
    TY* const y = (NS == 2 && wg == 1) ? y1 : y0;
    const float amp = (NS == 2 && wg == 1) ? amp1 : amp0;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = n0 + 8 * j + 2 * (lane & 3);
      if (c < N) {   // N is even, so c + 1 < N too
        if (r < M)
          store2<TY>(y, (long long)r * N + c, fmaf(amp, accs[4 * j], accw[4 * j]),
                     fmaf(amp, accs[4 * j + 1], accw[4 * j + 1]));
        if (r + 8 < M)
          store2<TY>(y, (long long)(r + 8) * N + c,
                     fmaf(amp, accs[4 * j + 2], accw[4 * j + 2]),
                     fmaf(amp, accs[4 * j + 3], accw[4 * j + 3]));
      }
    }
  } else {
    // ---- producer: TMA loads (thread 0 of the warpgroup) and the signs ----
    const int ht = threadIdx.x - 128 * CONSUMER_WGS;
    // boxes wholly past M or N are not loaded: their rows/columns are
    // never stored (a cluster's padding CTAs load no x at all)
    const bool load_x0 = row0 < M;
    const bool load_x1 = row1 < M;
    const bool load_w1 = n0 + HALF_N < N;
    constexpr uint32_t SHARE_BYTES = SHARE_ROWS * 128;   // of one 64-column box
    const uint32_t tx_bytes =
        (load_x0 + load_x1 + 1 + load_w1) * TILE_BYTES + (CM - 1) * 2 * SHARE_BYTES;
    const uint16_t all_ctas = (uint16_t)((1u << CM) - 1u);
    for (int kt = 0; kt < kt_count; ++kt) {
      const int s = kt % STAGES;
      if (kt >= STAGES) mbar_wait(empty_bar + 8 * s, ((kt / STAGES) - 1) & 1);
      const uint32_t st = smem + s * STAGE_BYTES;
      const uint32_t bar = full_bar + 8 * s;
      const int k0 = kt * BK;
      if (ht == 0) {
        mbar_arrive_expect_tx(bar, tx_bytes);
        if (load_x0) tma_load_2d(st, &map_x0, bar, k0, row0);
        if (load_x1) tma_load_2d(st + TILE_BYTES, &map_x1, bar, k0, row1);
        // this CTA's share of the W tile: rows rank·64/CM.. of each box.
        // A share wholly past K loads from row K−1 instead (TMA zero-fills
        // the rest): finite values that meet x's zero-filled columns.
        const int kr = min(k0 + (int)rank * SHARE_ROWS, K - 1);
        const uint32_t wdst = st + 2 * TILE_BYTES + rank * SHARE_ROWS * 128;
        if constexpr (CM > 1) {
          tma_load_2d_multicast(wdst, &map_w, bar, n0, kr, all_ctas);
          if (load_w1)
            tma_load_2d_multicast(wdst + TILE_BYTES, &map_w, bar, n0 + HALF_N, kr, all_ctas);
        } else {
          tma_load_2d(wdst, &map_w, bar, n0, kr);
          if (load_w1) tma_load_2d(wdst + TILE_BYTES, &map_w, bar, n0 + HALF_N, kr);
        }
      }
      // this CTA's share of the sign tile: 64/CM K-rows × 128 columns, as
      // 16-byte chunks of 8 bf16 signs, in the 128-byte swizzle TMA gives
      // the W tile
      const uint32_t sb = st + 4 * TILE_BYTES;
#pragma unroll 2
      for (int j = 0; j < SHARE_ROWS * 16 / HASH_THREADS; ++j) {
        const int item = ht + HASH_THREADS * j;
        const int r = rank * SHARE_ROWS + (item >> 4);   // K row in the stage
        const int q = item & 15;                         // chunk along the 128 columns
        const uint32_t idx = (uint32_t)(k0 + r) * (uint32_t)n_cols + (uint32_t)(n0 + 8 * q);
        const uint32_t h = idx * mgd::kGolden + lseed;
        uint32_t v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          v[e] = pack_signs(sign_word(h + (uint32_t)(2 * e) * mgd::kGolden),
                            sign_word(h + (uint32_t)(2 * e + 1) * mgd::kGolden));
        const uint32_t dst = sb + (q >> 3) * TILE_BYTES + r * 128 +
                             ((((uint32_t)q & 7u) ^ ((uint32_t)r & 7u)) << 4);
        asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};" ::"r"(dst), "r"(v[0]),
                     "r"(v[1]), "r"(v[2]), "r"(v[3])
                     : "memory");
      }
      // the signs are read by wgmma and by the bulk copies (the async proxy)
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      asm volatile("bar.sync %0, %1;" ::"n"(HASH_BARRIER), "n"(HASH_THREADS) : "memory");
      if (ht == 0) {
        if constexpr (CM > 1) {
          const uint32_t share = sb + rank * SHARE_BYTES;
#pragma unroll
          for (int d = 0; d < CM; ++d) {
            if (d == (int)rank) continue;
            const uint32_t peer_bar = map_to_rank(bar, d);
            copy_to_peer(map_to_rank(share, d), share, SHARE_BYTES, peer_bar);
            copy_to_peer(map_to_rank(share + TILE_BYTES, d), share + TILE_BYTES, SHARE_BYTES,
                         peer_bar);
          }
        }
        mbar_arrive(bar);
      }
    }
  }
  // no CTA leaves while another may still store into it or arrive on it
  if constexpr (CM > 1) cluster_sync();
}

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle, CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up in the driver through the runtime, so
// the library needs no -lcuda
EncodeTiledFn encoder() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p,
                                                           12000, cudaEnableDefault, &q);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// row-major bf16 [rows, cols], boxes of 64 columns × box_rows rows with the
// 128-byte swizzle, zero fill past the edges
bool encode(CUtensorMap* map, const void* ptr, int rows, int cols, int box_rows) {
  const EncodeTiledFn fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides,
            box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

struct Operands {
  const void* x0;
  const void* x1;
  const void* w;
  void* y0;
  void* y1;
  int M, K, N, n_cols;
  uint32_t lseed;
  float amp0, amp1;
};

template <int NS, int CM, typename TY>
cudaError_t launch_typed(const Operands& a, cudaStream_t stream) {
  CUtensorMap mx0, mx1, mw;
  if (!encode(&mx0, a.x0, a.M, a.K, 64) || !encode(&mw, a.w, a.K, a.N, BK / CM))
    return cudaErrorInvalidValue;
  if (NS == 2) {
    if (!encode(&mx1, a.x1, a.M, a.K, 64)) return cudaErrorInvalidValue;
  } else {
    mx1 = mx0;   // the single stream's second warpgroup reads x's next 64 rows
  }
  const auto kernel = perturbed_matmul_tc_kernel<NS, CM, TY>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       SMEM_BYTES);
  if (e != cudaSuccess) return e;
  const int rows_per_cta = NS == 2 ? WG_ROWS : 2 * WG_ROWS;
  const int blocks = (a.M + rows_per_cta - 1) / rows_per_cta;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((blocks + CM - 1) / CM * CM, (a.N + BN - 1) / BN);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = SMEM_BYTES;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CM;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, mx0, mx1, mw, static_cast<TY*>(a.y0),
                         static_cast<TY*>(a.y1), a.M, a.K, a.N, a.n_cols, a.lseed, a.amp0,
                         a.amp1);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <int NS, typename TY>
cudaError_t launch_clustered(int cm, const Operands& a, cudaStream_t stream) {
  if (cm == 4) return launch_typed<NS, 4, TY>(a, stream);
  if (cm == 2) return launch_typed<NS, 2, TY>(a, stream);
  if (cm == 1) return launch_typed<NS, 1, TY>(a, stream);
  return cudaErrorInvalidValue;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

// C interface (bound with ctypes).  n_streams is 1 (single) or 2 (pair);
// cluster is the cluster size along M: 1, 2 or 4 (the wrapper's
// tc_cluster picks it); x1/y1 are unused for a single stream.  x: [M,K]
// bf16, W: [K,N] bf16, y: [M,N] f32 (y_dtype 0) or bf16 (1), all
// contiguous row-major on the current device, x and W 16-byte aligned, K
// and N multiples of 8; n_cols ≥ N is the signs' row stride.  The tensor maps are encoded here, per call.
// Launches on `stream`, allocates nothing, and returns cudaGetLastError()
// (cudaErrorInvalidValue for operands it does not take,
// cudaErrorSymbolNotFound if the driver has no tensor-map encoder).
extern "C" int pmtc_launch(int n_streams, int cluster, const void* x0, const void* x1,
                           const void* w, void* y0, void* y1, int M, int K, int N,
                           int n_cols, int y_dtype, unsigned int lseed, float amp0, float amp1,
                           void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 8 != 0 || N % 8 != 0 || n_cols < N)
    return (int)cudaErrorInvalidValue;
  if (n_streams != 1 && n_streams != 2) return (int)cudaErrorInvalidValue;
  if (!aligned16(x0) || !aligned16(w) || (n_streams == 2 && !aligned16(x1)))
    return (int)cudaErrorInvalidValue;
  if ((N + BN - 1) / BN > 65535) return (int)cudaErrorInvalidConfiguration;
  if (encoder() == nullptr) return (int)cudaErrorSymbolNotFound;
  const Operands a{x0, x1, w, y0, y1, M, K, N, n_cols, (uint32_t)lseed, amp0, amp1};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_streams == 1 && y_dtype == mgd::kF32)
    return (int)launch_clustered<1, float>(cluster, a, st);
  if (n_streams == 1 && y_dtype == mgd::kBF16)
    return (int)launch_clustered<1, __nv_bfloat16>(cluster, a, st);
  if (n_streams == 2 && y_dtype == mgd::kF32)
    return (int)launch_clustered<2, float>(cluster, a, st);
  if (n_streams == 2 && y_dtype == mgd::kBF16)
    return (int)launch_clustered<2, __nv_bfloat16>(cluster, a, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* pmtc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
