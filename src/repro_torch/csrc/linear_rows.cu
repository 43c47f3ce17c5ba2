// Matrix product y = x · w whose row result does not depend on the row
// count, for Hopper (sm_90a).  x (M, K) and w (K, N), row-major; y (M, N)
// in x's dtype; fp32 accumulation.  bfloat16 runs on tensor cores
// (mma.sync m16n8k16), float32 on an FMA loop.
//
// Why it exists.  No TPU kernel is replaced: the JAX model leaves its
// projections to XLA.  The serving refill packs several prompts into one
// prefill, so a prompt's rows meet a row count M that depends on the
// other prompts of its refill.  A library GEMM picks its tiling and its
// split over K by M, so a row's rounding, and with it a greedy stream,
// moved with the batch (on an H100 cuBLAS's k/v projections and FFN down
// projection did).  Here row r of y depends only on row r of x and on w,
// bit for bit, for every M and wherever the row sits in x:
//   * tiles are fixed (128 x 128 x 64 bf16, 64 x 64 x 16 fp32), and each
//     element's sum runs over K in the same order in every tile;
//   * K is split in S parts, S a function of (N, K) alone
//     (kernels/linear_rows/ops.py k_splits), at chunk boundaries fixed by
//     (K, S); each part writes fp32 partials to a workspace, and a second
//     kernel adds them in the order s = 0, 1, ..., S - 1 and rounds once;
//   * no atomics: the result is the same from run to run.
//
// What bounds it on an H100.  At the prefill's row counts (M = rows of a
// refill, up to 8 x 512) the glm4-9b projections do 2·M·N·K flops on
// N·K weights: M flops per weight byte, above the card's ~295 at
// M >= 512, so the tensor cores bound them; at small M (a refill of
// one short prompt; the last-position lm_head at M = lanes) the weight
// read does (weight bytes / 3.35 TB/s).  The split over K keeps the card
// busy at small M: ffn_down (N 4096) has 32 column tiles, which alone
// would run 32 blocks on 132 SMs; it costs S·M·N·8 bytes of fp32
// partials at large M.  The design is simple: four warps of 64 x 64
// output each, mma.sync from shared memory filled by cp.async through a
// 3-stage ring.  Of the tile shapes timed on an H100 (128 or 256 rows,
// 128 or 256 columns, K chunks of 32 or 64, warp tiles of 64 x 32 or
// 64 x 64) this one was the fastest or within 2 % of it, at
// ~300 TFLOP/s, about 0.4x
// cuBLAS's wgmma kernels (H100 80GB HBM3 at 700 W; PERF.md,
// kernels/linear_rows/tiles.py).  wgmma with TMA (the card's full
// tensor-core rate) is left for a later design.
#include "prefill_rows.cuh"

namespace repro {

// The bf16 tile shape: a BM x BN block tile of (BM / WM) x (BN / WN)
// warps, each WM x WN, over BK-deep chunks of K through a STAGES-deep
// cp.async ring.
template <int BM, int BN, int BK, int WM, int WN, int STAGES>
struct LrTile {
  static constexpr int kWarpsN = BN / WN;
  static constexpr int kThreads = 32 * (BM / WM) * kWarpsN;
  static constexpr int kLdA = BK + 8;        // shared row strides, elements:
  static constexpr int kLdB = BN + 8;        // +16 bytes against bank conflicts
  static constexpr int kStageElems = BM * kLdA + BK * kLdB;
  static constexpr int kSmemBytes = STAGES * kStageElems * 2;
  static constexpr int kLoadsA = BM * BK / 8 / kThreads;
  static constexpr int kLoadsB = BK * BN / 8 / kThreads;
  static_assert(kLoadsA * kThreads * 8 == BM * BK, "A chunks per thread");
  static_assert(kLoadsB * kThreads * 8 == BK * BN, "B chunks per thread");
  static_assert(WM % 16 == 0 && WN % 16 == 0 && BK % 16 == 0, "mma tiles");
};

// The production shape (kernels/linear_rows/ops.py k_splits counts its
// BK-deep chunks).
constexpr int kLrBM = 128, kLrBN = 128, kLrBK = 64, kLrWM = 64, kLrWN = 64,
              kLrStages = 3;

constexpr int kLfBM = 64, kLfBN = 64, kLfBK = 16;

// k chunks [c0, c1) of split s of S over nch chunks: fixed by (K, S)
__device__ __forceinline__ void split_range(int s, int S, int nch, int& c0,
                                            int& c1) {
  c0 = (int)(((long long)s * nch) / S);
  c1 = (int)(((long long)(s + 1) * nch) / S);
}

template <int BM, int BN, int BK, int WM, int WN, int STAGES>
__global__ void __launch_bounds__(LrTile<BM, BN, BK, WM, WN, STAGES>::kThreads)
    linear_rows_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                            const __nv_bfloat16* __restrict__ w,
                            __nv_bfloat16* __restrict__ y,
                            float* __restrict__ ws, int M, int N, int K,
                            int S) {
  using bf16 = __nv_bfloat16;
  using Tl = LrTile<BM, BN, BK, WM, WN, STAGES>;
  constexpr int MI = WM / 16, NI = WN / 8;
  extern __shared__ __align__(16) unsigned char lr_smem[];
  bf16* sm = reinterpret_cast<bf16*>(lr_smem);
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int s = blockIdx.z;
  int c0, c1;
  split_range(s, S, (K + BK - 1) / BK, c0, c1);
  const int nk = c1 - c0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / Tl::kWarpsN, wn = warp % Tl::kWarpsN;
  const int gid = lane >> 2, tig = lane & 3;

  // one stage: A BM x BK and B BK x BN, in 16-byte chunks
  auto load = [&](int c, int stage) {
    bf16* as = sm + stage * Tl::kStageElems;
    bf16* bs = as + BM * Tl::kLdA;
    const int k0 = (c0 + c) * BK;
#pragma unroll
    for (int u = 0; u < Tl::kLoadsA; ++u) {
      const int i = threadIdx.x + u * Tl::kThreads;
      const int r = i / (BK / 8), kc = (i % (BK / 8)) * 8;
      bf16* dst = as + r * Tl::kLdA + kc;
      if (m0 + r < M && k0 + kc < K)
        cp_async16(dst, x + (size_t)(m0 + r) * K + k0 + kc);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < Tl::kLoadsB; ++u) {
      const int i = threadIdx.x + u * Tl::kThreads;
      const int r = i / (BN / 8), nc = (i % (BN / 8)) * 8;
      bf16* dst = bs + r * Tl::kLdB + nc;
      if (k0 + r < K && n0 + nc < N)
        cp_async16(dst, w + (size_t)(k0 + r) * N + n0 + nc);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    }
  };

  float acc[MI][NI][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nk) load(st, st);
    cp_async_commit();
  }
  for (int c = 0; c < nk; ++c) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();   // chunk c landed; chunk c - 1's stage is free
    if (c + STAGES - 1 < nk) load(c + STAGES - 1, (c + STAGES - 1) % STAGES);
    cp_async_commit();
    const bf16* as = sm + (c % STAGES) * Tl::kStageElems;
    const bf16* bs = as + BM * Tl::kLdA;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t af[MI][4], bfr[NI / 2][4];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
        ldsm_x4(af[mi], as + (wm * WM + mi * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * Tl::kLdA +
                            kk * 16 + ((lane >> 4) & 1) * 8);
#pragma unroll
      for (int nb = 0; nb < NI / 2; ++nb)
        ldsm_x4_trans(bfr[nb], bs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * Tl::kLdB +
                                   wn * WN + nb * 16 + ((lane >> 4) & 1) * 8);
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int nb = 0; nb < NI / 2; ++nb) {
          mma_bf16(acc[mi][2 * nb], af[mi], bfr[nb][0], bfr[nb][1]);
          mma_bf16(acc[mi][2 * nb + 1], af[mi], bfr[nb][2], bfr[nb][3]);
        }
    }
  }
  cp_async_wait<0>();

  // rows gid and gid + 8 of each m16 tile, column pairs 2·tig
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = m0 + wm * WM + mi * 16 + gid + 8 * i;
        const int col = n0 + wn * WN + ni * 8 + 2 * tig;
        if (r >= M || col >= N) continue;
        const float a0 = acc[mi][ni][2 * i], a1 = acc[mi][ni][2 * i + 1];
        if (S == 1)
          *reinterpret_cast<uint32_t*>(y + (size_t)r * N + col) = pack_bf16(a0, a1);
        else
          *reinterpret_cast<float2*>(ws + ((size_t)s * M + r) * N + col) =
              make_float2(a0, a1);
      }
}

// Launch one bf16 tile shape (its partials, or y when S == 1).
template <int BM, int BN, int BK, int WM, int WN, int STAGES>
inline cudaError_t launch_linear_rows_bf16(const void* x, const void* w,
                                           void* y, float* ws, int M, int N,
                                           int K, int S, cudaStream_t st) {
  using Tl = LrTile<BM, BN, BK, WM, WN, STAGES>;
  auto* kern = linear_rows_bf16_kernel<BM, BN, BK, WM, WN, STAGES>;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Tl::kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, S);
  kern<<<grid, Tl::kThreads, Tl::kSmemBytes, st>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w), static_cast<__nv_bfloat16*>(y),
      ws, M, N, K, S);
  return cudaGetLastError();
}

// float32: 64 x 64 tiles, 256 threads of 4 x 4 outputs, sequential fmaf
// over K in each split.
__global__ void __launch_bounds__(256)
    linear_rows_f32_kernel(const float* __restrict__ x,
                           const float* __restrict__ w, float* __restrict__ y,
                           float* __restrict__ ws, int M, int N, int K,
                           int S) {
  __shared__ float as[kLfBK][kLfBM + 4];   // A transposed: as[k][m]
  __shared__ __align__(16) float bs[kLfBK][kLfBN];
  const int n0 = blockIdx.x * kLfBN, m0 = blockIdx.y * kLfBM;
  const int s = blockIdx.z;
  int c0, c1;
  split_range(s, S, (K + kLfBK - 1) / kLfBK, c0, c1);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int c = c0; c < c1; ++c) {
    const int k0 = c * kLfBK;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = threadIdx.x + u * 256;
      const int r = i / kLfBK, kk = i % kLfBK;
      as[kk][r] = (m0 + r < M && k0 + kk < K) ? x[(size_t)(m0 + r) * K + k0 + kk] : 0.f;
      const int kb = i / kLfBN, n = i % kLfBN;
      bs[kb][n] = (k0 + kb < K && n0 + n < N) ? w[(size_t)(k0 + kb) * N + n0 + n] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kLfBK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = as[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = m0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (r >= M || col >= N) continue;
      if (S == 1)
        y[(size_t)r * N + col] = acc[i][j];
      else
        ws[((size_t)s * M + r) * N + col] = acc[i][j];
    }
  }
}

// y = sum over s of ws[s], in the order s = 0, 1, ..., S - 1, rounded
// once; 4 elements a thread (N is a multiple of 4).
template <typename T>
__global__ void linear_rows_combine_kernel(const float* __restrict__ ws,
                                           T* __restrict__ y, size_t mn,
                                           int S) {
  const size_t i = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (i >= mn) return;
  float4 a = *reinterpret_cast<const float4*>(ws + i);
  for (int s = 1; s < S; ++s) {
    const float4 b = *reinterpret_cast<const float4*>(ws + (size_t)s * mn + i);
    a.x += b.x;
    a.y += b.y;
    a.z += b.z;
    a.w += b.w;
  }
  if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float4*>(y + i) = a;
  } else {
    uint2 o;
    o.x = pack_bf16(a.x, a.y);
    o.y = pack_bf16(a.z, a.w);
    *reinterpret_cast<uint2*>(y + i) = o;
  }
}

}  // namespace repro

// dtype: 0 = float32, 1 = bfloat16.  ws: S·M·N fp32 when S > 1.  Returns
// a cudaError_t as int: cudaErrorInvalidValue for arguments it does not
// take (N, K not multiples of 8 elements for bf16 or 4 for fp32, S
// outside [1, number of K chunks]).
extern "C" int repro_linear_rows(const void* x, const void* w, void* y,
                                 void* ws, int M, int N, int K, int S,
                                 int dtype, void* stream) {
  using namespace repro;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int bk = dtype == 1 ? kLrBK : kLfBK;
  const int vec = dtype == 1 ? 8 : 4;
  if (M <= 0 || N <= 0 || K <= 0 || N % vec || K % vec || S < 1 ||
      S > (K + bk - 1) / bk || (S > 1 && ws == nullptr) ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  float* wsf = static_cast<float*>(ws);
  cudaError_t err;
  if (dtype == 1) {
    err = launch_linear_rows_bf16<kLrBM, kLrBN, kLrBK, kLrWM, kLrWN, kLrStages>(
        x, w, y, wsf, M, N, K, S, st);
    if (err != cudaSuccess) return (int)err;
  } else {
    const dim3 grid((N + kLfBN - 1) / kLfBN, (M + kLfBM - 1) / kLfBM, S);
    linear_rows_f32_kernel<<<grid, 256, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(y), wsf, M, N, K, S);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || S == 1) return (int)err;
  const size_t mn = (size_t)M * N;
  const unsigned blocks = (unsigned)((mn / 4 + 255) / 256);
  if (dtype == 1)
    linear_rows_combine_kernel<__nv_bfloat16><<<blocks, 256, 0, st>>>(
        wsf, static_cast<__nv_bfloat16*>(y), mn, S);
  else
    linear_rows_combine_kernel<float><<<blocks, 256, 0, st>>>(
        wsf, static_cast<float*>(y), mn, S);
  return (int)cudaGetLastError();
}
