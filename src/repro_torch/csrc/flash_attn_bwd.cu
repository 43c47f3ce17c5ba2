// Backward of the prefill attention for Hopper (sm_90a): the gradient of
// causal GQA attention with no pad, no window and no softcap, the
// training form of the draft layer (core/eagle.py _layer_full).
//
// Replaces no Pallas kernel: no TPU kernel of the JAX package has a
// backward (its pallas_calls carry no custom_vjp).  JAX trains the draft
// through its jnp attention (src/repro/core/eagle.py:100 _layer_full ->
// models/attention.py self_attention_prefill) and differentiates that.
// The port runs the draft's training forward through its prefill kernel
// (flash_attn.cu), so the gradient is this kernel, bound to the forward
// by kernels/flash_attn/ops.py FlashAttentionFn.
//
// Inputs: q, o, dO (B, S, Hq, D); k, v (B, S, Hk, D); lse (B, S, Hq)
// float32, each row's log-sum-exp of its scaled scores, stored by the
// forward launch (AttnArgs::lse).  Outputs dq, dk, dv in the inputs'
// dtype (float32 or bfloat16), head_dim 32, 64 or 128.  With scale =
// 1/sqrt(D), P = exp(scale * Q.K^T - lse) on the causal keys:
//   delta = rowsum(dO * O)              (flash_bwd_delta_kernel)
//   dV = P^T.dO,  dS = P * (dO.V^T - delta),  dK = scale * dS^T.Q
//     one block per (key tile, kv head, lane); the G query heads of the
//     kv head are rows of the block's walk, so their sums meet inside
//     the block                         (flash_bwd_dkdv_kernel)
//   dQ = scale * dS.K
//     one block per (row tile, kv head, lane) (flash_bwd_dq_kernel)
// Each output element is written by one thread of one block, its sum
// taken in a fixed order: no atomics, so two calls on the same inputs
// give the same bits.  P and dS are recomputed in both passes (two
// score products, where a one-pass kernel with atomics on dQ needs one).
//
// Arithmetic.  Everything is fp32 FMA from shared memory, whatever the
// storage dtype (bf16 inputs are widened as they are loaded, outputs
// rounded once): the simple form first.  Rows are (position t, query
// head g) pairs of one kv head, t-major and g-minor as in attn_rows.cuh.
// A score pass gives each lane one key of a 32-key tile and each warp
// four rows (Q and dO rows broadcast as float4, K and V tiles transposed
// in shared memory so that the 32 lanes read 32 banks); the dK/dV pass
// then gives each warp four keys and each lane D/32 columns, summing
// over the chunk's 32 rows; the dQ pass moves dS to the lanes of its
// columns by shuffles.
//
// What bounds it on an H100.  At the glm4-9b draft shape (B 8, S 512,
// 32/2 heads, D 128, bf16) the least work is 5 products over the causal
// half, ~43 GFLOP (0.043 ms at 989 TFLOP/s on bf16 tensor cores), and
// ~50 MB of traffic (0.015 ms at 3.35 TB/s): operations bound it.  This
// kernel runs those operations as fp32 FMA off the tensor cores, whose
// peak is 67 TFLOP/s (0.64 ms for the same work), and the five products
// are seven here (the scores and dO.V^T in both passes).  The tensor-core
// form (mma.sync or wgmma, P and dS as bf16 fragments) is the redesign
// queued after it (ROADMAP queue 2).
#include "attn_rows.cuh"

namespace repro {
namespace {

constexpr int kBwdKeys = 32;           // keys per tile, one per lane
constexpr int kBwdRowsPerWarp = 4;     // rows per warp in a score pass
constexpr int kBwdKvWarps = 8;         // dK/dV blocks
constexpr int kBwdKvRows = kBwdKvWarps * kBwdRowsPerWarp;   // rows per chunk
constexpr int kBwdKeysPerWarp = kBwdKeys / kBwdKvWarps;
constexpr int kBwdQWarps = 4;          // dQ blocks
constexpr int kBwdQRows = kBwdQWarps * kBwdRowsPerWarp;     // rows per block
constexpr int kBwdLD = kBwdKeys + 1;   // transposed tile row stride
static_assert(kBwdKeysPerWarp * kBwdKvWarps == kBwdKeys, "keys per warp");

struct BwdArgs {
  const void* q;       // (B, S, Hq, D)
  const void* k;       // (B, S, Hk, D)
  const void* v;       // (B, S, Hk, D)
  const void* o;       // (B, S, Hq, D)
  const void* dout;    // (B, S, Hq, D)
  const float* lse;    // (B, S, Hq)
  float* delta;        // (B, S, Hq) scratch
  void* dq;            // (B, S, Hq, D)
  void* dk;            // (B, S, Hk, D)
  void* dv;            // (B, S, Hk, D)
  int B, S, Hq, Hk;
  float scale;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <int D>
constexpr int dkdv_smem_bytes() {
  return (2 * kBwdKvRows * D + 2 * D * kBwdLD + 2 * kBwdKvRows * kBwdLD) *
         (int)sizeof(float);
}

template <int D>
constexpr int dq_smem_bytes() {
  return (2 * kBwdQRows * D + 2 * D * kBwdLD) * (int)sizeof(float);
}

// R rows (from row r_first of lane b, kv head hk) of a (B, S, Hq, D)
// tensor into fp32 shared memory [R][D]; rows past nrows are zeros.
template <typename T, int D, int R, int NT>
__device__ __forceinline__ void load_rows(float* dst, const void* src_v,
                                          const BwdArgs& a, int b, int hk,
                                          int G, int r_first, int nrows) {
  constexpr int VN = Vec16<T>::N;
  constexpr int kVec = R * D / VN;
  const T* src = static_cast<const T*>(src_v);
  for (int vi = threadIdx.x; vi < kVec; vi += NT) {
    const int e0 = vi * VN;
    const int rr = e0 / D, d0 = e0 % D, r = r_first + rr;
    float* out = dst + rr * D + d0;
    if (r < nrows) {
      const int t = r / G, h = hk * G + r % G;
      const uint4 raw = *reinterpret_cast<const uint4*>(
          src + (((size_t)b * a.S + t) * a.Hq + h) * D + d0);
      Vec16<T>::unpack(raw, out);
    } else {
#pragma unroll
      for (int e = 0; e < VN; ++e) out[e] = 0.f;
    }
  }
}

// The K and V rows of keys [k0, k0 + 32) of lane b, kv head hk, as fp32
// transposed tiles [D][kBwdLD]; keys past S are zeros.
template <typename T, int D, int NT>
__device__ __forceinline__ void load_kv_t(float* kT, float* vT,
                                          const BwdArgs& a, int b, int hk,
                                          int k0) {
  constexpr int VN = Vec16<T>::N;
  constexpr int kVec = kBwdKeys * D / VN;
  const T* kc = static_cast<const T*>(a.k);
  const T* vc = static_cast<const T*>(a.v);
  for (int vi = threadIdx.x; vi < kVec; vi += NT) {
    const int e0 = vi * VN;
    const int j = e0 / D, d0 = e0 % D, kp = k0 + j;
    float kx[VN], vx[VN];
    if (kp < a.S) {
      const size_t off = (((size_t)b * a.S + kp) * a.Hk + hk) * D + d0;
      Vec16<T>::unpack(*reinterpret_cast<const uint4*>(kc + off), kx);
      Vec16<T>::unpack(*reinterpret_cast<const uint4*>(vc + off), vx);
    } else {
#pragma unroll
      for (int e = 0; e < VN; ++e) kx[e] = vx[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < VN; ++e) {
      kT[(d0 + e) * kBwdLD + j] = kx[e];
      vT[(d0 + e) * kBwdLD + j] = vx[e];
    }
  }
}

// One row's score and dO.V^T against the lane's key of the tile.
template <int D>
__device__ __forceinline__ void score_pair(const float* qr, const float* dr,
                                           const float* kT, const float* vT,
                                           int lane, float& s, float& dp) {
  s = 0.f;
  dp = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; d += 4) {
    const float4 qv = *reinterpret_cast<const float4*>(qr + d);
    const float4 gv = *reinterpret_cast<const float4*>(dr + d);
    s += qv.x * kT[d * kBwdLD + lane] + qv.y * kT[(d + 1) * kBwdLD + lane] +
         qv.z * kT[(d + 2) * kBwdLD + lane] + qv.w * kT[(d + 3) * kBwdLD + lane];
    dp += gv.x * vT[d * kBwdLD + lane] + gv.y * vT[(d + 1) * kBwdLD + lane] +
          gv.z * vT[(d + 2) * kBwdLD + lane] + gv.w * vT[(d + 3) * kBwdLD + lane];
  }
}

// delta[row] = sum_d dO * O, one warp per (b, t, h) row.
template <typename T, int D>
__global__ void __launch_bounds__(256) flash_bwd_delta_kernel(BwdArgs a) {
  const size_t rows = (size_t)a.B * a.S * a.Hq;
  const size_t r = (size_t)blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (r >= rows) return;
  const T* o = static_cast<const T*>(a.o) + r * D;
  const T* g = static_cast<const T*>(a.dout) + r * D;
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < D / 32; ++c)
    acc += to_f(o[lane + 32 * c]) * to_f(g[lane + 32 * c]);
  acc = warp_sum(acc);
  if (lane == 0) a.delta[r] = acc;
}

// dK, dV of one 32-key tile of (lane b, kv head hk): the rows that see
// the tile (positions t >= k0, every query head of the group) walked in
// chunks of kBwdKvRows.
template <typename T, int D>
__global__ void __launch_bounds__(kBwdKvWarps * 32)
    flash_bwd_dkdv_kernel(BwdArgs a) {
  constexpr int C = D / 32;
  constexpr int NT = kBwdKvWarps * 32;
  constexpr int R = kBwdKvRows;
  extern __shared__ __align__(16) float bwd_smem[];
  float* qs = bwd_smem;            // [R][D]
  float* dos = qs + R * D;         // [R][D]
  float* kT = dos + R * D;         // [D][kBwdLD]
  float* vT = kT + D * kBwdLD;     // [D][kBwdLD]
  float* ps = vT + D * kBwdLD;     // [R][kBwdLD]
  float* dss = ps + R * kBwdLD;    // [R][kBwdLD]

  const int G = a.Hq / a.Hk;
  const int nrows = a.S * G;
  const int b = blockIdx.z, hk = blockIdx.y;
  const int k0 = blockIdx.x * kBwdKeys;   // the earliest tiles, the most rows, first
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int kp = k0 + lane;

  load_kv_t<T, D, NT>(kT, vT, a, b, hk, k0);
  float dk[kBwdKeysPerWarp][C], dv[kBwdKeysPerWarp][C];
#pragma unroll
  for (int jj = 0; jj < kBwdKeysPerWarp; ++jj)
#pragma unroll
    for (int c = 0; c < C; ++c) dk[jj][c] = dv[jj][c] = 0.f;

  for (int r0 = k0 * G; r0 < nrows; r0 += R) {
    __syncthreads();   // the previous chunk is no longer read
    load_rows<T, D, R, NT>(qs, a.q, a, b, hk, G, r0, nrows);
    load_rows<T, D, R, NT>(dos, a.dout, a, b, hk, G, r0, nrows);
    __syncthreads();
    // P and dS of the warp's rows against the lane's key
#pragma unroll
    for (int i = 0; i < kBwdRowsPerWarp; ++i) {
      const int rr = warp * kBwdRowsPerWarp + i, r = r0 + rr;
      float s, dp;
      score_pair<D>(qs + rr * D, dos + rr * D, kT, vT, lane, s, dp);
      float p = 0.f, ds = 0.f;
      if (r < nrows) {
        const int t = r / G, h = hk * G + r % G;
        const size_t ri = ((size_t)b * a.S + t) * a.Hq + h;
        const float lse = a.lse[ri];
        if (kp <= t && lse != -INFINITY) {
          p = expf(s * a.scale - lse);
          ds = p * (dp - a.delta[ri]);
        }
      }
      ps[rr * kBwdLD + lane] = p;
      dss[rr * kBwdLD + lane] = ds;
    }
    __syncthreads();
    // the warp's keys, the lane's columns, summed over the chunk's rows
#pragma unroll 4
    for (int rr = 0; rr < R; ++rr) {
      float qv[C], gv[C];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        qv[c] = qs[rr * D + lane + 32 * c];
        gv[c] = dos[rr * D + lane + 32 * c];
      }
#pragma unroll
      for (int jj = 0; jj < kBwdKeysPerWarp; ++jj) {
        const int j = warp * kBwdKeysPerWarp + jj;
        const float p = ps[rr * kBwdLD + j], ds = dss[rr * kBwdLD + j];
#pragma unroll
        for (int c = 0; c < C; ++c) {
          dv[jj][c] += p * gv[c];
          dk[jj][c] += ds * qv[c];
        }
      }
    }
  }

  T* dko = static_cast<T*>(a.dk);
  T* dvo = static_cast<T*>(a.dv);
#pragma unroll
  for (int jj = 0; jj < kBwdKeysPerWarp; ++jj) {
    const int key = k0 + warp * kBwdKeysPerWarp + jj;
    if (key >= a.S) continue;
    const size_t off = (((size_t)b * a.S + key) * a.Hk + hk) * D;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      dko[off + lane + 32 * c] = from_f<T>(dk[jj][c] * a.scale);
      dvo[off + lane + 32 * c] = from_f<T>(dv[jj][c]);
    }
  }
}

// dQ of one tile of kBwdQRows rows of (lane b, kv head hk), walking the
// key tiles up to the tile's last position.
template <typename T, int D>
__global__ void __launch_bounds__(kBwdQWarps * 32)
    flash_bwd_dq_kernel(BwdArgs a) {
  constexpr int C = D / 32;
  constexpr int NT = kBwdQWarps * 32;
  constexpr int R = kBwdQRows;
  extern __shared__ __align__(16) float bwd_smem[];
  float* qs = bwd_smem;            // [R][D]
  float* dos = qs + R * D;         // [R][D]
  float* kT = dos + R * D;         // [D][kBwdLD]
  float* vT = kT + D * kBwdLD;     // [D][kBwdLD]

  const int G = a.Hq / a.Hk;
  const int nrows = a.S * G;
  const int b = blockIdx.z, hk = blockIdx.y;
  const int row0 = (gridDim.x - 1 - blockIdx.x) * R;   // the most keys first
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  load_rows<T, D, R, NT>(qs, a.q, a, b, hk, G, row0, nrows);
  load_rows<T, D, R, NT>(dos, a.dout, a, b, hk, G, row0, nrows);
  int tpos[kBwdRowsPerWarp];
  float lse[kBwdRowsPerWarp], delta[kBwdRowsPerWarp];
  float dq[kBwdRowsPerWarp][C];
#pragma unroll
  for (int i = 0; i < kBwdRowsPerWarp; ++i) {
    const int r = row0 + warp * kBwdRowsPerWarp + i;
    tpos[i] = -1;
    lse[i] = -INFINITY;
    delta[i] = 0.f;
    if (r < nrows) {
      const int t = r / G, h = hk * G + r % G;
      const size_t ri = ((size_t)b * a.S + t) * a.Hq + h;
      tpos[i] = t;
      lse[i] = a.lse[ri];
      delta[i] = a.delta[ri];
    }
#pragma unroll
    for (int c = 0; c < C; ++c) dq[i][c] = 0.f;
  }
  const int kv_hi = (min(row0 + R, nrows) - 1) / G;

  for (int k0 = 0; k0 <= kv_hi; k0 += kBwdKeys) {
    __syncthreads();   // the previous tile is no longer read
    load_kv_t<T, D, NT>(kT, vT, a, b, hk, k0);
    __syncthreads();
    const int kp = k0 + lane;
    float ds[kBwdRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kBwdRowsPerWarp; ++i) {
      const int rr = warp * kBwdRowsPerWarp + i;
      float s, dp;
      score_pair<D>(qs + rr * D, dos + rr * D, kT, vT, lane, s, dp);
      ds[i] = 0.f;
      if (kp <= tpos[i] && lse[i] != -INFINITY)
        ds[i] = expf(s * a.scale - lse[i]) * (dp - delta[i]);
    }
    // dQ += dS . K: key j's dS from lane j, the lane's columns of K
#pragma unroll 4
    for (int j = 0; j < kBwdKeys; ++j) {
      float kv[C];
#pragma unroll
      for (int c = 0; c < C; ++c) kv[c] = kT[(lane + 32 * c) * kBwdLD + j];
#pragma unroll
      for (int i = 0; i < kBwdRowsPerWarp; ++i) {
        const float dsj = __shfl_sync(0xffffffffu, ds[i], j);
#pragma unroll
        for (int c = 0; c < C; ++c) dq[i][c] += dsj * kv[c];
      }
    }
  }

  T* dqo = static_cast<T*>(a.dq);
#pragma unroll
  for (int i = 0; i < kBwdRowsPerWarp; ++i) {
    if (tpos[i] < 0) continue;
    const int r = row0 + warp * kBwdRowsPerWarp + i;
    const size_t off =
        (((size_t)b * a.S + tpos[i]) * a.Hq + hk * G + r % G) * D;
#pragma unroll
    for (int c = 0; c < C; ++c)
      dqo[off + lane + 32 * c] = from_f<T>(dq[i][c] * a.scale);
  }
}

template <typename T, int D>
int launch_bwd(const BwdArgs& a, cudaStream_t st) {
  const int nrows = a.S * (a.Hq / a.Hk);
  const size_t rows = (size_t)a.B * a.S * a.Hq;
  flash_bwd_delta_kernel<T, D><<<(unsigned)((rows + 7) / 8), 256, 0, st>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  constexpr int kv_bytes = dkdv_smem_bytes<D>();
  err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kv_bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 g1((a.S + kBwdKeys - 1) / kBwdKeys, a.Hk, a.B);
  flash_bwd_dkdv_kernel<T, D><<<g1, kBwdKvWarps * 32, kv_bytes, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  constexpr int q_bytes = dq_smem_bytes<D>();
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             q_bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 g2((nrows + kBwdQRows - 1) / kBwdQRows, a.Hk, a.B);
  flash_bwd_dq_kernel<T, D><<<g2, kBwdQWarps * 32, q_bytes, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace repro

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t as int:
// cudaErrorInvalidValue for shapes, dtypes or head dims it does not take.
extern "C" int repro_flash_attn_bwd(const void* q, const void* k,
                                    const void* v, const void* o,
                                    const void* dout, const float* lse,
                                    float* delta, void* dq, void* dk,
                                    void* dv, int B, int S, int Hq, int Hk,
                                    int D, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || Hk <= 0 || Hq <= 0 || Hq % Hk != 0)
    return (int)cudaErrorInvalidValue;
  repro::BwdArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.dout = dout;
  a.lse = lse;
  a.delta = delta;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.B = B;
  a.S = S;
  a.Hq = Hq;
  a.Hk = Hk;
  a.scale = 1.0f / sqrtf((float)D);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_BWD_CASE(DT, DD) \
  if (D == DD) return repro::launch_bwd<DT, DD>(a, st);
  if (dtype == 0) {
    REPRO_BWD_CASE(float, 32)
    REPRO_BWD_CASE(float, 64)
    REPRO_BWD_CASE(float, 128)
  } else if (dtype == 1) {
    REPRO_BWD_CASE(__nv_bfloat16, 32)
    REPRO_BWD_CASE(__nv_bfloat16, 64)
    REPRO_BWD_CASE(__nv_bfloat16, 128)
  }
#undef REPRO_BWD_CASE
  return (int)cudaErrorInvalidValue;
}
