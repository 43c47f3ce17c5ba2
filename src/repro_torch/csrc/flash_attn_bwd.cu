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
//   delta = rowsum(dO * O),  dV = P^T.dO,  dS = P * (dO.V^T - delta),
//   dK = scale * dS^T.Q,  dQ = scale * dS.K.
// Rows are (position t, query head g) pairs of one kv head, t-major and
// g-minor as in attn_rows.cuh, so the G query heads of a kv head meet in
// one block's sums.  Every output element is summed in a fixed order
// and written once: no atomics, so two calls on the same inputs give the
// same bits.  P and dS are recomputed in the dK/dV and the dQ pass (two
// score products, where a one-pass kernel with atomics on dQ needs one).
//
// bfloat16: tensor cores (path mma_bf16_split_rows).  Every product is
// mma.sync.aligned.m16n8k16, bf16 inputs and fp32 accumulation, from
// shared memory staged by cp.async in rows of D + 8 elements (the eight
// 16-byte rows of an ldmatrix fall in eight bank groups), tiles as in
// prefill_rows.cuh: row tiles of 64 rows (at G = 16, 4 positions) and
// key tiles of 64 keys anchored at key 0.  Three launches:
//   flash_bwd_dq_mma_kernel: one block of 4 warps per (row tile, kv
//     head, lane), a warp 16 rows.  Its prologue takes delta of its rows
//     (dO from the staged tile, O from device memory) and stores it for
//     the dK/dV pass; then it walks the key tiles up to its last
//     position, K/V double-buffered: S = Q.K^T and dP = dO.V^T (K, V
//     through ldmatrix), dS in registers, dQ += dS.K (dS as the A
//     fragment straight from the accumulators, K through ldmatrix.trans).
//     dQ is written once.
//   flash_bwd_dkdv_mma_kernel: one block of 8 warps per (split, kv
//     head, lane).  A split is a run of row tiles that see one key tile:
//     the block holds the tile's K and V in shared memory and walks its
//     row tiles, Q/dO tiles and their LSE/delta slices double-buffered.
//     Per row tile, warp (k, h) first computes S^T = K.Q^T and dP^T =
//     V.dO^T for keys 16k.. and rows 32h.. and stores P^T and dS^T to
//     shared memory; then warp (k, h) accumulates dV += P^T.dO and dK +=
//     dS^T.Q for keys 16k.. and columns (D/2)h.. (P^T, dS^T through
//     ldmatrix, dO and Q through ldmatrix.trans), fp32 in registers
//     (D / 2 columns of two 16-row accumulators: 64 registers at D 128).
//     A key tile of one split writes dK, dV straight to the outputs;
//     otherwise each split writes its partial sums to fp32 scratch.
//   flash_bwd_reduce_kernel: per key tile of several splits, adds the
//     partials in split order 0..n-1, scales dK, rounds once.
// The split schedule is computed in Python (ops.py bwd_schedule) from
// (S, G) and the tile constants alone (which the built kernel reports
// through repro_flash_attn_bwd_tile), never from B or the data, and
// passed in as a table: a lane's gradients are the same bits alone and
// in any batch.  It gives key tile 0, which every row sees, up to 8
// splits (a fixed number of row tiles each, counted from the key tile's
// first row) and every later key tile as many of the same length as its
// rows fill: at the draft's training shape (S 62, G 16, Hk 2, B 8) one
// key tile of 16 row tiles in 8 splits, 128 blocks, and 256 dQ blocks.
// Precision: P, dS are fp32 where they are made; each enters its product
// as two bf16 halves, hi = bf16(x) and lo = bf16(x - hi), two products
// into one fp32 accumulator, as the forward's P.V (prefill_rows.cuh).
// One bf16 (8 significant bits) moves a gradient by about 2^-9 of its
// size where its terms cancel, near the 1e-3 relative L2 the kernel is
// held to (chip_smoke.py prints the error of a one-bf16 emulation beside
// the kernel's); the pair keeps 16 bits.
//
// float32: fp32 FMA from shared memory (path fma_fp32_two_pass), three
// launches: delta (flash_bwd_delta_kernel); dK/dV with one block per
// (32-key tile, kv head, lane) walking every row that sees the tile
// (flash_bwd_dkdv_kernel); dQ with one block per (16-row tile, kv head,
// lane) (flash_bwd_dq_kernel).  A score pass gives each lane one key of
// a 32-key tile and each warp four rows (Q and dO rows broadcast as
// float4, K and V tiles transposed in shared memory so that the 32 lanes
// read 32 banks); the dK/dV pass then gives each warp four keys and each
// lane D/32 columns, summing over the chunk's 32 rows; the dQ pass moves
// dS to the lanes of its columns by shuffles.
//
// What bounds it on an H100 (80GB HBM3, 700 W; chip_smoke.py's kernels
// phase, PERF.md row 8).  At the draft's training shape (S 62, B 8,
// 32/2 heads, D 128, bf16) the least time is the bytes, ~17 MB (0.005 ms
// at 3.35 TB/s); the kernel takes ~0.03 ms on the device, three
// launches of 128-256 blocks (dQ ~0.012, dK/dV ~0.013, reduce ~0.003),
// each a short serial chain of loads, products and stores.  At S 512
// the least work is 5 products over the causal half, ~43 GFLOP (0.044 ms
// at 989 TFLOP/s): operations bound it.  The kernel runs 10
// product-equivalents (the scores and dO.V^T in both passes, P and dS as
// two halves each) on mma.sync and takes ~0.54 ms (dQ ~0.17, dK/dV
// ~0.35), about twice SDPA's autograd backward.  The dK/dV pass holds
// one block of 8 warps per SM (238 registers a thread, 142 KB of shared
// memory at D 128), too few warps to hide the ldmatrix and mma
// latencies: splitting its warps by product (a sixth fewer ldmatrix
// loads, one more barrier a row tile) ran it 18 % slower.  wgmma, with
// K, V, Q and dO read from shared memory by descriptor, is the next step.
#include "attn_rows.cuh"
#include "tc_bf16.cuh"

namespace repro {
namespace {

// ================================================= float32: FMA kernels

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
  // bfloat16 only: the dK/dV work split of kernels/flash_attn/ops.py
  // bwd_schedule, and the scratch of its partial sums
  const int* split;    // (n_split, 4): key tile, first and end row tile,
                       // splits of that key tile
  const int* ktile;    // (n_kt, 2): first split, splits
  float* ws;           // (B, Hk, n_split, 2, kTbKeys, D) partial dK, dV;
                       // null when no key tile has two splits
  int n_split;
  int B, S, Hq, Hk;
  float scale;
};

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
template <int D, int R, int NT>
__device__ __forceinline__ void load_rows(float* dst, const void* src_v,
                                          const BwdArgs& a, int b, int hk,
                                          int G, int r_first, int nrows) {
  constexpr int VN = Vec16<float>::N;
  constexpr int kVec = R * D / VN;
  const float* src = static_cast<const float*>(src_v);
  for (int vi = threadIdx.x; vi < kVec; vi += NT) {
    const int e0 = vi * VN;
    const int rr = e0 / D, d0 = e0 % D, r = r_first + rr;
    float* out = dst + rr * D + d0;
    if (r < nrows) {
      const int t = r / G, h = hk * G + r % G;
      const uint4 raw = *reinterpret_cast<const uint4*>(
          src + (((size_t)b * a.S + t) * a.Hq + h) * D + d0);
      Vec16<float>::unpack(raw, out);
    } else {
#pragma unroll
      for (int e = 0; e < VN; ++e) out[e] = 0.f;
    }
  }
}

// The K and V rows of keys [k0, k0 + 32) of lane b, kv head hk, as fp32
// transposed tiles [D][kBwdLD]; keys past S are zeros.
template <int D, int NT>
__device__ __forceinline__ void load_kv_t(float* kT, float* vT,
                                          const BwdArgs& a, int b, int hk,
                                          int k0) {
  constexpr int VN = Vec16<float>::N;
  constexpr int kVec = kBwdKeys * D / VN;
  const float* kc = static_cast<const float*>(a.k);
  const float* vc = static_cast<const float*>(a.v);
  for (int vi = threadIdx.x; vi < kVec; vi += NT) {
    const int e0 = vi * VN;
    const int j = e0 / D, d0 = e0 % D, kp = k0 + j;
    float kx[VN], vx[VN];
    if (kp < a.S) {
      const size_t off = (((size_t)b * a.S + kp) * a.Hk + hk) * D + d0;
      Vec16<float>::unpack(*reinterpret_cast<const uint4*>(kc + off), kx);
      Vec16<float>::unpack(*reinterpret_cast<const uint4*>(vc + off), vx);
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
template <int D>
__global__ void __launch_bounds__(256) flash_bwd_delta_kernel(BwdArgs a) {
  const size_t rows = (size_t)a.B * a.S * a.Hq;
  const size_t r = (size_t)blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (r >= rows) return;
  const float* o = static_cast<const float*>(a.o) + r * D;
  const float* g = static_cast<const float*>(a.dout) + r * D;
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < D / 32; ++c)
    acc += o[lane + 32 * c] * g[lane + 32 * c];
  acc = warp_sum(acc);
  if (lane == 0) a.delta[r] = acc;
}

// dK, dV of one 32-key tile of (lane b, kv head hk): the rows that see
// the tile (positions t >= k0, every query head of the group) walked in
// chunks of kBwdKvRows.
template <int D>
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

  load_kv_t<D, NT>(kT, vT, a, b, hk, k0);
  float dk[kBwdKeysPerWarp][C], dv[kBwdKeysPerWarp][C];
#pragma unroll
  for (int jj = 0; jj < kBwdKeysPerWarp; ++jj)
#pragma unroll
    for (int c = 0; c < C; ++c) dk[jj][c] = dv[jj][c] = 0.f;

  for (int r0 = k0 * G; r0 < nrows; r0 += R) {
    __syncthreads();   // the previous chunk is no longer read
    load_rows<D, R, NT>(qs, a.q, a, b, hk, G, r0, nrows);
    load_rows<D, R, NT>(dos, a.dout, a, b, hk, G, r0, nrows);
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

  float* dko = static_cast<float*>(a.dk);
  float* dvo = static_cast<float*>(a.dv);
#pragma unroll
  for (int jj = 0; jj < kBwdKeysPerWarp; ++jj) {
    const int key = k0 + warp * kBwdKeysPerWarp + jj;
    if (key >= a.S) continue;
    const size_t off = (((size_t)b * a.S + key) * a.Hk + hk) * D;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      dko[off + lane + 32 * c] = dk[jj][c] * a.scale;
      dvo[off + lane + 32 * c] = dv[jj][c];
    }
  }
}

// dQ of one tile of kBwdQRows rows of (lane b, kv head hk), walking the
// key tiles up to the tile's last position.
template <int D>
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

  load_rows<D, R, NT>(qs, a.q, a, b, hk, G, row0, nrows);
  load_rows<D, R, NT>(dos, a.dout, a, b, hk, G, row0, nrows);
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
    load_kv_t<D, NT>(kT, vT, a, b, hk, k0);
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

  float* dqo = static_cast<float*>(a.dq);
#pragma unroll
  for (int i = 0; i < kBwdRowsPerWarp; ++i) {
    if (tpos[i] < 0) continue;
    const int r = row0 + warp * kBwdRowsPerWarp + i;
    const size_t off =
        (((size_t)b * a.S + tpos[i]) * a.Hq + hk * G + r % G) * D;
#pragma unroll
    for (int c = 0; c < C; ++c)
      dqo[off + lane + 32 * c] = dq[i][c] * a.scale;
  }
}

template <int D>
int launch_bwd_fma(const BwdArgs& a, cudaStream_t st) {
  const int nrows = a.S * (a.Hq / a.Hk);
  const size_t rows = (size_t)a.B * a.S * a.Hq;
  flash_bwd_delta_kernel<D><<<(unsigned)((rows + 7) / 8), 256, 0, st>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  constexpr int kv_bytes = dkdv_smem_bytes<D>();
  err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kv_bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 g1((a.S + kBwdKeys - 1) / kBwdKeys, a.Hk, a.B);
  flash_bwd_dkdv_kernel<D><<<g1, kBwdKvWarps * 32, kv_bytes, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  constexpr int q_bytes = dq_smem_bytes<D>();
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             q_bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 g2((nrows + kBwdQRows - 1) / kBwdQRows, a.Hk, a.B);
  flash_bwd_dq_kernel<D><<<g2, kBwdQWarps * 32, q_bytes, st>>>(a);
  return (int)cudaGetLastError();
}

// ============================================ bfloat16: tensor-core kernels

// kTbRows, kTbKeys: reported by repro_flash_attn_bwd_tile, the tiles of
// kernels/flash_attn/ops.py bwd_schedule
constexpr int kTbRows = 64;          // rows per row tile
constexpr int kTbKeys = 64;          // keys per key tile
constexpr int kTbPadE = 8;           // shared row padding, elements
constexpr int kTbQWarps = 4;         // dQ blocks: 16 rows a warp
constexpr int kTbKvWarps = 8;        // dK/dV blocks: 4 key groups x 2 halves
constexpr int kTbPLD = kTbRows + kTbPadE;   // P^T, dS^T row stride
constexpr int kTbRedThreads = 256;   // reduce blocks
static_assert(kTbRows == 16 * kTbQWarps, "a dQ warp holds 16 rows");
static_assert(kTbKeys == 16 * (kTbKvWarps / 2), "a dK/dV warp holds 16 keys");
static_assert(kTbRows == kTbKeys, "one load loop shape serves Q/dO and K/V");

constexpr float kLog2e = 1.4426950408889634f;

template <int D>
constexpr int dq_mma_smem_bytes() {
  // Q, dO; two stages of K, V
  return (2 * kTbRows + 4 * kTbKeys) * (D + kTbPadE) * 2;
}

template <int D>
constexpr int dkdv_mma_smem_bytes() {
  // K, V; two stages of Q, dO; P^T and dS^T, hi and lo; two stages of the
  // LSE and delta slices
  return (2 * kTbKeys + 4 * kTbRows) * (D + kTbPadE) * 2 +
         4 * kTbKeys * kTbPLD * 2 + 2 * 2 * kTbRows * (int)sizeof(float);
}

// The A fragment (16 rows from row m0, k16 step at column k0) of a
// row-major [rows][ld] bf16 tile, and the B fragments of two n8 tiles
// (rows n0.., k16 at k0) of a tile stored [n][k], through ldmatrix.
__device__ __forceinline__ const __nv_bfloat16* a_frag_at(
    const __nv_bfloat16* s, int ld, int m0, int k0, int lane) {
  return s + (m0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + k0 +
         ((lane >> 4) & 1) * 8;
}
__device__ __forceinline__ const __nv_bfloat16* b_frag_at(
    const __nv_bfloat16* s, int ld, int n0, int k0, int lane) {
  return s + (n0 + (lane & 7) + ((lane >> 4) & 1) * 8) * ld + k0 +
         ((lane >> 3) & 1) * 8;
}
// The B fragments of two n8 tiles (columns n0..) at k16 step k0 of a
// tile stored [k][n], through ldmatrix.trans.
__device__ __forceinline__ const __nv_bfloat16* bt_frag_at(
    const __nv_bfloat16* s, int ld, int k0, int n0, int lane) {
  return s + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + n0 +
         ((lane >> 4) & 1) * 8;
}

// 64 rows from row r0 of lane b, kv head hk, of q and dO (B, S, Hq, D)
// into [64][LD] tiles (rows past nrows zeros), by cp.async.
template <int D, int NT>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* qs,
                                           __nv_bfloat16* gs,
                                           const BwdArgs& a, int b, int hk,
                                           int G, int r0, int nrows) {
  constexpr int LD = D + kTbPadE, CH = D / 8;
  constexpr int kLoads = kTbRows * CH / NT;
  static_assert(kLoads * NT == kTbRows * CH, "whole loads per thread");
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q);
  const __nv_bfloat16* g = static_cast<const __nv_bfloat16*>(a.dout);
#pragma unroll
  for (int u = 0; u < kLoads; ++u) {
    const int c = threadIdx.x + u * NT;
    const int rr = c / CH, d0 = (c % CH) * 8, r = r0 + rr;
    __nv_bfloat16* qd = qs + rr * LD + d0;
    __nv_bfloat16* gd = gs + rr * LD + d0;
    if (r < nrows) {
      const int t = r / G, h = hk * G + r % G;
      const size_t off = (((size_t)b * a.S + t) * a.Hq + h) * D + d0;
      cp_async16(qd, q + off);
      cp_async16(gd, g + off);
    } else {
      *reinterpret_cast<uint4*>(qd) = make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(gd) = make_uint4(0, 0, 0, 0);
    }
  }
}

// Keys [k0, k0 + 64) of lane b, kv head hk, of k and v (B, S, Hk, D)
// into [64][LD] tiles (keys past k_hi zeros), by cp.async.
template <int D, int NT>
__device__ __forceinline__ void stage_keys(__nv_bfloat16* ks,
                                           __nv_bfloat16* vs,
                                           const BwdArgs& a, int b, int hk,
                                           int k0, int k_hi) {
  constexpr int LD = D + kTbPadE, CH = D / 8;
  constexpr int kLoads = kTbKeys * CH / NT;
  static_assert(kLoads * NT == kTbKeys * CH, "whole loads per thread");
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(a.k);
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(a.v);
#pragma unroll
  for (int u = 0; u < kLoads; ++u) {
    const int c = threadIdx.x + u * NT;
    const int jj = c / CH, d0 = (c % CH) * 8, kp = k0 + jj;
    __nv_bfloat16* kd = ks + jj * LD + d0;
    __nv_bfloat16* vd = vs + jj * LD + d0;
    if (kp <= k_hi) {
      const size_t off = (((size_t)b * a.S + kp) * a.Hk + hk) * D + d0;
      cp_async16(kd, k + off);
      cp_async16(vd, v + off);
    } else {
      *reinterpret_cast<uint4*>(kd) = make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(vd) = make_uint4(0, 0, 0, 0);
    }
  }
}

// dQ of one 64-row tile of (lane b, kv head hk), and delta of its rows.
template <int D>
__global__ void __launch_bounds__(kTbQWarps * 32, 2)
    flash_bwd_dq_mma_kernel(BwdArgs a) {
  using bf16 = __nv_bfloat16;
  constexpr int LD = D + kTbPadE;
  constexpr int KD = D / 16;             // k16 steps over the head dim
  constexpr int ND = D / 8;              // n8 tiles over the head dim
  constexpr int NK = kTbKeys / 8;        // n8 tiles over a key tile
  constexpr int NT = kTbQWarps * 32;
  extern __shared__ __align__(16) unsigned char tb_smem[];
  bf16* qs = reinterpret_cast<bf16*>(tb_smem);   // [64][LD]
  bf16* gs = qs + kTbRows * LD;                  // dO [64][LD]
  bf16* kvs = gs + kTbRows * LD;                 // [2][K, V][64][LD]

  const int G = a.Hq / a.Hk;
  const int nrows = a.S * G;
  const int b = blockIdx.z, hk = blockIdx.y;
  const int row0 = (gridDim.x - 1 - blockIdx.x) * kTbRows;   // most keys first
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane >> 2, tig = lane & 3;

  stage_rows<D, NT>(qs, gs, a, b, hk, G, row0, nrows);
  cp_async_commit();
  const int k_hi = (min(row0 + kTbRows, nrows) - 1) / G;   // last position
  const int ntiles = k_hi / kTbKeys + 1;
  stage_keys<D, NT>(kvs, kvs + kTbKeys * LD, a, b, hk, 0, k_hi);
  cp_async_commit();

  // this thread's rows gid, gid + 8 of its warp: position, LSE in log2
  // units, delta
  const int wr0 = row0 + warp * 16;
  int tpos[2];
  float lse2[2], dlt[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = wr0 + gid + 8 * i;
    tpos[i] = -1;
    lse2[i] = 0.f;
    if (r < nrows) {
      const float l = a.lse[((size_t)b * a.S + r / G) * a.Hq + hk * G + r % G];
      if (l != -INFINITY) {
        tpos[i] = r / G;
        lse2[i] = l * kLog2e;
      }
    }
  }
  const int w_hi = wr0 < nrows ? (min(wr0 + 16, nrows) - 1) / G : -1;

  // delta = rowsum(dO * O) of the warp's 16 rows, two lanes a row (half
  // the columns each, 16-byte loads, then one shuffle); stored for the
  // dK/dV pass
  cp_async_wait<1>();
  __syncthreads();
  {
    constexpr int kHalf = D / 2, kVec = kHalf / 8;
    const int i = lane >> 1, r = wr0 + i;
    float acc = 0.f;
    size_t ri = 0;
    if (r < nrows) {
      ri = ((size_t)b * a.S + r / G) * a.Hq + hk * G + r % G;
      const int c0 = (lane & 1) * kHalf;
      const uint4* ov = reinterpret_cast<const uint4*>(
          static_cast<const bf16*>(a.o) + ri * D + c0);
      const uint4* gv = reinterpret_cast<const uint4*>(
          gs + (warp * 16 + i) * LD + c0);
      uint4 oraw[kVec];
#pragma unroll
      for (int u = 0; u < kVec; ++u) oraw[u] = ov[u];
#pragma unroll
      for (int u = 0; u < kVec; ++u) {
        float of[8], gf[8];
        Vec16<bf16>::unpack(oraw[u], of);
        Vec16<bf16>::unpack(gv[u], gf);
#pragma unroll
        for (int e = 0; e < 8; ++e) acc = fmaf(of[e], gf[e], acc);
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (r < nrows && (lane & 1) == 0) a.delta[ri] = acc;
    dlt[0] = __shfl_sync(0xffffffffu, acc, 2 * gid);
    dlt[1] = __shfl_sync(0xffffffffu, acc, 2 * gid + 16);
  }

  const float c2 = a.scale * kLog2e;
  float dq[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;

  for (int j = 0; j < ntiles; ++j) {
    cp_async_wait<0>();   // key tile j has landed,
    __syncthreads();      // and no warp reads tile j - 1's stage any more
    if (j + 1 < ntiles) {
      bf16* nk = kvs + ((j + 1) & 1) * 2 * kTbKeys * LD;
      stage_keys<D, NT>(nk, nk + kTbKeys * LD, a, b, hk, (j + 1) * kTbKeys,
                        k_hi);
      cp_async_commit();
    }
    const int k0 = j * kTbKeys;
    if (k0 <= w_hi) {   // warp-uniform: some row of the warp sees the tile
      const bf16* ks = kvs + (j & 1) * 2 * kTbKeys * LD;
      const bf16* vs = ks + kTbKeys * LD;
      float s[NK][4], dp[NK][4];
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
      // S = Q K^T, dP = dO V^T
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t qa[4], ga[4];
        ldsm_x4(qa, a_frag_at(qs, LD, warp * 16, kk * 16, lane));
        ldsm_x4(ga, a_frag_at(gs, LD, warp * 16, kk * 16, lane));
#pragma unroll
        for (int nb = 0; nb < NK / 2; ++nb) {
          uint32_t kb[4], vb[4];
          ldsm_x4(kb, b_frag_at(ks, LD, nb * 16, kk * 16, lane));
          ldsm_x4(vb, b_frag_at(vs, LD, nb * 16, kk * 16, lane));
          mma_bf16(s[2 * nb], qa, kb[0], kb[1]);
          mma_bf16(s[2 * nb + 1], qa, kb[2], kb[3]);
          mma_bf16(dp[2 * nb], ga, vb[0], vb[1]);
          mma_bf16(dp[2 * nb + 1], ga, vb[2], vb[3]);
        }
      }
      // dS = P (dP - delta), into s; rows gid (elements 0, 1), gid + 8
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1, kp = k0 + n * 8 + 2 * tig + (e & 1);
          const float p =
              kp <= tpos[i] ? exp2f(fmaf(s[n][e], c2, -lse2[i])) : 0.f;
          s[n][e] = p * (dp[n][e] - dlt[i]);
        }
      // dQ += dS K: dS as hi + lo A fragments (keys as k), K through
      // ldmatrix.trans
#pragma unroll
      for (int kk = 0; kk < NK / 2; ++kk) {
        uint32_t sh[4], sl[4];
        float r0, r1;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float* sf = s[2 * kk + h];
          sh[2 * h] = pack_bf16(sf[0], sf[1], r0, r1);
          sl[2 * h] = pack_bf16(r0, r1);
          sh[2 * h + 1] = pack_bf16(sf[2], sf[3], r0, r1);
          sl[2 * h + 1] = pack_bf16(r0, r1);
        }
#pragma unroll
        for (int dn = 0; dn < ND / 2; ++dn) {
          uint32_t kb[4];
          ldsm_x4_trans(kb, bt_frag_at(ks, LD, kk * 16, dn * 16, lane));
          mma_bf16(dq[2 * dn], sh, kb[0], kb[1]);
          mma_bf16(dq[2 * dn + 1], sh, kb[2], kb[3]);
          mma_bf16(dq[2 * dn], sl, kb[0], kb[1]);
          mma_bf16(dq[2 * dn + 1], sl, kb[2], kb[3]);
        }
      }
    }
  }

  bf16* dqo = static_cast<bf16*>(a.dq);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = wr0 + gid + 8 * i;
    if (r >= nrows) continue;
    bf16* dst = dqo + (((size_t)b * a.S + r / G) * a.Hq + hk * G + r % G) * D +
                2 * tig;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<uint32_t*>(dst + n * 8) =
          pack_bf16(dq[n][2 * i] * a.scale, dq[n][2 * i + 1] * a.scale);
  }
}

// dK, dV of one split of a 64-key tile of (lane b, kv head hk): the row
// tiles [split[1], split[2]) of key tile split[0].
template <int D>
__global__ void __launch_bounds__(kTbKvWarps * 32, 1)
    flash_bwd_dkdv_mma_kernel(BwdArgs a) {
  using bf16 = __nv_bfloat16;
  constexpr int LD = D + kTbPadE;
  constexpr int KD = D / 16;             // k16 steps over the head dim
  constexpr int DH = D / 2;              // accumulated columns per warp
  constexpr int NDH = DH / 8;            // n8 tiles of them
  constexpr int NT = kTbKvWarps * 32;
  constexpr int PT = kTbKeys * kTbPLD;   // one P^T / dS^T plane
  extern __shared__ __align__(16) unsigned char tb_smem[];
  bf16* ks = reinterpret_cast<bf16*>(tb_smem);   // [64][LD]
  bf16* vs = ks + kTbKeys * LD;                  // [64][LD]
  bf16* rows = vs + kTbKeys * LD;                // [2][Q, dO][64][LD]
  bf16* pt = rows + 4 * kTbRows * LD;            // [P hi, P lo, dS hi, dS lo][64][kTbPLD]
  float* stat = reinterpret_cast<float*>(pt + 4 * PT);   // [2][lse, delta][64]

  const int G = a.Hq / a.Hk;
  const int nrows = a.S * G;
  const int b = blockIdx.z, hk = blockIdx.y;
  const int* sp = a.split + 4 * blockIdx.x;
  const int k0 = sp[0] * kTbKeys, rt_lo = sp[1], rt_hi = sp[2];
  const bool alone = sp[3] == 1;   // the key tile's only split
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const int kg = warp >> 1, half = warp & 1;
  const int key_w = k0 + kg * 16;        // the warp's first key

  auto stage = [&](int rt, int st) {
    bf16* qs = rows + st * 2 * kTbRows * LD;
    const int r0 = rt * kTbRows;
    stage_rows<D, NT>(qs, qs + kTbRows * LD, a, b, hk, G, r0, nrows);
    if (threadIdx.x < kTbRows) {
      float* ls = stat + st * 2 * kTbRows + threadIdx.x;
      const int r = r0 + threadIdx.x;
      if (r < nrows) {
        const size_t ri = ((size_t)b * a.S + r / G) * a.Hq + hk * G + r % G;
        cp_async4(ls, a.lse + ri);
        cp_async4(ls + kTbRows, a.delta + ri);
      } else {
        ls[0] = -INFINITY;
        ls[kTbRows] = 0.f;
      }
    }
  };

  stage_keys<D, NT>(ks, vs, a, b, hk, k0, a.S - 1);
  stage(rt_lo, 0);
  cp_async_commit();

  const float c2 = a.scale * kLog2e;
  float dk[NDH][4], dv[NDH][4];
#pragma unroll
  for (int n = 0; n < NDH; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  for (int rt = rt_lo; rt < rt_hi; ++rt) {
    const int st = (rt - rt_lo) & 1;
    cp_async_wait<0>();   // row tile rt has landed, and no warp reads row
    __syncthreads();      // tile rt - 1's stage, P^T or dS^T any more
    if (rt + 1 < rt_hi) {
      stage(rt + 1, st ^ 1);
      cp_async_commit();
    }
    const bf16* qs = rows + st * 2 * kTbRows * LD;
    const bf16* gs = qs + kTbRows * LD;
    const float* lse_s = stat + st * 2 * kTbRows;
    const float* dl_s = lse_s + kTbRows;
    const int r0 = rt * kTbRows;

    // ---- S^T = K Q^T, dP^T = V dO^T: keys key_w.., rows 32 half..
    const int hr0 = r0 + 32 * half;
    const int h_hi = hr0 < nrows ? (min(hr0 + 32, nrows) - 1) / G : -1;
    float s[4][4], dp[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    if (key_w <= h_hi) {   // warp-uniform: some row of the half sees a key
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t ka[4], va[4];
        ldsm_x4(ka, a_frag_at(ks, LD, kg * 16, kk * 16, lane));
        ldsm_x4(va, a_frag_at(vs, LD, kg * 16, kk * 16, lane));
#pragma unroll
        for (int nb = 0; nb < 2; ++nb) {
          uint32_t qb[4], gb[4];
          ldsm_x4(qb, b_frag_at(qs, LD, 32 * half + nb * 16, kk * 16, lane));
          ldsm_x4(gb, b_frag_at(gs, LD, 32 * half + nb * 16, kk * 16, lane));
          mma_bf16(s[2 * nb], ka, qb[0], qb[1]);
          mma_bf16(s[2 * nb + 1], ka, qb[2], qb[3]);
          mma_bf16(dp[2 * nb], va, gb[0], gb[1]);
          mma_bf16(dp[2 * nb + 1], va, gb[2], gb[3]);
        }
      }
    }
    // P^T and dS^T: element e of n8 tile n is key key_w + gid + 8 (e >> 1),
    // row 32 half + 8 n + 2 tig + (e & 1); stored [key][row] as bf16 hi
    // and lo
#pragma unroll
    for (int n = 0; n < 4; ++n) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int rr = 32 * half + 8 * n + 2 * tig + c, r = r0 + rr;
        const float l = lse_s[rr];
        const int t = r < nrows && l != -INFINITY ? r / G : -1;
        const float l2 = l * kLog2e, dl = dl_s[rr];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int e = 2 * h + c;
          const float p = key_w + gid + 8 * h <= t
                              ? exp2f(fmaf(s[n][e], c2, -l2)) : 0.f;
          s[n][e] = p;
          dp[n][e] = p * (dp[n][e] - dl);
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int at = (kg * 16 + gid + 8 * h) * kTbPLD + 32 * half + 8 * n +
                       2 * tig;
        float r0p, r1p, r0s, r1s;
        *reinterpret_cast<uint32_t*>(pt + at) =
            pack_bf16(s[n][2 * h], s[n][2 * h + 1], r0p, r1p);
        *reinterpret_cast<uint32_t*>(pt + PT + at) = pack_bf16(r0p, r1p);
        *reinterpret_cast<uint32_t*>(pt + 2 * PT + at) =
            pack_bf16(dp[n][2 * h], dp[n][2 * h + 1], r0s, r1s);
        *reinterpret_cast<uint32_t*>(pt + 3 * PT + at) = pack_bf16(r0s, r1s);
      }
    }
    __syncthreads();

    // ---- dV += P^T dO, dK += dS^T Q: keys key_w.., columns DH half..
#pragma unroll
    for (int kk = 0; kk < kTbRows / 16; ++kk) {
      uint32_t ph[4], pl[4], sh[4], sl[4];
      const bf16* at = a_frag_at(pt, kTbPLD, kg * 16, kk * 16, lane);
      ldsm_x4(ph, at);
      ldsm_x4(pl, at + PT);
      ldsm_x4(sh, at + 2 * PT);
      ldsm_x4(sl, at + 3 * PT);
#pragma unroll
      for (int dn = 0; dn < NDH / 2; ++dn) {
        uint32_t gb[4], qb[4];
        ldsm_x4_trans(gb, bt_frag_at(gs, LD, kk * 16, DH * half + dn * 16, lane));
        ldsm_x4_trans(qb, bt_frag_at(qs, LD, kk * 16, DH * half + dn * 16, lane));
        // hi halves, then lo halves: four independent sums between two
        // products into one accumulator
        mma_bf16(dv[2 * dn], ph, gb[0], gb[1]);
        mma_bf16(dv[2 * dn + 1], ph, gb[2], gb[3]);
        mma_bf16(dk[2 * dn], sh, qb[0], qb[1]);
        mma_bf16(dk[2 * dn + 1], sh, qb[2], qb[3]);
        mma_bf16(dv[2 * dn], pl, gb[0], gb[1]);
        mma_bf16(dv[2 * dn + 1], pl, gb[2], gb[3]);
        mma_bf16(dk[2 * dn], sl, qb[0], qb[1]);
        mma_bf16(dk[2 * dn + 1], sl, qb[2], qb[3]);
      }
    }
  }

  // ---- out: straight to dk, dv when the split is its key tile's only
  // one, else the partial sums to the scratch slot of this split
  bf16* dko = static_cast<bf16*>(a.dk);
  bf16* dvo = static_cast<bf16*>(a.dv);
  float* wk = alone ? nullptr
                    : a.ws + (((size_t)b * a.Hk + hk) * a.n_split + blockIdx.x) *
                                 2 * kTbKeys * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int kr = kg * 16 + gid + 8 * h, key = k0 + kr;
#pragma unroll
    for (int n = 0; n < NDH; ++n) {
      const int col = DH * half + 8 * n + 2 * tig;
      if (alone) {
        if (key >= a.S) continue;
        const size_t off = (((size_t)b * a.S + key) * a.Hk + hk) * D + col;
        *reinterpret_cast<uint32_t*>(dko + off) =
            pack_bf16(dk[n][2 * h] * a.scale, dk[n][2 * h + 1] * a.scale);
        *reinterpret_cast<uint32_t*>(dvo + off) =
            pack_bf16(dv[n][2 * h], dv[n][2 * h + 1]);
      } else {
        float* w = wk + kr * D + col;
        *reinterpret_cast<float2*>(w) = make_float2(dk[n][2 * h], dk[n][2 * h + 1]);
        *reinterpret_cast<float2*>(w + kTbKeys * D) =
            make_float2(dv[n][2 * h], dv[n][2 * h + 1]);
      }
    }
  }
}

// dK, dV of each key tile with several splits: the partial sums added
// in split order, dK scaled, each rounded once.  One thread per four
// elements of the tile's [dK, dV][64 keys][D], reduce_blocks<D>() blocks
// per key tile, so every thread's loads of the splits are independent.
template <int D>
__host__ __device__ constexpr int reduce_blocks() {
  return 2 * kTbKeys * D / 4 / kTbRedThreads;
}

template <int D>
__global__ void __launch_bounds__(kTbRedThreads)
    flash_bwd_reduce_kernel(BwdArgs a) {
  using bf16 = __nv_bfloat16;
  constexpr int kPlane = kTbKeys * D;     // one partial dK or dV
  static_assert(reduce_blocks<D>() * kTbRedThreads * 4 == 2 * kPlane,
                "one float4 per thread");
  const int jt = blockIdx.x / reduce_blocks<D>();
  const int first = a.ktile[2 * jt], n = a.ktile[2 * jt + 1];
  const int e = 4 * ((blockIdx.x % reduce_blocks<D>()) * kTbRedThreads +
                     threadIdx.x);       // [dK, dV][key][col]
  const int which = e / kPlane, kr = (e % kPlane) / D, col = e % D;
  const int b = blockIdx.z, hk = blockIdx.y, key = jt * kTbKeys + kr;
  if (n < 2 || key >= a.S) return;
  const float* p = a.ws +
                   (((size_t)b * a.Hk + hk) * a.n_split + first) * 2 * kPlane + e;
  float4 acc = *reinterpret_cast<const float4*>(p);
#pragma unroll 8
  for (int s = 1; s < n; ++s) {
    const float4 x = *reinterpret_cast<const float4*>(p + (size_t)s * 2 * kPlane);
    acc.x += x.x;
    acc.y += x.y;
    acc.z += x.z;
    acc.w += x.w;
  }
  const float f = which == 0 ? a.scale : 1.f;
  uint2 out;
  out.x = pack_bf16(acc.x * f, acc.y * f);
  out.y = pack_bf16(acc.z * f, acc.w * f);
  bf16* dst = static_cast<bf16*>(which == 0 ? a.dk : a.dv);
  *reinterpret_cast<uint2*>(dst + (((size_t)b * a.S + key) * a.Hk + hk) * D +
                            col) = out;
}

template <int D>
int launch_bwd_mma(const BwdArgs& a, cudaStream_t st) {
  const int n_kt = (a.S + kTbKeys - 1) / kTbKeys;
  // a table of at least one split per key tile; the scratch wherever a
  // key tile has several (n_split above n_kt)
  if (a.split == nullptr || a.ktile == nullptr || a.n_split < n_kt ||
      (a.ws == nullptr && a.n_split > n_kt))
    return (int)cudaErrorInvalidValue;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  constexpr int q_bytes = dq_mma_smem_bytes<D>();
  constexpr int kv_bytes = dkdv_mma_smem_bytes<D>();
  if (q_bytes > optin || kv_bytes > optin)
    return (int)cudaErrorInvalidConfiguration;
  const int nrows = a.S * (a.Hq / a.Hk);

  err = cudaFuncSetAttribute(flash_bwd_dq_mma_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, q_bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 gq((nrows + kTbRows - 1) / kTbRows, a.Hk, a.B);
  flash_bwd_dq_mma_kernel<D><<<gq, kTbQWarps * 32, q_bytes, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  err = cudaFuncSetAttribute(flash_bwd_dkdv_mma_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kv_bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 gkv(a.n_split, a.Hk, a.B);
  flash_bwd_dkdv_mma_kernel<D><<<gkv, kTbKvWarps * 32, kv_bytes, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.ws == nullptr) return (int)err;

  const dim3 gr(n_kt * reduce_blocks<D>(), a.Hk, a.B);
  flash_bwd_reduce_kernel<D><<<gr, kTbRedThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace repro

// The bfloat16 kernels' tiles: out[0] = rows per row tile (kTbRows),
// out[1] = keys per key tile (kTbKeys).
extern "C" int repro_flash_attn_bwd_tile(int* out) {
  out[0] = repro::kTbRows;
  out[1] = repro::kTbKeys;
  return 0;
}

// dtype: 0 = float32, 1 = bfloat16.  split, ktile, ws and n_split are
// the bfloat16 path's (kernels/flash_attn/ops.py bwd_schedule; ws null
// when no key tile has two splits) and are ignored for float32.  Returns
// a cudaError_t as int: cudaErrorInvalidValue for shapes, dtypes or head
// dims it does not take, and for a split table without the scratch it
// needs.
extern "C" int repro_flash_attn_bwd(const void* q, const void* k,
                                    const void* v, const void* o,
                                    const void* dout, const float* lse,
                                    float* delta, void* dq, void* dk,
                                    void* dv, const int* split,
                                    const int* ktile, float* ws, int B, int S,
                                    int Hq, int Hk, int D, int n_split,
                                    int dtype, void* stream) {
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
  a.split = split;
  a.ktile = ktile;
  a.ws = ws;
  a.n_split = n_split;
  a.B = B;
  a.S = S;
  a.Hq = Hq;
  a.Hk = Hk;
  a.scale = 1.0f / sqrtf((float)D);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (D == 32) return repro::launch_bwd_fma<32>(a, st);
    if (D == 64) return repro::launch_bwd_fma<64>(a, st);
    if (D == 128) return repro::launch_bwd_fma<128>(a, st);
  } else if (dtype == 1) {
    if (D == 32) return repro::launch_bwd_mma<32>(a, st);
    if (D == 64) return repro::launch_bwd_mma<64>(a, st);
    if (D == 128) return repro::launch_bwd_mma<128>(a, st);
  }
  return (int)cudaErrorInvalidValue;
}
