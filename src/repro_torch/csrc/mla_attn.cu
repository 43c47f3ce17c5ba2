// Latent-space decode attention of multi-head latent attention (MLA), for
// Hopper (sm_90a), on tensor cores.
//
// Replaces the attention core of the absorbed MLA decode,
// src/repro/models/mla.py:133-142 (jnp there, no Pallas kernel): it is the
// counterpart, at MLA's latent shapes, of the verify kernel
// (src/repro/kernels/verify_attn/kernel.py:214, csrc/verify_attn.cu).
// q_lat (B, T, H, R) holds the queries with W_uk absorbed and q_rope
// (B, T, H, Dr) their RoPE part, for T new tokens at cache positions
// lengths[b] + [0, T); the latent cache ckv (B, Smax, R) and kr (B, Smax,
// Dr) already holds the new block.  Every head attends the same latent
// rows: the keys are [ckv ‖ kr] (R + Dr = 576 wide), the values ckv
// itself (R = 512 wide), so this is multi-query attention with 128 query
// heads per key.  Row t of lane b sees kpos in [pad[b], lengths[b] + t];
// the scores are scaled by `scale` (1/sqrt(qk_nope + qk_rope), MLA's, not
// 1/sqrt(576)); a row with no visible key writes zeros.  The output
// o_lat (B, T, H, R) is bfloat16; W_uv is applied after it, outside.
//
// What bounds it on an H100.  Each latent key row feeds every (t, head)
// row of its lane: 2 * (576 + 512) flops per row and key against 1 152
// bytes per key, so at B 8, T 4 (the verify) and a cache of ~1024 keys
// the least work is ~9.1 GFLOP against ~9.4 MB: 9.2 us at the 989
// TFLOP/s bf16 tensor-core peak, the operations bound it (an FMA loop
// would be ~15x slower).  So the products are mma.sync.m16n8k16 in bf16
// with fp32 accumulation, and each key tile is read once by a block and
// used twice: as K (all 576 columns) and as V (its first 512).
//
// Work split.  A block is four warps over 64 rows, a row a (position t,
// head h) pair of one lane, t-major (at 128 heads a tile is half the
// heads of one position; a warp's 16 rows are always one position), and
// over kMlCols = 256 of the 512 value columns: grid (row tiles, 2, B),
// row tiles issued last first (a later position walks more keys).  The
// two column blocks of a row tile compute the same scores and softmax
// (the same keys in the same order, so the same bits) and each writes
// its half of the output.  Registers hold 256 columns of fp32 output a
// row (128 a thread); 512 would need 256 a thread.
//
// Staging.  The Q tile, 64 rows of [q_lat ‖ q_rope] (576 + 8 padding
// elements a row, so the eight 16-byte rows of an ldmatrix fall in eight
// bank groups), goes to shared memory once through cp.async; its
// fragments are read (ldmatrix) for every key tile, since 36 k16 steps
// of them would not fit in registers beside the output.  Key tiles of
// kMlKeys = 64 latent rows [ckv ‖ kr] follow through cp.async, double
// buffered.  (64 + 2 * 64) * 584 * 2 = 224 256 bytes of dynamic shared
// memory, under the card's 227 KB opt-in limit: one block per SM.
//
// Key walk, as prefill_rows.cuh's: tiles are anchored at the lane's pad
// (tile j holds keys [pad + 64j, pad + 64j + 64)) from the pad to the
// block's last visible key; keys outside [pad, kv_hi] are never loaded
// (their slots are zeros); a warp skips a tile in which none of its rows
// sees a key.  The online softmax (max, sum, rescale) is fp32 in
// registers; P enters P·V as two bfloat16 halves (P_hi + P_lo), as in
// prefill_rows.cuh, so P keeps 16 significant bits.
//
// Pad invariance.  A row's scores, tile maxima, sums and P·V run over
// the same keys in the same order wherever its lane sits in the batch
// and whatever the other lanes hold: the tiles are anchored at the pad,
// and the row tile a row lands in changes only which tiles past the
// row's last key it walks (P = 0 there, alpha = 1).  No atomics: two
// runs give the same bits.
//
// Left for a later design: wgmma with TMA loads (the full tensor-core
// rate), a split over keys for the T = 1 decode (2 row tiles a lane), and
// one score pass shared by the two column blocks (P through shared
// memory).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "tc_bf16.cuh"

namespace repro {
namespace {

constexpr int kMlR = 512;                 // latent width: V, K's first part
constexpr int kMlDr = 64;                 // RoPE width: K's last part
constexpr int kMlK = kMlR + kMlDr;        // key width, 576
constexpr int kMlWarps = 4;
constexpr int kMlRows = 16 * kMlWarps;    // rows a block, 16 a warp
constexpr int kMlKeys = 64;               // keys a tile
constexpr int kMlCols = 256;              // value columns a block
constexpr int kMlLD = kMlK + 8;           // shared row stride, elements
constexpr int kMlCh = kMlK / 8;           // 16-byte chunks a row, 72
constexpr int kMlChR = kMlR / 8;          // ... of them from ckv / q_lat
constexpr int kMlThreads = kMlWarps * 32;
constexpr int kMlSmem = (kMlRows + 2 * kMlKeys) * kMlLD * 2;
static_assert(kMlRows * kMlCh % kMlThreads == 0 &&
                  kMlKeys * kMlCh % kMlThreads == 0,
              "tile loads split evenly over the threads");
static_assert(kMlR % kMlCols == 0 && kMlCols % 16 == 0, "column blocks");

struct MlaArgs {
  const __nv_bfloat16* q_lat;   // (B, T, H, R)
  const __nv_bfloat16* q_rope;  // (B, T, H, Dr)
  const __nv_bfloat16* ckv;     // (B, S, R)
  const __nv_bfloat16* kr;      // (B, S, Dr)
  const int* lengths;           // (B,)
  const int* pad;               // (B,)
  __nv_bfloat16* o;             // (B, T, H, R)
  int B, T, S, H;
  float scale;
};

__global__ void __launch_bounds__(kMlThreads, 1) mla_rows_kernel(MlaArgs a) {
  using bf16 = __nv_bfloat16;
  constexpr int NK = kMlKeys / 8;         // n8 tiles over a key tile
  constexpr int KD = kMlK / 16;           // k16 steps over the key width
  constexpr int ND = kMlCols / 8;         // n8 tiles over the block's columns

  extern __shared__ __align__(16) unsigned char ml_smem[];
  bf16* qs = reinterpret_cast<bf16*>(ml_smem);     // [kMlRows][kMlLD]
  bf16* kvs = qs + kMlRows * kMlLD;                // [2][kMlKeys][kMlLD]

  const int nrows = a.T * a.H;
  const int b = blockIdx.z;
  const int c0 = blockIdx.y * kMlCols;
  const int row0 = (gridDim.x - 1 - blockIdx.x) * kMlRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const int pad = max(a.pad[b], 0);
  const int qoff = a.lengths[b];

  // ---- the Q tile [q_lat ‖ q_rope], once
#pragma unroll 4
  for (int u = 0; u < kMlRows * kMlCh / kMlThreads; ++u) {
    const int c = threadIdx.x + u * kMlThreads;
    const int rr = c / kMlCh, ch = c % kMlCh, r = row0 + rr;
    bf16* dst = qs + rr * kMlLD + ch * 8;
    if (r < nrows) {
      const size_t row = ((size_t)b * a.T + r / a.H) * a.H + r % a.H;
      cp_async16(dst, ch < kMlChR ? a.q_lat + row * kMlR + ch * 8
                                  : a.q_rope + row * kMlDr + (ch - kMlChR) * 8);
    } else {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    }
  }
  cp_async_commit();

  // ---- the block's keys: [pad, kv_hi], tiles anchored at the pad
  const int last = min(row0 + kMlRows, nrows) - 1;
  const int kv_lo = pad;
  const int kv_hi = min(a.S - 1, qoff + last / a.H);
  const int ntiles = kv_hi >= kv_lo ? (kv_hi - kv_lo) / kMlKeys + 1 : 0;

  // this thread's rows (gid, gid + 8 of its warp) and the keys each sees;
  // the warp's union decides which tiles it skips
  int hi[2];
  bool live[2];
  int w_lo = INT_MAX, w_hi = -1;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + warp * 16 + gid + 8 * i;
    live[i] = r < nrows;
    hi[i] = live[i] ? min(qoff + r / a.H, a.S - 1) : -1;
    if (hi[i] >= pad) {
      w_lo = min(w_lo, pad);
      w_hi = max(w_hi, hi[i]);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    w_lo = min(w_lo, __shfl_xor_sync(0xffffffffu, w_lo, off));
    w_hi = max(w_hi, __shfl_xor_sync(0xffffffffu, w_hi, off));
  }

  auto load_kv = [&](int j, int stage) {
    const int k0 = kv_lo + j * kMlKeys;
    bf16* ks = kvs + stage * kMlKeys * kMlLD;
#pragma unroll 4
    for (int u = 0; u < kMlKeys * kMlCh / kMlThreads; ++u) {
      const int c = threadIdx.x + u * kMlThreads;
      const int jj = c / kMlCh, ch = c % kMlCh, kp = k0 + jj;
      bf16* dst = ks + jj * kMlLD + ch * 8;
      if (kp <= kv_hi) {
        const size_t row = (size_t)b * a.S + kp;
        cp_async16(dst, ch < kMlChR ? a.ckv + row * kMlR + ch * 8
                                    : a.kr + row * kMlDr + (ch - kMlChR) * 8);
      } else {
        *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
      }
    }
  };

  const float c2 = a.scale * 1.4426950408889634f;   // scores to log2 units
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  if (ntiles > 0) load_kv(0, 0);
  cp_async_commit();
  for (int j = 0; j < ntiles; ++j) {
    if (j + 1 < ntiles) {
      load_kv(j + 1, (j + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int k0 = kv_lo + j * kMlKeys;
    if (k0 <= w_hi && k0 + kMlKeys - 1 >= w_lo) {   // warp-uniform
      const bf16* ks = kvs + (j & 1) * kMlKeys * kMlLD;

      // S = Q K^T over the 576 key columns: s[n] is keys 8n..8n+7
      float s[NK][4];
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll 4
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t qf[4];
        ldsm_x4(qf, qs + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kMlLD +
                        kk * 16 + ((lane >> 4) & 1) * 8);
#pragma unroll
        for (int nb = 0; nb < NK / 2; ++nb) {
          uint32_t kb[4];
          ldsm_x4(kb, ks + (nb * 16 + (lane & 7) + ((lane >> 4) & 1) * 8) * kMlLD +
                          kk * 16 + ((lane >> 3) & 1) * 8);
          mma_bf16(s[2 * nb], qf, kb[0], kb[1]);
          mma_bf16(s[2 * nb + 1], qf, kb[2], kb[3]);
        }
      }

      // online softmax, rows gid (elements 0, 1) and gid + 8 (2, 3)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = -INFINITY;
#pragma unroll
        for (int n = 0; n < NK; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int kp = k0 + n * 8 + 2 * tig + e;
            const bool vis = kp >= pad && kp <= hi[i];
            s[n][2 * i + e] = vis ? s[n][2 * i + e] : -INFINITY;
            mx = fmaxf(mx, s[n][2 * i + e]);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[i], mx);
        if (m_new == -INFINITY) {   // nothing visible yet: P = 0
#pragma unroll
          for (int n = 0; n < NK; ++n) s[n][2 * i] = s[n][2 * i + 1] = 0.f;
          continue;
        }
        const float alpha = m_new == m[i] ? 1.f
                            : m[i] == -INFINITY ? 0.f
                                                : exp2f((m[i] - m_new) * c2);
        const float mc = m_new * c2;
        float rs = 0.f;
#pragma unroll
        for (int n = 0; n < NK; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float x = s[n][2 * i + e];
            const float p = x == -INFINITY ? 0.f : exp2f(fmaf(x, c2, -mc));
            s[n][2 * i + e] = p;
            rs += p;
          }
        l[i] = l[i] * alpha + rs;
        m[i] = m_new;
#pragma unroll
        for (int n = 0; n < ND; ++n) {
          acc[n][2 * i] *= alpha;
          acc[n][2 * i + 1] *= alpha;
        }
      }

      // O += P V: V is the tile's columns [c0, c0 + kMlCols), P as
      // P_hi + P_lo
      const bf16* vs = ks + c0;
#pragma unroll
      for (int kk = 0; kk < NK / 2; ++kk) {
        uint32_t ph[4], pl[4];
        float r0, r1;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          // a0, a1 from keys 16kk..+7, a2, a3 from 16kk+8..+15
          const float* sf = s[2 * kk + h];
          ph[2 * h] = pack_bf16(sf[0], sf[1], r0, r1);
          pl[2 * h] = pack_bf16(r0, r1);
          ph[2 * h + 1] = pack_bf16(sf[2], sf[3], r0, r1);
          pl[2 * h + 1] = pack_bf16(r0, r1);
        }
#pragma unroll
        for (int dn = 0; dn < ND / 2; ++dn) {
          uint32_t vb[4];
          ldsm_x4_trans(vb, vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kMlLD +
                                dn * 16 + ((lane >> 4) & 1) * 8);
          mma_bf16(acc[2 * dn], ph, vb[0], vb[1]);
          mma_bf16(acc[2 * dn], pl, vb[0], vb[1]);
          mma_bf16(acc[2 * dn + 1], ph, vb[2], vb[3]);
          mma_bf16(acc[2 * dn + 1], pl, vb[2], vb[3]);
        }
      }
    }
    __syncthreads();   // the stage is no longer read
  }
  cp_async_wait<0>();

  // ---- out: the block's columns of each row once, bf16 pairs
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float lt = l[i];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    if (!live[i]) continue;
    const int r = row0 + warp * 16 + gid + 8 * i;
    const size_t row = ((size_t)b * a.T + r / a.H) * a.H + r % a.H;
    const float inv = lt > 0.f ? 1.f / lt : 0.f;
    bf16* dst = a.o + row * kMlR + c0 + 2 * tig;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<uint32_t*>(dst + n * 8) =
          pack_bf16(acc[n][2 * i] * inv, acc[n][2 * i + 1] * inv);
  }
}

}  // namespace
}  // namespace repro

// Returns a cudaError_t as int: cudaErrorInvalidValue for arguments the
// kernel does not take (R, Dr other than 512, 64; empty shapes),
// cudaErrorInvalidConfiguration when the card's opt-in shared memory per
// block is below the kernel's.
extern "C" int repro_mla_attn(const void* q_lat, const void* q_rope,
                              const void* ckv, const void* kr,
                              const int* lengths, const int* pad, void* out,
                              int B, int T, int Smax, int H, int R, int Dr,
                              float scale, void* stream) {
  using repro::kMlRows;
  if (R != repro::kMlR || Dr != repro::kMlDr || B <= 0 || T <= 0 ||
      Smax <= 0 || H <= 0 || lengths == nullptr || pad == nullptr)
    return (int)cudaErrorInvalidValue;
  repro::MlaArgs a;
  a.q_lat = static_cast<const __nv_bfloat16*>(q_lat);
  a.q_rope = static_cast<const __nv_bfloat16*>(q_rope);
  a.ckv = static_cast<const __nv_bfloat16*>(ckv);
  a.kr = static_cast<const __nv_bfloat16*>(kr);
  a.lengths = lengths;
  a.pad = pad;
  a.o = static_cast<__nv_bfloat16*>(out);
  a.B = B;
  a.T = T;
  a.S = Smax;
  a.H = H;
  a.scale = scale;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  if (repro::kMlSmem > optin) return (int)cudaErrorInvalidConfiguration;
  err = cudaFuncSetAttribute(repro::mla_rows_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             repro::kMlSmem);
  if (err != cudaSuccess) return (int)err;
  const long long nrows = (long long)T * H;
  const dim3 grid((unsigned)((nrows + kMlRows - 1) / kMlRows),
                  repro::kMlR / repro::kMlCols, B);
  repro::mla_rows_kernel<<<grid, repro::kMlThreads, repro::kMlSmem,
                           static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
