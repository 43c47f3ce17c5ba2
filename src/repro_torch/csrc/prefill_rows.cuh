// The bfloat16 attention loop for Hopper (sm_90a), on tensor cores:
// the prefill, launched by flash_attn.cu (dense K/V) and
// flash_attn_paged.cu (K/V through a block table), and the decode side at
// head_dim 128, launched by verify_attn.cu and verify_attn_paged.cu in
// chain and tree mode.  Their float32 paths (and the verify's bfloat16
// at head_dim 32 and 64) are the FMA loop of attn_rows.cuh.  What it
// computes is that loop's: q (B, T, Hq, D) at positions qoff[b] + [0, T)
// (qoff 0 and T = S for the prefill, lengths[b] for a verify); row b sees
// keys kpos with
//   pad[b] <= kpos < S, (!causal || kpos <= qpos), (!window || kpos > qpos - window),
// or, in tree mode, the tree visibility of attn_rows.cuh (tree_visible:
// the committed keys and the row's root path, the window on logical
// positions; here as per-row key ranges); a row with no visible key
// writes zeros.
//
// Work split.  One block of four warps per (row tile, kv head, lane).  A
// row tile is kPfRows = 64 (query position t, query head g) rows of one
// kv head, t-major and g-minor as in attn_rows.cuh, so at G = Hq / Hk =
// 16 (glm4-9b) it holds 4 positions, all 16 query heads of a kv head
// share every K/V tile it loads, and a warp's 16 rows are one position
// (its causal bound, and in tree mode its slot, is warp-uniform).  So a
// verify of T = 4 is one block per (lane, kv head), which reads the
// lane's K/V once (the FMA loop's blocks of one position read it T
// times); a tree of T = 13 is four row tiles, T = 1 one partly filled
// tile, and the draft's prompt seeding (T = 511) the prefill's shape.
// Blocks are issued last tile first: a causal tile's work grows with
// its position.  There is no split over keys: at B = 8 and 2 kv heads a
// T = 4 verify is 16 blocks on 132 SMs, each walking its lane's keys
// alone, and that, not the bytes, bounds the decode side.
//
// Staging.  The Q tile goes to shared memory once (cp.async) and into
// registers (ldmatrix) once.  K/V tiles of kPfKeys = 64 keys follow
// through cp.async, double-buffered: tile j + 1 loads while tile j is
// used.  Shared-memory rows are D + 8 elements long, so the eight 16-byte
// rows of an ldmatrix fall in eight different bank groups.  At D = 128
// that is (64 + 4 * 64) * 136 * 2 = 87,040 bytes of dynamic shared memory
// (two blocks per SM); launch_mma_rows refuses what the card's opt-in
// limit does not hold.
//
// Key walk.  Key tiles are anchored at the lane's pad, as in
// attn_rows.cuh: tile j holds keys [anchor + 64j, anchor + 64j + 64),
// anchor = min(pad, kv_lo), from the tile that holds the block's lowest
// visible key kv_lo (the pad, or higher under a window; in tree mode
// the in-block keys count whatever the pad) to the block's last visible
// position kv_hi.  Keys outside [kv_lo, kv_hi] are never loaded: their
// slots are zeros, so positions before the pad, and table entries (the
// trash page) past the block, are never read.  A warp skips a tile in
// which none of its rows sees a key.
//
// Products.  Both are mma.sync.aligned.m16n8k16, bfloat16 inputs and
// fp32 accumulation: S = Q·K^T takes K through ldmatrix, P·V takes V
// through ldmatrix.trans.  The online softmax (max, sum, rescale) is
// fp32 in registers, masked per element as above.  P enters P·V as two
// bfloat16 halves, P_hi = bf16(P) and P_lo = bf16(P - P_hi), two
// products into one fp32 accumulator.  P rounded to bfloat16 alone
// (8 significant bits) moves an output by about 2^-9 of its size when
// its weight is spread over many keys, so the whole tensor's relative
// L2 error lands near the 1e-3 that chip_smoke.py holds the kernel to
// (its kernels phase prints that error of a bf16-P emulation beside the
// kernel's); the pair keeps 16 bits of P.  The row sum is taken of the
// unrounded P.  No atomics: the result is the same from run to run.
//
// Pad invariance.  Per row, the scores, the tile-wise maxima and sums
// and the P·V accumulation run over the same keys in the same order
// wherever the lane's prompt sits in its batch: the tiles are anchored
// at the pad, and the block a row lands in changes only which tiles past
// the row's own last key it walks (P = 0 there, alpha = 1: the row's
// state stays as it was) and which slots past kv_hi are zeros.  The
// tree mode and the Paged policy change only the mask and kv_row, so a
// tree of W = 1 is the chain and a paged call is the dense kernel on
// the gathered view, bit for bit.
//
// Non-finite values.  A key outside the loaded range is never read (the
// pad, the trash page).  Inside it, a key above one row's visible range
// may be below another row's: its V row is loaded and multiplied by
// P = 0, and 0 * NaN is NaN, so a non-finite V stored there would reach
// that row.  The serving engine never stores one there: every key in
// [pad, kv_hi] is a prompt or cache key a layer has computed, and the
// caches are zero-initialised.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "attn_rows.cuh"
#include "tc_bf16.cuh"

namespace repro {

constexpr int kPfWarps = 4;
constexpr int kPfRows = 16 * kPfWarps;   // rows per block, 16 per warp
constexpr int kPfKeys = 64;              // keys per K/V tile
constexpr int kPfPadE = 8;               // row padding, elements

template <int D>
constexpr int prefill_smem_bytes() {
  return (kPfRows + 4 * kPfKeys) * (D + kPfPadE) * (int)sizeof(__nv_bfloat16);
}

template <int D, bool Paged, bool Tree>
__global__ void __launch_bounds__(kPfWarps * 32, 2) mma_rows_kernel(AttnArgs a) {
  using bf16 = __nv_bfloat16;
  constexpr int LD = D + kPfPadE;          // shared row stride, elements
  constexpr int CH = D / 8;                // 16-byte chunks per row
  constexpr int KD = D / 16;               // k16 steps over the head dim
  constexpr int ND = D / 8;                // n8 tiles over the head dim
  constexpr int NK = kPfKeys / 8;          // n8 tiles over a key tile
  constexpr int kThreads = kPfWarps * 32;
  constexpr int kLoads = kPfKeys * CH / kThreads;   // = kPfRows * CH / kThreads
  static_assert(kPfRows == kPfKeys && kLoads * kThreads == kPfKeys * CH,
                "one load loop shape serves the Q and the K/V tiles");
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");

  extern __shared__ __align__(16) unsigned char pf_smem[];
  bf16* qs = reinterpret_cast<bf16*>(pf_smem);     // [kPfRows][LD]
  bf16* kvs = qs + kPfRows * LD;                   // [2][K, V][kPfKeys][LD]

  const int G = a.Hq / a.Hk;
  const int nrows = a.T * G;
  const int b = blockIdx.z, hk = blockIdx.y;
  const int row0 = (gridDim.x - 1 - blockIdx.x) * kPfRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* kc = static_cast<const bf16*>(a.k);
  const bf16* vc = static_cast<const bf16*>(a.v);
  bf16* o = static_cast<bf16*>(a.o);
  const int pad = max(a.pad ? a.pad[b] : 0, 0);
  const int qoff = a.qoff ? a.qoff[b] : 0;

  // ---- the Q tile, once
#pragma unroll
  for (int u = 0; u < kLoads; ++u) {
    const int c = threadIdx.x + u * kThreads;
    const int rr = c / CH, d0 = (c % CH) * 8, r = row0 + rr;
    bf16* dst = qs + rr * LD + d0;
    if (r < nrows) {
      const int t = r / G, h = hk * G + r % G;
      cp_async16(dst, q + (((size_t)b * a.T + t) * a.Hq + h) * D + d0);
    } else {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    }
  }
  cp_async_commit();

  // ---- the block's key range, and the tiles anchored at the pad
  const int last = min(row0 + kPfRows, nrows) - 1;
  int qp_lo = qoff + row0 / G;
  const int qp_hi = qoff + last / G;
  int kv_lo = pad;
  if constexpr (Tree) {
    // the lowest logical position is length + the smallest depth of the
    // block's slots, and the in-block keys are visible whatever the pad
    qp_lo = qoff + tree_min_depth(row0 / G, last / G, a.tree_g);
    kv_lo = max(min(pad, qoff), 0);
  }
  if (a.window > 0) kv_lo = max(kv_lo, qp_lo - a.window + 1);
  const int kv_hi = a.causal ? min(a.S - 1, qp_hi) : a.S - 1;
  const int anchor = min(pad, kv_lo);
  const int k_first = anchor + ((kv_lo - anchor) / kPfKeys) * kPfKeys;
  const int ntiles = kv_hi >= kv_lo ? (kv_hi - k_first) / kPfKeys + 1 : 0;

  // ---- this thread's two rows (gid, gid + 8 of its warp) and the keys
  // each sees (in tree mode: bounds of them, refined per key by
  // the row's tree visibility); the warp's union decides which tiles it
  // skips.  tree_visible, made once per row here: a tree row at depth d
  // sees the committed keys [c_lo, qoff), the root (key qoff) unless the
  // window excludes it, and its branch's slots at depths up to d, keys
  // [b_lo, b_hi]; so the per-key test is compares only, with no
  // division by the tree depth
  int lo[2], hi[2], c_lo[2], b_lo[2], b_hi[2];
  bool root[2];
  bool live[2];
  int w_lo = INT_MAX, w_hi = -1;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + warp * 16 + gid + 8 * i;
    const int qpos = qoff + r / G;
    live[i] = r < nrows;
    if constexpr (Tree) {
      // an ancestor's slot is never above its descendant's
      lo[i] = kv_lo;
      hi[i] = min(qpos, a.S - 1);
      const int qi = r / G, g = a.tree_g;
      const int d = tree_depth(qi, g);
      const int base = qoff + 1 + (qi == 0 ? 0 : (qi - 1) / g) * g;
      c_lo[i] = a.window > 0 ? max(pad, qoff + d - a.window + 1) : pad;
      root[i] = a.window <= 0 || d < a.window;
      b_lo[i] = base + (a.window > 0 ? max(0, d - a.window) : 0);
      b_hi[i] = base + d - 1;   // below b_lo at the root: no branch key
    } else {
      lo[i] = pad;
      if (a.window > 0) lo[i] = max(lo[i], qpos - a.window + 1);
      hi[i] = a.causal ? min(qpos, a.S - 1) : a.S - 1;
    }
    if (!live[i]) hi[i] = -1;
    if (hi[i] >= lo[i]) {
      w_lo = min(w_lo, lo[i]);
      w_hi = max(w_hi, hi[i]);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    w_lo = min(w_lo, __shfl_xor_sync(0xffffffffu, w_lo, off));
    w_hi = max(w_hi, __shfl_xor_sync(0xffffffffu, w_hi, off));
  }

  auto load_kv = [&](int j, int stage) {
    const int k0 = k_first + j * kPfKeys;
    bf16* ks = kvs + stage * 2 * kPfKeys * LD;
    bf16* vs = ks + kPfKeys * LD;
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int c = threadIdx.x + u * kThreads;
      const int jj = c / CH, d0 = (c % CH) * 8, kp = k0 + jj;
      bf16* kd = ks + jj * LD + d0;
      bf16* vd = vs + jj * LD + d0;
      if (kp >= kv_lo && kp <= kv_hi) {
        const size_t off = kv_row<Paged>(a, b, kp, hk) * D + d0;
        cp_async16(kd, kc + off);
        cp_async16(vd, vc + off);
      } else {
        *reinterpret_cast<uint4*>(kd) = make_uint4(0, 0, 0, 0);
        *reinterpret_cast<uint4*>(vd) = make_uint4(0, 0, 0, 0);
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
  uint32_t qf[KD][4];

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
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
        ldsm_x4(qf[kk], qs + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                            kk * 16 + ((lane >> 4) & 1) * 8);
    }
    const int k0 = k_first + j * kPfKeys;
    if (k0 <= w_hi && k0 + kPfKeys - 1 >= w_lo) {   // warp-uniform
      const bf16* ks = kvs + (j & 1) * 2 * kPfKeys * LD;
      const bf16* vs = ks + kPfKeys * LD;

      // S = Q K^T: s[n] is keys 8n..8n+7 of the tile
      float s[NK][4];
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
        for (int nb = 0; nb < NK / 2; ++nb) {
          uint32_t kb[4];
          ldsm_x4(kb, ks + (nb * 16 + (lane & 7) + ((lane >> 4) & 1) * 8) * LD +
                          kk * 16 + ((lane >> 3) & 1) * 8);
          mma_bf16(s[2 * nb], qf[kk], kb[0], kb[1]);
          mma_bf16(s[2 * nb + 1], qf[kk], kb[2], kb[3]);
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
            bool vis = kp >= lo[i] && kp <= hi[i];
            if constexpr (Tree)
              vis = vis && (kp < qoff    ? kp >= c_lo[i]
                            : kp == qoff ? root[i]
                                         : kp >= b_lo[i] && kp <= b_hi[i]);
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

      // O += P V, P as P_hi + P_lo
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
          ldsm_x4_trans(vb, vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
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

  // ---- out: each row once, bf16 pairs
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float lt = l[i];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    if (!live[i]) continue;
    const int r = row0 + warp * 16 + gid + 8 * i;
    const int t = r / G, h = hk * G + r % G;
    const float inv = lt > 0.f ? 1.f / lt : 0.f;
    bf16* dst = o + (((size_t)b * a.T + t) * a.Hq + h) * D + 2 * tig;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<uint32_t*>(dst + n * 8) =
          pack_bf16(acc[n][2 * i] * inv, acc[n][2 * i + 1] * inv);
    // m is in unscaled score units here (P = 2^((s - m) * c2)): the row's
    // LSE of its scaled scores is m * scale + log(l)
    if (a.lse != nullptr && tig == 0)
      a.lse[((size_t)b * a.T + t) * a.Hq + h] =
          lt > 0.f ? m[i] * a.scale + logf(lt) : -INFINITY;
  }
}

// Launch the loop: Tree = true is the tree mode (tree_w > 0, decode
// only), false the chain.  Returns a cudaError_t as int:
// cudaErrorInvalidValue for arguments it does not take,
// cudaErrorInvalidConfiguration when the card's opt-in shared memory per
// block is below what the head dim needs.
template <bool Paged, bool Tree = false>
inline int launch_mma_rows(const AttnArgs& a, int head_dim,
                           cudaStream_t stream) {
  if (a.Hk <= 0 || a.Hq % a.Hk != 0 || a.T <= 0 || a.B <= 0)
    return (int)cudaErrorInvalidValue;
  if (Paged && (a.tbl == nullptr || a.page <= 0 || a.n_tbl <= 0 ||
                a.S > a.n_tbl * a.page))
    return (int)cudaErrorInvalidValue;
  if (Tree ? (a.tree_w <= 0 || a.tree_g <= 0 || !a.causal ||
              a.qoff == nullptr || a.T != a.tree_w * a.tree_g + 1)
           : (a.tree_w != 0 || a.tree_g != 0))
    return (int)cudaErrorInvalidValue;
  const int nrows = a.T * (a.Hq / a.Hk);
  const dim3 grid((nrows + kPfRows - 1) / kPfRows, a.Hk, a.B);
  const dim3 block(kPfWarps * 32);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
#define REPRO_MMA_CASE(DD)                                                      \
  {                                                                             \
    constexpr int bytes = prefill_smem_bytes<DD>();                             \
    if (bytes > optin) return (int)cudaErrorInvalidConfiguration;               \
    err = cudaFuncSetAttribute(mma_rows_kernel<DD, Paged, Tree>,                \
                               cudaFuncAttributeMaxDynamicSharedMemorySize,     \
                               bytes);                                          \
    if (err != cudaSuccess) return (int)err;                                    \
    mma_rows_kernel<DD, Paged, Tree><<<grid, block, bytes, stream>>>(a);        \
    return (int)cudaGetLastError();                                             \
  }
  if (head_dim == 32) REPRO_MMA_CASE(32)
  if (head_dim == 64) REPRO_MMA_CASE(64)
  if (head_dim == 128) REPRO_MMA_CASE(128)
#undef REPRO_MMA_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace repro
