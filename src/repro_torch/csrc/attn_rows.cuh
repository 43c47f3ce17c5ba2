// Shared device code of the attention kernels, and their FMA loop: the
// float32 path of every attention kernel (verify_attn.cu, its paged twin
// verify_attn_paged.cu, flash_attn.cu, flash_attn_paged.cu) and the
// verify's bfloat16 path at head_dim 32 and 64.  Their bfloat16 paths at
// the served shapes (the prefill at every head dim, the verify at
// head_dim 128) run the tensor-core loop of prefill_rows.cuh, which
// shares AttnArgs, kv_row and the tree helpers below.  Masked GQA
// attention over one lane's KV rows with an fp32 online softmax.
//
// K/V addressing is a compile-time policy (the Paged template flag), and
// so is the tree mode (the Tree flag, below):
//   dense: lane b's key kp is row (b*S + kp)*Hk + hk of a (B, S, Hk, D)
//          cache;
//   paged: it is slot kp % P of page tbl[b*n_tbl + kp/P] of a
//          (NP + 1, P, Hk, D) pool, row (page*P + kp % P)*Hk + hk.
// Each thread looks the page up once for each key row it loads; P need
// not divide the 32-key tile.  Only keys inside the block's key range
// are loaded, so table entries (and the trash page) past a lane's last
// visible key are never read.  The tile order and the arithmetic do not
// depend on the policy: a paged call returns, bit for bit, what the
// dense kernel returns on the gathered view gather_view(pool, tbl).
//
// Work split.  One thread block per (row tile, kv head, lane).  The
// rows of a block are the kRows = 16 (query position t, query head g)
// pairs that share one kv head, t-major and g-minor, so the G = Hq / Hk
// heads of a kv head that fall in one block share each K/V tile it
// loads, and a causal block's key range ends at its last position.  At
// G >= 16 a block is a single query position, so a lane's K/V is read
// once per query position.  What bounds this loop is arithmetic: fp32
// FMA from shared memory at most 67 TFLOP/s on an H100, and those
// re-reads.  It stays for float32, whose sums hold the CPU sweeps' 2e-5
// (TF32 tensor cores keep about 3 digits), and for the small head dims.
// Four warps, four rows per warp; keys are walked in tiles of 32, one key
// per lane for the scores, then one D/32-column slice per lane for P·V.
// The tiles are anchored at the lane's pad: tile j holds keys
// [pad + 32j, pad + 32j + 32), and a window starts the walk at the tile
// of this grid that holds the block's lowest visible key.  So a lane's
// visible keys meet the same lanes of the same tiles, and every row's
// sums run in the same order, whatever pad its prompt gets in a batch:
// a row's result does not depend on which prompts share its batch.
//
// Masking.  A row at position qpos sees key kpos iff
//   pad <= kpos < S, (!causal || kpos <= qpos), (!window || kpos > qpos - window).
// Tree mode (Tree = true, launched when tree_w > 0; decode only; the
// Pallas kernel's static tree=(W, g) of verify_attn/kernel.py:27
// _tree_mask): the T = W*g + 1
// rows at positions length + [0, T) are a flattened draft tree, slot 0
// the root and slot 1 + r*g + (j-1) branch r's depth-j node.  Row qi
// sees the committed keys pad <= kpos < length and the in-block slot
// ks = kpos - length iff ks == 0, or qi > 0, ks > 0, both in one branch
// ((ks-1)/g == (qi-1)/g) and (ks-1)%g <= (qi-1)%g.  The window compares
// logical positions, length + depth (depth 0 at the root, (s-1)%g + 1
// at slot s), not slots.  An ancestor's slot is never above its
// descendant's and a slot's depth is never above the slot, so the
// chain's causal upper key bound stays exact, and a lower bound from the
// smallest depth in the block skips no key a row of it can see.  The
// visibility is index arithmetic: no mask crosses into the kernel.  The
// chain instantiation (Tree = false) holds none of this code.
// Keys outside the block's key range are never read (their shared-memory
// slots hold zeros), and inside it a masked key is skipped, never
// weighted by zero: its score is replaced by -inf before the softmax and
// its V row is not touched when its weight is 0, so a non-finite value
// stored at a masked position can never reach the output.  A row with no
// visible key writes zeros.
//
// Precision.  Scores, the running max/sum and the P·V accumulator are
// fp32; P stays fp32 (the JAX reference rounds P to the storage dtype
// before P·V; the difference is inside the bf16 tolerance).  No atomics:
// the result is the same from run to run.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace repro {

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 4;
constexpr int kRows = kWarps * kRowsPerWarp;
constexpr int kTile = 32;

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 16-byte vectors: 4 floats or 8 bf16 per load.
template <typename T> struct Vec16;
template <> struct Vec16<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void unpack(const uint4& r, float* o) {
    const float* f = reinterpret_cast<const float*>(&r);
#pragma unroll
    for (int e = 0; e < 4; ++e) o[e] = f[e];
  }
};
template <> struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void unpack(const uint4& r, float* o) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(h[e]);
      o[2 * e] = f.x;
      o[2 * e + 1] = f.y;
    }
  }
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

struct AttnArgs {
  const void* q;     // (B, T, Hq, D)
  const void* k;     // (B, S, Hk, D)
  const void* v;     // (B, S, Hk, D)
  void* o;           // (B, T, Hq, D)
  const int* qoff;   // (B,) position of query 0, or nullptr for 0
  const int* pad;    // (B,) first visible key, or nullptr for 0
  int B, T, S, Hq, Hk;
  int causal, window;
  float scale;
  // paged only (last but for the tree fields, so the dense chain
  // kernel's parameter offsets, and with them its machine code, are
  // those of the dense-only version)
  const int* tbl;    // (B, n_tbl) page ids
  int n_tbl, page;   // table width, page size P
  // tree mode: tree_w branches of depth tree_g, T = tree_w*tree_g + 1
  // (0, 0: the chain)
  int tree_w = 0, tree_g = 0;
  // (B, T, Hq) float32: each row's log-sum-exp of its scaled scores (-inf
  // for a row that sees no key), which the training forward hands to the
  // backward (flash_attn_bwd.cu); nullptr, as every serving launch leaves
  // it, stores nothing and changes no output bit
  float* lse = nullptr;
};

// Logical depth of block slot s of a tree of depth g.
__device__ __forceinline__ int tree_depth(int s, int g) {
  return s == 0 ? 0 : (s - 1) % g + 1;
}

// Smallest logical depth of the block slots s0 <= s <= s1: depth grows
// along a branch, so it is s0's unless the range reaches the root or
// crosses into a later branch (whose first slot has depth 1).
__device__ __forceinline__ int tree_min_depth(int s0, int s1, int g) {
  if (s0 == 0) return 0;
  return (s0 - 1) / g != (s1 - 1) / g ? 1 : tree_depth(s0, g);
}

// Tree mode: whether the row of slot qi sees key kp (the block's tree
// starts at position qoff = length).  Committed keys pad <= kp < length
// and the in-block ancestors of qi (the root, and qi's branch up to its
// depth) are visible; the window compares logical positions.
__device__ __forceinline__ bool tree_visible(const AttnArgs& a, int qoff,
                                             int pad, int kp, int qi) {
  const int g = a.tree_g;
  const int qlog = qoff + tree_depth(qi, g);
  if (kp < qoff) return kp >= pad && (a.window <= 0 || kp > qlog - a.window);
  const int ks = kp - qoff;
  if (ks >= a.T) return false;
  const bool anc = ks == 0 || (qi > 0 && (ks - 1) / g == (qi - 1) / g &&
                               (ks - 1) % g <= (qi - 1) % g);
  return anc && (a.window <= 0 || qoff + tree_depth(ks, g) > qlog - a.window);
}

// Row (in units of D elements) of lane b's key kp for kv head hk.
template <bool Paged>
__device__ __forceinline__ size_t kv_row(const AttnArgs& a, int b, int kp,
                                         int hk) {
  if constexpr (Paged) {
    const int pg = __ldg(a.tbl + (size_t)b * a.n_tbl + kp / a.page);
    return ((size_t)pg * a.page + kp % a.page) * a.Hk + hk;
  } else {
    return ((size_t)b * a.S + kp) * a.Hk + hk;
  }
}

template <typename T, int D, bool Paged, bool Tree>
__global__ void __launch_bounds__(kWarps * 32) attn_rows_kernel(AttnArgs a) {
  constexpr int C = D / 32;
  const int G = a.Hq / a.Hk;
  const int nrows = a.T * G;
  const int b = blockIdx.z, hk = blockIdx.y;
  const int row0 = blockIdx.x * kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  __shared__ __align__(16) float qs[kRows][D];
  __shared__ float ks[D][kTile + 1];
  __shared__ float vs[kTile][D];

  const T* q = static_cast<const T*>(a.q);
  const T* kc = static_cast<const T*>(a.k);
  const T* vc = static_cast<const T*>(a.v);
  T* o = static_cast<T*>(a.o);
  const int qoff = a.qoff ? a.qoff[b] : 0;
  const int pad = a.pad ? a.pad[b] : 0;

  // Loads are 16-byte vectors with a compile-time trip count, so each
  // thread issues all its loads of a tile before it waits on any.
  constexpr int VN = Vec16<T>::N;
  constexpr int kThreads = kWarps * 32;
  constexpr int kQVec = kRows * D / VN;      // 16-byte vectors per Q tile
  constexpr int kKVVec = kTile * D / VN;     // ... per K (or V) tile
  constexpr int kQLoads = (kQVec + kThreads - 1) / kThreads;
  constexpr int kKVLoads = (kKVVec + kThreads - 1) / kThreads;
  static_assert(D % VN == 0, "head_dim must be a multiple of 16 bytes");

  {
    uint4 raw[kQLoads];
#pragma unroll
    for (int u = 0; u < kQLoads; ++u) {
      const int vi = threadIdx.x + u * kThreads;
      const int e0 = vi * VN;
      const int rr = e0 / D, d0 = e0 % D, r = row0 + rr;
      raw[u] = make_uint4(0, 0, 0, 0);
      if (vi < kQVec && r < nrows) {
        const int t = r / G, h = hk * G + r % G;
        raw[u] = *reinterpret_cast<const uint4*>(
            q + (((size_t)b * a.T + t) * a.Hq + h) * D + d0);
      }
    }
#pragma unroll
    for (int u = 0; u < kQLoads; ++u) {
      const int vi = threadIdx.x + u * kThreads;
      if (vi < kQVec) {
        const int e0 = vi * VN;
        Vec16<T>::unpack(raw[u], &qs[e0 / D][e0 % D]);
      }
    }
  }

  // key range any row of this block can see
  const int last = min(row0 + kRows, nrows) - 1;
  int qp_lo = qoff + row0 / G;
  const int qp_hi = qoff + last / G;
  int kv_lo = max(pad, 0);
  if constexpr (Tree) {
    // the lowest logical position is length + the smallest depth of the
    // block's slots, and the in-block keys are visible whatever the pad
    qp_lo = qoff + tree_min_depth(row0 / G, last / G, a.tree_g);
    kv_lo = max(min(pad, qoff), 0);
  }
  if (a.window > 0) kv_lo = max(kv_lo, qp_lo - a.window + 1);
  const int kv_hi = a.causal ? min(a.S - 1, qp_hi) : a.S - 1;
  // key tiles start at the lane's pad (the tree's in-block keys below
  // it start at kv_lo), so a lane's keys fall in the same tiles, and its
  // sums in the same order, wherever its prompt sits in the batch
  const int anchor = min(max(pad, 0), kv_lo);
  const int k_first = anchor + ((kv_lo - anchor) / kTile) * kTile;

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][C];
  int qpos[kRowsPerWarp];
  bool live[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = row0 + warp * kRowsPerWarp + i;
    live[i] = r < nrows;
    // a tree row keeps its slot here (tree_visible makes its position)
    qpos[i] = Tree ? r / G : qoff + r / G;
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = k_first; k0 <= kv_hi; k0 += kTile) {
    uint4 kraw[kKVLoads], vraw[kKVLoads];
#pragma unroll
    for (int u = 0; u < kKVLoads; ++u) {
      const int vi = threadIdx.x + u * kThreads;
      const int e0 = vi * VN;
      const int kp = k0 + e0 / D;
      kraw[u] = vraw[u] = make_uint4(0, 0, 0, 0);
      if (vi < kKVVec && kp >= kv_lo && kp <= kv_hi) {
        const size_t off = kv_row<Paged>(a, b, kp, hk) * D + e0 % D;
        kraw[u] = *reinterpret_cast<const uint4*>(kc + off);
        vraw[u] = *reinterpret_cast<const uint4*>(vc + off);
      }
    }
    __syncthreads();   // the previous tile is no longer read
#pragma unroll
    for (int u = 0; u < kKVLoads; ++u) {
      const int vi = threadIdx.x + u * kThreads;
      if (vi >= kKVVec) continue;
      const int e0 = vi * VN;
      const int j = e0 / D, d0 = e0 % D;
      float kx[VN];
      Vec16<T>::unpack(kraw[u], kx);
      Vec16<T>::unpack(vraw[u], &vs[j][d0]);
#pragma unroll
      for (int e = 0; e < VN; ++e) ks[d0 + e][j] = kx[e];
    }
    __syncthreads();

    float s[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) s[i] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      const float k_0 = ks[d][lane], k_1 = ks[d + 1][lane];
      const float k_2 = ks[d + 2][lane], k_3 = ks[d + 3][lane];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float4 qv = *reinterpret_cast<const float4*>(&qs[warp * kRowsPerWarp + i][d]);
        s[i] += qv.x * k_0 + qv.y * k_1 + qv.z * k_2 + qv.w * k_3;
      }
    }

    const int kp = k0 + lane;
    float p[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      bool vis;
      if constexpr (Tree) {
        vis = live[i] && kp >= kv_lo && kp <= kv_hi &&
              tree_visible(a, qoff, pad, kp, qpos[i]);
      } else {
        vis = live[i] && kp >= kv_lo && kp <= kv_hi &&
              (!a.causal || kp <= qpos[i]) &&
              (a.window <= 0 || kp > qpos[i] - a.window);
      }
      const float sc = vis ? s[i] * a.scale : -INFINITY;
      const float m_new = fmaxf(m[i], warp_max(sc));
      p[i] = 0.f;
      if (m_new == -INFINITY) continue;   // nothing visible yet (warp-uniform)
      p[i] = vis ? expf(sc - m_new) : 0.f;
      const float alpha = (m[i] == -INFINITY) ? 0.f : expf(m[i] - m_new);
      l[i] = l[i] * alpha + warp_sum(p[i]);
#pragma unroll
      for (int c = 0; c < C; ++c) acc[i][c] *= alpha;
      m[i] = m_new;
    }

    for (int j = 0; j < kTile; ++j) {
      float vv[C];
#pragma unroll
      for (int c = 0; c < C; ++c) vv[c] = vs[j][lane + 32 * c];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float pj = __shfl_sync(0xffffffffu, p[i], j);
        if (pj > 0.f) {   // warp-uniform: masked keys are skipped
#pragma unroll
          for (int c = 0; c < C; ++c) acc[i][c] += pj * vv[c];
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    if (!live[i]) continue;
    const int r = row0 + warp * kRowsPerWarp + i;
    const int t = r / G, h = hk * G + r % G;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
    T* dst = o + (((size_t)b * a.T + t) * a.Hq + h) * D;
#pragma unroll
    for (int c = 0; c < C; ++c) dst[lane + 32 * c] = from_f<T>(acc[i][c] * inv);
    // m is in scaled units here: the row's LSE is m + log(l)
    if (a.lse != nullptr && lane == 0)
      a.lse[((size_t)b * a.T + t) * a.Hq + h] =
          l[i] > 0.f ? m[i] + logf(l[i]) : -INFINITY;
  }
}

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t as int.
// Tree = true is the tree mode (tree_w > 0), false the chain (tree_w 0).
template <bool Paged, bool Tree = false>
inline int launch_attn_rows(const AttnArgs& a, int head_dim, int dtype,
                            cudaStream_t stream) {
  if (a.Hk <= 0 || a.Hq % a.Hk != 0 || a.T <= 0 || a.B <= 0) return (int)cudaErrorInvalidValue;
  if (Paged && (a.tbl == nullptr || a.page <= 0 || a.n_tbl <= 0 ||
                a.S > a.n_tbl * a.page))
    return (int)cudaErrorInvalidValue;
  if (Tree ? (a.tree_w <= 0 || a.tree_g <= 0 || !a.causal ||
              a.qoff == nullptr || a.T != a.tree_w * a.tree_g + 1)
           : (a.tree_w != 0 || a.tree_g != 0))
    return (int)cudaErrorInvalidValue;
  const int nrows = a.T * (a.Hq / a.Hk);
  const dim3 grid((nrows + kRows - 1) / kRows, a.Hk, a.B);
  const dim3 block(kWarps * 32);
#define REPRO_ATTN_CASE(DT, DD)                                         \
  attn_rows_kernel<DT, DD, Paged, Tree><<<grid, block, 0, stream>>>(a);              \
  return (int)cudaGetLastError();
  if (dtype == 0) {
    if (head_dim == 32) { REPRO_ATTN_CASE(float, 32) }
    if (head_dim == 64) { REPRO_ATTN_CASE(float, 64) }
    if (head_dim == 128) { REPRO_ATTN_CASE(float, 128) }
  } else if (dtype == 1) {
    if (head_dim == 32) { REPRO_ATTN_CASE(__nv_bfloat16, 32) }
    if (head_dim == 64) { REPRO_ATTN_CASE(__nv_bfloat16, 64) }
    if (head_dim == 128) { REPRO_ATTN_CASE(__nv_bfloat16, 128) }
  }
#undef REPRO_ATTN_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace repro
