// JAX's threefry-2x32 PRNG and its categorical draw, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference samples in jnp code outside any
// Pallas kernel (jax.random.fold_in / uniform / categorical in
// src/repro/core/speculative.py and eagle.py).  In plain PyTorch one
// threefry hash is ~160 elementwise launches, and a sampled chain round
// needs ~10 fold-ins and gamma + 1 vocabulary-wide draws on a serving loop
// that is already bound by the host.  So the port hashes in one launch:
//
//  - repro_threefry2x32(keys (R, 2), counters (R, N, 2)) -> (R, N, 2):
//    the threefry-2x32 hash of every counter pair under its row's key.
//    fold_in, split and the short uniform draws are this hash.
//  - repro_categorical_rows(keys (R, 2), logits (R, V) fp32) -> (R,) int32:
//    jax.random.categorical of each row under its own key, fused: the
//    bits at flat index i (counter (i >> 32, i & 0xFFFFFFFF), offset by
//    row * row_stride for a batch-global key), JAX's uniform with minval
//    tiny, g = -logf(-logf(u)), logits + g and the argmax with the lowest
//    index among equal maxima (jnp.argmax's rule; a NaN beats any number).
//
// Words are uint32, in int64 tensors on the Python side (the low 32 bits
// are read; outputs are written zero-extended).  The arithmetic is exact
// integer work, so the words equal the plain version's bit for bit; logf
// is the IEEE-accurate one (no fast-math), and the sums and the product
// by (maxval - minval) = 1.0f are written with __fadd_rn/__fmul_rn so no
// contraction changes a rounding.
//
// What bounds it on an H100: the hash's integer work.  The hash is ~80
// 32-bit integer operations an element, ~97 M at R 8, V 151 552, and an
// SM issues 64 of them a clock (~16.7 T/s on the card): ~5.8 us, above
// the ~1.4 us of reading the logits once (4.85 MB at 3.35 TB/s).  The
// design: a grid of (chunks, R) blocks of 256 threads, each thread a
// strided walk over its chunk keeping the best (value, index), a
// warp-shuffle then shared-memory reduction to one partial per block,
// and a second one-warp-per-row kernel over the partials.  The wrapper picks the chunk count, so a row of 151 552
// spreads over ~74 blocks and R 8 fills the 132 SMs.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kTiny = 1.17549435e-38f;  // FLT_MIN, JAX's finfo.tiny

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// jax/_src/prng.py _threefry2x32_lowering, unrolled.
__device__ __forceinline__ void threefry(uint32_t k0, uint32_t k1,
                                         uint32_t& x0, uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, rot[i & 1][j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
}

__global__ void threefry_kernel(const long long* __restrict__ keys,
                                const long long* __restrict__ ctr,
                                long long* __restrict__ out, int R, int N) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)R * N) return;
  const long long r = idx / N;
  uint32_t x0 = (uint32_t)ctr[2 * idx], x1 = (uint32_t)ctr[2 * idx + 1];
  threefry((uint32_t)keys[2 * r], (uint32_t)keys[2 * r + 1], x0, x1);
  out[2 * idx] = (long long)x0;
  out[2 * idx + 1] = (long long)x1;
}

// (v, i) beats (best, bi): larger value, the lower index on a tie; a NaN
// beats every number, and the first NaN wins.
__device__ __forceinline__ bool better(float v, int i, float best, int bi) {
  const bool vn = isnan(v), bn = isnan(best);
  if (vn || bn) return vn && (!bn || i < bi);
  return v > best || (v == best && i < bi);
}

__device__ __forceinline__ void warp_best(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, v, off);
    const int oi = __shfl_down_sync(0xffffffffu, i, off);
    if (better(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

// grid (chunks, R): block (c, r) draws row r's indices [c * chunk,
// min(V, (c + 1) * chunk)) and writes its best (value, index) pair.
__global__ void __launch_bounds__(kThreads) categorical_partial_kernel(
    const long long* __restrict__ keys, const float* __restrict__ logits,
    float* __restrict__ pval, int* __restrict__ pidx, int V, int chunk,
    long long row_stride) {
  const int r = blockIdx.y;
  const uint32_t k0 = (uint32_t)keys[2 * r], k1 = (uint32_t)keys[2 * r + 1];
  const int lo = blockIdx.x * chunk;
  const int hi = min(V, lo + chunk);
  const float* row = logits + (size_t)r * V;
  const unsigned long long base = (unsigned long long)r * row_stride;
  float best = -INFINITY;
  int bi = 0x7fffffff;
  for (int i = lo + threadIdx.x; i < hi; i += kThreads) {
    const unsigned long long c = base + (unsigned long long)i;
    uint32_t x0 = (uint32_t)(c >> 32), x1 = (uint32_t)c;
    threefry(k0, k1, x0, x1);
    const uint32_t bits = x0 ^ x1;
    const float f = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
    const float u = fmaxf(kTiny, __fadd_rn(__fmul_rn(f, 1.0f), kTiny));
    const float g = -logf(-logf(u));
    const float v = __fadd_rn(row[i], g);
    if (better(v, i, best, bi)) {
      best = v;
      bi = i;
    }
  }
  warp_best(best, bi);
  __shared__ float sv[kThreads / 32];
  __shared__ int si[kThreads / 32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    sv[warp] = best;
    si[warp] = bi;
  }
  __syncthreads();
  if (warp == 0) {
    best = lane < kThreads / 32 ? sv[lane] : -INFINITY;
    bi = lane < kThreads / 32 ? si[lane] : 0x7fffffff;
    warp_best(best, bi);
    if (lane == 0) {
      pval[(size_t)r * gridDim.x + blockIdx.x] = best;
      pidx[(size_t)r * gridDim.x + blockIdx.x] = bi;
    }
  }
}

// one warp per row over its chunks' partials
__global__ void categorical_final_kernel(const float* __restrict__ pval,
                                         const int* __restrict__ pidx,
                                         int* __restrict__ out, int chunks) {
  const int r = blockIdx.x, lane = threadIdx.x;
  float best = -INFINITY;
  int bi = 0x7fffffff;
  for (int c = lane; c < chunks; c += 32) {
    const float v = pval[(size_t)r * chunks + c];
    const int i = pidx[(size_t)r * chunks + c];
    if (better(v, i, best, bi)) {
      best = v;
      bi = i;
    }
  }
  warp_best(best, bi);
  if (lane == 0) out[r] = bi;
}

}  // namespace

// keys (R, 2), counters and out (R, N, 2): int64 holding uint32 words.
// Returns a cudaError_t as int.
extern "C" int repro_threefry2x32(const long long* keys,
                                  const long long* counters, long long* out,
                                  int R, int N, void* stream) {
  if (R <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  const long long n = (long long)R * N;
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  threefry_kernel<<<(unsigned)blocks, kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(keys, counters, out,
                                                         R, N);
  return (int)cudaGetLastError();
}

// keys (R, 2) int64 words, logits (R, V) fp32, out (R,) int32; scratch
// holds R * chunks floats then R * chunks ints.  Row r's counters start
// at r * row_stride (0 for a key a row, V for one key over the batch).
extern "C" int repro_categorical_rows(const long long* keys,
                                      const float* logits, int* out,
                                      void* scratch, int R, int V, int chunks,
                                      long long row_stride, void* stream) {
  if (R <= 0 || V <= 0 || chunks <= 0 || chunks > V || R > 65535 ||
      row_stride < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int chunk = (V + chunks - 1) / chunks;
  float* pval = static_cast<float*>(scratch);
  int* pidx = reinterpret_cast<int*>(pval + (size_t)R * chunks);
  categorical_partial_kernel<<<dim3(chunks, R), kThreads, 0, st>>>(
      keys, logits, pval, pidx, V, chunk, row_stride);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  categorical_final_kernel<<<R, 32, 0, st>>>(pval, pidx, out, chunks);
  return (int)cudaGetLastError();
}
