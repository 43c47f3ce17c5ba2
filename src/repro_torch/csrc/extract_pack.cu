// Training-signal pack for Hopper (sm_90a).
//
// Replaces src/repro/kernels/extract_pack/kernel.py:46 extract_pack: per
// row b, the accepted entries of feats (B, T, F), tokens (B, T) under
// mask (B, T) are compacted to the front in order (the exclusive prefix
// sum of the mask gives each its slot); the tail is zero; counts[b] is
// the number accepted.
//
// What bounds it on an H100: it is a copy, B·T·F elements read and
// written once (8 × 4 × 12288 bf16 ≈ 0.8 MB each way on the glm4-9b main
// path, ~0.5 us at 3.35 TB/s), so it is bound by launch latency more than
// by bytes.  One block per (F tile, row): thread 0 turns the T <= 32 mask
// bits into a slot -> source-row map in shared memory, then every thread
// copies one column of all T output rows; neighbouring threads touch
// neighbouring columns.  Elements are moved as raw 2- or 4-byte words, so
// the copy is exact for any dtype of that width.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxT = 32;
constexpr int kThreads = 256;

template <typename E>
__global__ void extract_pack_kernel(const E* feats, const int* tokens,
                                    const uint8_t* mask, E* pf, int* pt,
                                    int* cnt, int T, int F) {
  __shared__ int src_of[kMaxT];
  const int b = blockIdx.y;
  if (threadIdx.x == 0) {
    int n = 0;
    for (int t = 0; t < T; ++t) src_of[t] = -1;
    for (int t = 0; t < T; ++t)
      if (mask[b * T + t]) src_of[n++] = t;
    if (blockIdx.x == 0) {
      cnt[b] = n;
      for (int t = 0; t < T; ++t)
        pt[b * T + t] = src_of[t] >= 0 ? tokens[b * T + src_of[t]] : 0;
    }
  }
  __syncthreads();
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= F) return;
  for (int dst = 0; dst < T; ++dst) {
    const int s = src_of[dst];
    pf[((size_t)b * T + dst) * F + f] =
        s >= 0 ? feats[((size_t)b * T + s) * F + f] : E(0);
  }
}

}  // namespace

// elem_bytes: 2 or 4.  Returns a cudaError_t as int.
extern "C" int repro_extract_pack(const void* feats, const int* tokens,
                                  const uint8_t* mask, void* pf, int* pt,
                                  int* cnt, int B, int T, int F,
                                  int elem_bytes, void* stream) {
  if (T <= 0 || T > kMaxT || B <= 0 || F <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((F + kThreads - 1) / kThreads, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 2) {
    extract_pack_kernel<uint16_t><<<grid, kThreads, 0, st>>>(
        static_cast<const uint16_t*>(feats), tokens, mask,
        static_cast<uint16_t*>(pf), pt, cnt, T, F);
  } else if (elem_bytes == 4) {
    extract_pack_kernel<uint32_t><<<grid, kThreads, 0, st>>>(
        static_cast<const uint32_t*>(feats), tokens, mask,
        static_cast<uint32_t*>(pf), pt, cnt, T, F);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
