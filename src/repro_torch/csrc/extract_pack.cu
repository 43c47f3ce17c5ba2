// Training-signal pack for Hopper (sm_90a).
//
// Replaces src/repro/kernels/extract_pack/kernel.py:46 extract_pack: per
// lane b, the accepted entries of feats (B, T, F) and tokens (B, T) under
// mask (B, T) are compacted to the front in order (destination d holds the
// d-th accepted source row); rows past the count are zero; counts[b] is
// the number accepted.  Elements move as raw 2- or 4-byte words, so the
// copy is exact for any dtype of that width.
//
// What bounds it on an H100: bytes.  On the glm4-9b main path (B 8,
// T = gamma + 1 = 4, F = 3 * 4096 bf16) it reads at most 0.79 MB and
// writes 0.79 MB: ~0.47 us at 3.35 TB/s, less than a launch.  So the
// design spends no step that waits on another:
//  - Slots: each warp loads the lane's T mask bytes with one coalesced
//    load (lane t reads byte t), __ballot_sync turns them into T bits,
//    __popc gives the count and __fns the source row of each destination.
//    No shared memory, no __syncthreads, no serial loop.
//  - Copies: a thread moves one 16-byte word (uint4: 8 bf16 or 4 fp32) of
//    every destination row; neighbouring threads move neighbouring words.
//    The loads of a group of up to 8 destination rows are all issued
//    before their stores, so a thread pays the round trip to DRAM once a
//    group (once at T = 4).
//  - Zero rows: destination rows at or past the count are stored as
//    zeros without a read.
//  - Tokens and counts: one warp of the lane's first column block.
//  - Grid: (row words / 64, B) blocks of 64 threads, from (B, F) alone:
//    24 x 8 = 192 blocks at B 8, F 12288 bf16, over all 132 SMs.
//  - Scalar path: a row of a width that is not a multiple of 16 bytes, or
//    a base that is not 16-byte aligned, moves 2- or 4-byte words through
//    the same loop (the main path never takes it).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxT = 32;
constexpr int kThreads = 64;
constexpr int kGroup = 8;

// V: the word a thread moves (uint4, or the element's own 2/4 bytes);
// n: words per row.
template <typename V>
__global__ void __launch_bounds__(kThreads) extract_pack_kernel(
    const V* __restrict__ feats, const int* __restrict__ tokens,
    const uint8_t* __restrict__ mask, V* __restrict__ pf, int* __restrict__ pt,
    int* __restrict__ cnt, int T, int n) {
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  // bit t: mask[b, t]; every lane of the warp votes, in range or not
  const unsigned bits = __ballot_sync(
      0xffffffffu, lane < T && mask[(size_t)b * T + lane] != 0);
  const int count = __popc(bits);
  if (blockIdx.x == 0 && threadIdx.x < 32) {
    if (lane < T)
      pt[(size_t)b * T + lane] =
          lane < count ? tokens[(size_t)b * T + __fns(bits, 0, lane + 1)] : 0;
    if (lane == 0) cnt[b] = count;
  }
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= n) return;
  const V* src = feats + (size_t)b * T * n + c;
  V* dst = pf + (size_t)b * T * n + c;
  for (int d0 = 0; d0 < T; d0 += kGroup) {
    V v[kGroup];
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      const int d = d0 + j;
      v[j] = d < count ? src[(size_t)__fns(bits, 0, d + 1) * n] : V{};
    }
#pragma unroll
    for (int j = 0; j < kGroup; ++j)
      if (d0 + j < T) dst[(size_t)(d0 + j) * n] = v[j];
  }
}

template <typename V>
int launch(const void* feats, const int* tokens, const uint8_t* mask,
           void* pf, int* pt, int* cnt, int B, int T, int n,
           cudaStream_t st) {
  const dim3 grid((n + kThreads - 1) / kThreads, B);
  extract_pack_kernel<V><<<grid, kThreads, 0, st>>>(
      static_cast<const V*>(feats), tokens, mask, static_cast<V*>(pf), pt,
      cnt, T, n);
  return (int)cudaGetLastError();
}

}  // namespace

// feats and pf: B x T rows of F elements of elem_bytes (2 or 4) each, not
// overlapping.  Returns a cudaError_t as int.
extern "C" int repro_extract_pack(const void* feats, const int* tokens,
                                  const uint8_t* mask, void* pf, int* pt,
                                  int* cnt, int B, int T, int F,
                                  int elem_bytes, void* stream) {
  if (T <= 0 || T > kMaxT || B <= 0 || F <= 0 ||
      (elem_bytes != 2 && elem_bytes != 4))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t row = (size_t)F * elem_bytes;
  if (row % 16 == 0 && (uintptr_t)feats % 16 == 0 && (uintptr_t)pf % 16 == 0)
    return launch<uint4>(feats, tokens, mask, pf, pt, cnt, B, T,
                         (int)(row / 16), st);
  if (elem_bytes == 2)
    return launch<uint16_t>(feats, tokens, mask, pf, pt, cnt, B, T, F, st);
  return launch<uint32_t>(feats, tokens, mask, pf, pt, cnt, B, T, F, st);
}
