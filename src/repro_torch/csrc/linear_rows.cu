// Matrix product y = x · w whose row result does not depend on the row
// count, for Hopper (sm_90a).  x (M, K) and w (K, N), row-major; y (M, N)
// in x's dtype; fp32 accumulation.  bfloat16 runs on the warpgroup
// tensor-core product (wgmma) fed by the Tensor Memory Accelerator (TMA),
// float32 on an FMA loop.
//
// Why it exists.  No TPU kernel is replaced: the JAX model leaves its
// projections to XLA.  The serving refill packs several prompts into one
// prefill, so a prompt's rows meet a row count M that depends on the
// other prompts of its refill.  A library GEMM picks its tiling and its
// split over K by M, so a row's rounding, and with it a greedy stream,
// moved with the batch (on an H100 cuBLAS's k/v projections and FFN down
// projection did).  Here row r of y depends only on row r of x and on w,
// bit for bit, for every M and wherever the row sits in x:
//   * tiles are fixed (kLrBM x kLrBN x kLrBK bf16, 64 x 64 x 16 fp32),
//     and each element's sum runs over K in the same order in every tile;
//   * K is split in S parts, S a function of (N, K) alone
//     (kernels/linear_rows/ops.py k_splits), at chunk boundaries fixed by
//     (K, S); each part writes fp32 partials to a workspace, and a second
//     kernel adds them in the order s = 0, 1, ..., S - 1 and rounds once;
//   * no atomics: the result is the same from run to run.
//
// The bf16 design.  A block computes a 128 x BN tile of y with three
// warpgroups: two consumers of 64 rows each issue
// wgmma.mma_async m64nBNk16 (bf16 in, fp32 accumulators in registers),
// and one producer thread keeps TMA loads in flight through a ring of
// STAGES shared-memory stages, each guarded by a "full" mbarrier (the
// TMA's bytes landed) and an "empty" one (both consumers are done with
// it).  A stage holds one 128 x 64 box of x (K-major, 128-byte rows) and
// BN / 64 boxes of 64 columns x 64 K rows of w (w is N-contiguous, which
// wgmma reads as a transposed B), all with the 128-byte swizzle that the
// wgmma descriptors name; the weights are never copied or transposed.
// M, N and K tails come from TMA's zero fill; stores are masked by row
// and column, so a row past M is computed on zeros and never stored.
// Blocks run row tile fastest, so the blocks in flight share a few
// column tiles of w and read x from L2.
//
// What bounds it on an H100.  At the prefill's row counts (M = rows of a
// refill, up to 8 x 512) the glm4-9b projections do 2·M·N·K flops on
// N·K weights: M flops per weight byte, above the card's ~295 at
// M >= 512, so the tensor cores bound them (989 TFLOP/s); at small M (a
// refill of one short prompt; the last-position lm_head at M = lanes)
// the weight read does (weight bytes / 3.35 TB/s).  A split over K fills
// the card at small M but costs S·M·N·8 bytes of fp32 partials at large
// M (two parts add ~30 % to q/o at M 3968), so k_splits splits only the
// narrow products (k/v, N 256: S 4).
//
// What it reached (kernels/linear_rows/tiles.py, kernel alone, on an
// NVIDIA H100 80GB HBM3 at 700.00 W): at M 3968 q/o 0.209 ms (cuBLAS
// through torch.matmul 0.197), ffn up/gate 0.698 (0.607), ffn_down
// 0.623 (0.641), k/v 0.041 (0.044): 635-715 TFLOP/s on the wide
// products; through the wrapper 2.0-2.4x faster than the mma.sync
// kernel it replaced (chip_smoke.py, one call).  Of BN 128 or 256 and
// 3 to 6 stages, 256 x 4 was fastest at every wide product at M 3968;
// Wgmma<128> stays for the tile script, which holds that choice against
// BN 128, the shape a fixed (N, K)-keyed variant for the narrow or
// short products would take.  What holds it back: each block fills its
// ring and drains its epilogue alone (no persistent scheduler, so no
// overlap of one tile's stores with the next one's loads), and 496
// blocks of q/o or ffn_down are 3.8 waves on 132 SMs.  At M 128 the wide
// products run 16-54 blocks with S 1 (ffn_down 0.145 ms against 0.075)
// and k/v 4 blocks at S 4.  A persistent tile scheduler, clusters with
// multicast and a TMA-store epilogue are not used.
#include <cuda.h>

#include "prefill_rows.cuh"

namespace repro {

// The production shape, reported by repro_linear_rows_tile
// (kernels/linear_rows/ops.py BLOCK_N, BLOCK_K mirror kLrBN, kLrBK:
// k_splits counts kLrBK-deep chunks over kLrBN-wide column tiles).
constexpr int kLrBM = 128, kLrBN = 256, kLrBK = 64, kLrStages = 4;
constexpr int kLrThreads = 384;   // consumer warpgroups 0, 1; producer 2

constexpr int kLfBM = 64, kLfBN = 64, kLfBK = 16;

// The shared-memory ring of one bf16 tile shape.
template <int BN, int STAGES>
struct LrTile {
  static constexpr int kABytes = kLrBM * kLrBK * 2;   // x: 128 x 64
  static constexpr int kBBoxBytes = kLrBK * 64 * 2;   // w: 64 rows x 64
  static constexpr int kStageBytes = kABytes + (BN / 64) * kBBoxBytes;
  // + 1024: the ring starts at a 1024-byte boundary (the swizzle's period)
  static constexpr int kSmemBytes = STAGES * kStageBytes + 1024;
  static_assert(BN % 64 == 0 && BN <= 256, "wgmma takes N <= 256");
  static_assert(kLrBK * 2 == 128, "one K chunk is one 128-byte swizzle row");
};

// k chunks [c0, c1) of split s of S over nch chunks: fixed by (K, S)
__device__ __forceinline__ void split_range(int s, int S, int nch, int& c0,
                                            int& c1) {
  c0 = (int)(((long long)s * nch) / S);
  c1 = (int)(((long long)(s + 1) * nch) / S);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait for the completion of the barrier's phase of this parity.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// TMA: the box at coordinates (c0 innermost, c1) of the map into shared
// memory at dst, completing on bar.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout 1.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of the accumulators
// across an asynchronous wgmma.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d += A · B, one m64nNk16 step: A K-major (x), B N-major (w, the
// transposed-B bit set), fp32 accumulators d in the wgmma fragment
// layout (d[4j + 2h + e] is row 16·warp + lane / 4 + 8h, column
// 8j + 2·(lane % 4) + e of the warpgroup's 64 x N tile).
template <int N>
struct Wgmma;

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void mma(float (&d)[64], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<256> {
  static __device__ __forceinline__ void mma(float (&d)[128], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
        "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
        "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127"
        "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
          "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
          "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
          "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
          "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
          "+f"(d[126]), "+f"(d[127])
        : "l"(a), "l"(b), "r"(1));
  }
};


template <int BN, int STAGES>
__global__ void __launch_bounds__(kLrThreads, 1)
    linear_rows_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                             const __grid_constant__ CUtensorMap tw,
                             __nv_bfloat16* __restrict__ y,
                             float* __restrict__ ws, int M, int N, int K,
                             int S) {
  using Tl = LrTile<BN, STAGES>;
  extern __shared__ __align__(1024) unsigned char lr_smem[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  const uint32_t ring = (smem_u32(lr_smem) + 1023) & ~1023u;
  const int m0 = blockIdx.x * kLrBM, n0 = blockIdx.y * BN;
  const int s = blockIdx.z;
  int c0, c1;
  split_range(s, S, (K + kLrBK - 1) / kLrBK, c0, c1);
  const int nk = c1 - c0;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(smem_u32(&full[i]), 1);
      mbar_init(smem_u32(&empty[i]), 2);   // one arrival per consumer
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // producer: one thread issues every load of the block
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 256) {
      for (int c = 0; c < nk; ++c) {
        const int st = c % STAGES;
        // the stage's previous chunk, c - STAGES, released by both
        if (c >= STAGES) mbar_wait(smem_u32(&empty[st]), (c / STAGES - 1) & 1);
        const uint32_t bar = smem_u32(&full[st]);
        const uint32_t a = ring + st * Tl::kStageBytes;
        const int k0 = (c0 + c) * kLrBK;
        mbar_expect_tx(bar, Tl::kStageBytes);
        tma_load_2d(a, &tx, k0, m0, bar);
#pragma unroll
        for (int j = 0; j < BN / 64; ++j)
          tma_load_2d(a + Tl::kABytes + j * Tl::kBBoxBytes, &tw, n0 + 64 * j,
                      k0, bar);
      }
    }
  } else {
    // consumer warpgroup wg: rows m0 + 64·wg + [0, 64)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    fence_acc(acc);
    for (int c = 0; c < nk; ++c) {
      const int st = c % STAGES;
      mbar_wait(smem_u32(&full[st]), (c / STAGES) & 1);
      const uint32_t a = ring + st * Tl::kStageBytes + wg * 64 * 128;
      const uint32_t b = ring + st * Tl::kStageBytes + Tl::kABytes;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kLrBK / 16; ++kk)
        // x: 16 K columns are 32 bytes along a swizzled row, the next 8
        // rows 1024 bytes on; w: 16 K rows are 2048 bytes on, the next 8
        // K rows 1024, the next 64 columns one box (kBBoxBytes) on
        Wgmma<BN>::mma(acc, sw128_desc(a + kk * 32, 16, 1024),
                       sw128_desc(b + kk * 2048, Tl::kBBoxBytes, 1024));
      wgmma_commit();
      wgmma_wait<1>();   // chunk c - 1's products are done: free its stage
      if (c > 0 && threadIdx.x % 128 == 0)
        mbar_arrive(smem_u32(&empty[(c - 1) % STAGES]));
    }
    wgmma_wait<0>();
    fence_acc(acc);

    const int lane = threadIdx.x % 32;
    const int r0 = m0 + wg * 64 + (threadIdx.x % 128) / 32 * 16 + lane / 4;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * (lane % 4);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h;
        if (r >= M || col >= N) continue;
        const float a0 = acc[4 * j + 2 * h], a1 = acc[4 * j + 2 * h + 1];
        if (S == 1)
          *reinterpret_cast<uint32_t*>(y + (size_t)r * N + col) = pack_bf16(a0, a1);
        else
          *reinterpret_cast<float2*>(ws + ((size_t)s * M + r) * N + col) =
              make_float2(a0, a1);
      }
    }
  }
}

// A 2-D bf16 tensor map of a row-major (outer, inner) tensor: boxes of
// box_outer x box_inner elements, 128-byte swizzle, zeros out of bounds.
// False if cuTensorMapEncodeTiled is not found or refuses the tensor.
inline bool encode_bf16_map(CUtensorMap* map, const void* base,
                            uint64_t inner, uint64_t outer,
                            uint32_t box_inner, uint32_t box_outer) {
  using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                              void*, const cuuint64_t*, const cuuint64_t*,
                              const cuuint32_t*, const cuuint32_t*,
                              CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static Encode encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return false;
    encode = reinterpret_cast<Encode>(fn);
  }
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {inner * 2};
  const cuuint32_t box[2] = {box_inner, box_outer};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Launch one bf16 tile shape (its partials, or y when S == 1).  The
// tensor maps are encoded per call; a map that does not encode returns
// cudaErrorInvalidValue.
template <int BN, int STAGES>
inline cudaError_t launch_linear_rows_bf16(const void* x, const void* w,
                                           void* y, float* ws, int M, int N,
                                           int K, int S, cudaStream_t st) {
  using Tl = LrTile<BN, STAGES>;
  CUtensorMap tx, tw;
  if (!encode_bf16_map(&tx, x, K, M, kLrBK, kLrBM) ||
      !encode_bf16_map(&tw, w, N, K, 64, kLrBK))
    return cudaErrorInvalidValue;
  auto* kern = linear_rows_wgmma_kernel<BN, STAGES>;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Tl::kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((M + kLrBM - 1) / kLrBM, (N + BN - 1) / BN, S);
  kern<<<grid, kLrThreads, Tl::kSmemBytes, st>>>(
      tx, tw, static_cast<__nv_bfloat16*>(y), ws, M, N, K, S);
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
    err = launch_linear_rows_bf16<kLrBN, kLrStages>(x, w, y, wsf, M, N, K, S,
                                                    st);
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

// The bf16 production tile: out[0..3] = BM, BN, BK, STAGES.
extern "C" int repro_linear_rows_tile(int* out) {
  out[0] = repro::kLrBM;
  out[1] = repro::kLrBN;
  out[2] = repro::kLrBK;
  out[3] = repro::kLrStages;
  return 0;
}
