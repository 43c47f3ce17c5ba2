// Prefill attention for Hopper (sm_90a).
//
// Replaces src/repro/kernels/flash_attn/kernel.py:167 flash_attention (the
// Pallas TPU flash kernel), plus the per-row left pad the serving prefill
// needs (the JAX serving path computes it with the masked jnp `attend`,
// models/attention.py:404-412): q (B, S, Hq, D) at positions [0, S),
// k/v (B, S, Hk, D); row b sees keys kpos >= pad[b], causal, optionally
// windowed.  Rows at positions < pad[b] see no key and are written as
// zeros (they only ever reach masked cache positions).
//
// The dtype picks the loop, explicitly: bfloat16 (dtype 1, the serving
// path) runs prefill_rows.cuh on tensor cores; float32 (dtype 0) runs the
// FMA loop of attn_rows.cuh, whose float32 sums hold the CPU sweeps'
// 2e-5 (TF32 tensor cores keep about 3 digits, so they would not).
// Anything else is refused.  Both loops anchor a lane's key tiles at its
// pad, so a row's result does not depend on the other prompts of its
// batch.
//
// What bounds it on an H100.  The least work at the served shapes (B=8,
// S=512, 32 query heads over 2 kv heads, D=128, bf16, pads {0, 17, 100,
// 311, 0, 5, 64, 400}) is ~71 MB of q/k/v/out traffic (0.021 ms at 3.35
// TB/s) against ~12 GFLOP (0.012 ms at the 989 TFLOP/s bf16 tensor-core
// peak): the bytes bound it.  The float32 FMA loop had two faults at
// these shapes, and the bfloat16 loop answers each:
//   * fp32 FMA from shared memory without tensor cores (>= 0.18 ms for
//     the ~12 GFLOP at the 67 TFLOP/s float32 peak): the products are
//     mma.sync m16n8k16 on bf16 tensor cores (P·V as two bf16 halves of
//     P, so 1.5x the tensor-core operations of one bf16 P·V).
//   * one query position per block at G = 16, so each K/V tile of a
//     (lane, kv head) was read once per later position, ~S/2 = 256 times
//     (~1 GB a call where 4 MB are needed): a block now holds 64 rows, 4
//     positions at G = 16, and the tile is read ~S/8 = 64 times, through
//     cp.async, double-buffered, into shared memory padded against bank
//     conflicts.
// Left for a later design: wgmma from shared memory and TMA loads with a
// producer warp (the card's full tensor-core rate needs them), a larger
// row tile (128 rows halves the K/V re-reads again), and a persistent
// grid for the causal imbalance.
#include "attn_rows.cuh"
#include "prefill_rows.cuh"

// lse: (B, S, Hq) float32, each row's log-sum-exp of its scaled scores
// (the training forward, which the backward reads), or nullptr (serving):
// the only difference is that store, so the output is the same bit for
// bit either way.
extern "C" int repro_flash_attn(const void* q, const void* k, const void* v,
                                const int* pad, void* out, float* lse,
                                int B, int S, int Hq, int Hk, int D,
                                int causal, int window, int dtype,
                                void* stream) {
  repro::AttnArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = out;
  a.qoff = nullptr;
  a.pad = pad;
  a.tbl = nullptr;
  a.n_tbl = a.page = 0;
  a.B = B;
  a.T = S;
  a.S = S;
  a.Hq = Hq;
  a.Hk = Hk;
  a.causal = causal;
  a.window = window;
  a.scale = 1.0f / sqrtf((float)D);
  a.lse = lse;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return repro::launch_mma_rows<false>(a, D, st);
  if (dtype == 0) return repro::launch_attn_rows<false>(a, D, 0, st);
  return (int)cudaErrorInvalidValue;
}
