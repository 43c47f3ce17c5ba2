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
// What bounds it on an H100.  The least work at the served shapes (B=8,
// S=512, 32 query heads over 2 kv heads, D=128, bf16, a few lanes left-
// padded) is ~71 MB of q/k/v/out traffic (0.021 ms at 3.35 TB/s) and
// ~12 GFLOP (0.012 ms at the 989 TFLOP/s bf16 tensor-core peak), so the
// roofline bound is the bytes.  This first version is far from it, for
// two reasons of its own design:
//   * It does the arithmetic as fp32 FMA from shared memory, without
//     tensor cores: the float32 peak of 67 TFLOP/s alone puts the
//     ~12 GFLOP at >= 0.18 ms.
//   * A block holds kRows = 16 (position, head) rows, which at G = 16
//     query heads per kv head is ONE query position.  So every block
//     walks K/V from its lane's pad to its own position, and each K/V
//     tile of a (lane, kv head) is read once per later position: about
//     S/2 times on average, ~1 GB per call at B=8, S=512, against the
//     4 MB the call needs.  A lane's K/V of one kv head (256 KB) stays
//     in L2, so most re-reads are L2 hits, but they still cost load and
//     shared-memory traffic per FMA.
// What the design does get right: the G query heads of a kv head share
// each K/V tile, blocks skip tiles outside [pad, own position], and a
// masked key is never weighted by zero.  A tile of many query positions
// per block (e.g. 64 positions x G heads, K/V staged once, wgmma/mma
// products) is queued in ROADMAP.md (queue 2, performance).
#include "attn_rows.cuh"

extern "C" int repro_flash_attn(const void* q, const void* k, const void* v,
                                const int* pad, void* out, int B, int S,
                                int Hq, int Hk, int D, int causal,
                                int window, int dtype, void* stream) {
  repro::AttnArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = out;
  a.qoff = nullptr;
  a.pad = pad;
  a.B = B;
  a.T = S;
  a.S = S;
  a.Hq = Hq;
  a.Hk = Hk;
  a.causal = causal;
  a.window = window;
  a.scale = 1.0f / sqrtf((float)D);
  return repro::launch_attn_rows(a, D, dtype, static_cast<cudaStream_t>(stream));
}
