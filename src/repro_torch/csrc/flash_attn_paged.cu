// Paged prefill attention for Hopper (sm_90a).
//
// Replaces src/repro/kernels/flash_attn/kernel.py:115
// flash_attention_paged (the Pallas block-table prefill kernel), plus the
// per-row left pad of the dense prefill (flash_attn.cu): q (B, S, Hq, D)
// at positions [0, S); k/v_pool (NP + 1, P, Hk, D); tbl (B, n_tbl) with
// n_tbl * P >= S.  Row b sees keys kpos in [pad[b], qpos], optionally
// windowed, read through its table row; rows before pad[b] are zeros.
// The serving engine calls it in the paged refill and prologue prefill,
// after each layer wrote the prompt's K/V into the lanes' reserved pages.
//
// It launches the dense kernel's loops with Paged = true: bfloat16
// (dtype 1) the tensor-core loop of prefill_rows.cuh, float32 (dtype 0)
// the FMA loop of attn_rows.cuh; the template flag changes only the
// address of a key's row (kv_row<true>: one table lookup per loaded key
// row).  The tile order and the arithmetic are the dense kernel's, so on
// the card its output equals, bit for bit, the dense kernel's on
// gather_view(pool, tbl)[:, :S].
//
// What bounds it on an H100: as flash_attn.cu, the bytes: q, out and the
// live K/V pages once, ~71 MB at B=8, S=512, glm4-9b heads (0.021 ms at
// 3.35 TB/s).  The Pallas kernel walks every page of [0, S) for each
// query block and masks; this one loads only keys in [max(pad, window
// low), the block's last position], so no page outside a lane's prompt
// range is touched.
#include "attn_rows.cuh"
#include "prefill_rows.cuh"

extern "C" int repro_flash_attn_paged(const void* q, const void* k_pool,
                                      const void* v_pool, const int* tbl,
                                      const int* pad, void* out, int B,
                                      int S, int n_tbl, int P, int Hq,
                                      int Hk, int D, int causal, int window,
                                      int dtype, void* stream) {
  repro::AttnArgs a;
  a.q = q;
  a.k = k_pool;
  a.v = v_pool;
  a.o = out;
  a.qoff = nullptr;
  a.pad = pad;
  a.tbl = tbl;
  a.n_tbl = n_tbl;
  a.page = P;
  a.B = B;
  a.T = S;
  a.S = S;
  a.Hq = Hq;
  a.Hk = Hk;
  a.causal = causal;
  a.window = window;
  a.scale = 1.0f / sqrtf((float)D);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return repro::launch_mma_rows<true>(a, D, st);
  if (dtype == 0) return repro::launch_attn_rows<true>(a, D, 0, st);
  return (int)cudaErrorInvalidValue;
}
