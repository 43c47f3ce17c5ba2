// Paged decode-side (verify / extend / propose) attention for Hopper
// (sm_90a).
//
// Replaces src/repro/kernels/verify_attn/kernel.py:157
// verify_attention_paged, both modes (tree=(W, g): the _tree_mask mode
// called at :134; see attn_rows.cuh).  Chain: T queries per lane at cache
// positions lengths[b] + [0, T) attend K/V read through the lane's block
// table row: k/v_pool (NP + 1, P, Hk, D), tbl (B, n_tbl), the lane window
// n_tbl * P.  Row t sees kpos in [pad[b], lengths[b] + t], optionally
// windowed.  Every target verify, plain decode, draft extend and draft
// propose of a paged engine runs here.
//
// What bounds it on an H100: as verify_attn.cu, reading the live pages
// once (lanes x live length x 2 kv heads x 128 x 2 bytes x 2 for K and
// V) for T <= 4.  The Pallas kernel DMAs every one of the n_tbl pages of
// a lane (the trash page included) and masks; this one walks only the
// tiles of [pad, lengths + T - 1], so the trash page and table entries
// past lengths + T are never read, and it adds one table lookup per
// loaded key row.  It keeps the dense kernel's limits (T blocks per lane,
// each reading the live K/V alone; fp32 FMA), and on the card its output
// equals, bit for bit, the dense kernel's on gather_view(pool, tbl).
#include "attn_rows.cuh"

extern "C" int repro_verify_attn_paged(const void* q, const void* k_pool,
                                       const void* v_pool, const int* tbl,
                                       const int* lengths, const int* pad,
                                       void* out, int B, int T, int n_tbl,
                                       int P, int Hq, int Hk, int D,
                                       int window, int tree_w, int tree_g,
                                       int dtype, void* stream) {
  repro::AttnArgs a;
  a.q = q;
  a.k = k_pool;
  a.v = v_pool;
  a.o = out;
  a.qoff = lengths;
  a.pad = pad;
  a.tbl = tbl;
  a.n_tbl = n_tbl;
  a.page = P;
  a.B = B;
  a.T = T;
  a.S = n_tbl * P;
  a.Hq = Hq;
  a.Hk = Hk;
  a.causal = 1;
  a.window = window;
  a.tree_w = tree_w;
  a.tree_g = tree_g;
  a.scale = 1.0f / sqrtf((float)D);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return tree_w > 0 ? repro::launch_attn_rows<true, true>(a, D, dtype, st)
                    : repro::launch_attn_rows<true, false>(a, D, dtype, st);
}
