// Decode-side (verify / extend / propose) attention for Hopper (sm_90a).
//
// Replaces src/repro/kernels/verify_attn/kernel.py:214 verify_attention,
// both modes.  tree=(0, 0), the chain: T queries per lane at cache positions
// lengths[b] + [0, T) attend a dense (B, Smax, Hk, D) cache that already
// holds the new block; row t sees kpos in [pad[b], lengths[b] + t],
// optionally windowed.  Keys past lengths[b] + T - 1 (and before pad[b])
// are never read.  T runs from 1 (draft propose) through 4 (target verify,
// draft extend) to S - 1 (the draft's prompt seeding), so queries are
// tiled too, not only keys.  tree=(W, g) (tree_w, tree_g > 0; the
// _tree_mask mode, kernel.py:27, called at :78): the T = W*g + 1 rows are
// a flattened draft tree and each sees the committed keys plus its own
// root path (attn_rows.cuh, "Tree mode"); the target verify of a tree
// round (T = 13 at W = 4, g = 3) runs here.  The tree mode reads the
// same keys as a chain of T rows and adds integer tests per key; a row
// of slot s reads its lane's live K/V up to length + s like the chain's.
//
// The dtype and head dim pick the loop, explicitly: bfloat16 at D = 128
// (glm4-9b, the serving path) runs the tensor-core loop of
// prefill_rows.cuh (launch_mma_rows, route "tensor_core_bf16");
// float32, and bfloat16 at D = 32 or 64, run the FMA loop of
// attn_rows.cuh (route "fma").  Both anchor a lane's key tiles at its
// pad, so a row's result does not depend on the other lanes.
//
// What bounds it on an H100: for T <= 13 the work per byte is small
// (each K/V element feeds 2·G·T flops, 128 at G = 16, T = 4), so the
// least time is that of reading the live part of the cache once: lanes x
// live length x 2 kv heads x 128 x 2 bytes x 2 (K and V), ~1.2 us at
// the serve's lengths (B 8, cache 1024).  The design skips every tile
// outside [pad, lengths + T - 1], writes the output once, and on the
// tensor-core route holds 64 (position, head) rows per block: at G = 16
// the T = 4 positions of a lane are one block, so the lane's K/V is read
// once (the FMA loop's 16-row blocks read it once per position), a tree
// of T = 13 is four blocks, and the draft's prompt seeding (T = S - 1)
// reads each K/V tile once per four positions.  What bounds it now is
// parallelism: one block per (lane, kv head) walks the lane's keys
// alone, 16 blocks at B = 8 on 132 SMs, with the latency of each tile's
// loads and its chain of dependent products in the way.  A split over
// keys whose partial sums combine in an order fixed by the pad, and
// wgmma with TMA loads, are queued in ROADMAP.md (queue 2).
#include "attn_rows.cuh"
#include "prefill_rows.cuh"

extern "C" int repro_verify_attn(const void* q, const void* k, const void* v,
                                 const int* lengths, const int* pad,
                                 void* out, int B, int T, int Smax, int Hq,
                                 int Hk, int D, int window, int tree_w,
                                 int tree_g, int dtype, void* stream) {
  repro::AttnArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = out;
  a.qoff = lengths;
  a.pad = pad;
  a.tbl = nullptr;
  a.n_tbl = a.page = 0;
  a.B = B;
  a.T = T;
  a.S = Smax;
  a.Hq = Hq;
  a.Hk = Hk;
  a.causal = 1;
  a.window = window;
  a.tree_w = tree_w;
  a.tree_g = tree_g;
  a.scale = 1.0f / sqrtf((float)D);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && D == 128)
    return tree_w > 0 ? repro::launch_mma_rows<false, true>(a, D, st)
                      : repro::launch_mma_rows<false, false>(a, D, st);
  return tree_w > 0 ? repro::launch_attn_rows<false, true>(a, D, dtype, st)
                    : repro::launch_attn_rows<false, false>(a, D, dtype, st);
}
