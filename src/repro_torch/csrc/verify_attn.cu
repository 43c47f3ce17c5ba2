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
// What bounds it on an H100: for T <= 4 the work per byte is small
// (each K/V element feeds 2·G·T = 128 flops at G = 16, T = 4), so the
// least time is that of reading the live part of the cache once: lanes x
// live length x 2 kv heads x 128 x 2 bytes x 2 (K and V).  The design
// skips every tile outside [pad, lengths + T - 1] and writes the output
// once, and the G query heads of a kv head share each K/V tile.  But a
// block holds kRows = 16 (position, head) rows, one query position at
// G = 16, so the T positions of a lane are T blocks that each read the
// whole live K/V: T reads of it where one would do (4 at the target
// verify), and at the draft's prompt seeding (T = S - 1) the same
// once-per-position re-read as flash_attn.cu.  One block also walks its keys alone (no split
// over keys), so at small batch few blocks are in flight.  A block of
// several positions and a split-KV pass are queued in ROADMAP.md
// (queue 2, performance).
#include "attn_rows.cuh"

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
  return tree_w > 0 ? repro::launch_attn_rows<false, true>(a, D, dtype, st)
                    : repro::launch_attn_rows<false, false>(a, D, dtype, st);
}
