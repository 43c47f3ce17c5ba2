"""Smoke run of the PyTorch port on one CUDA card (an NVIDIA H100).

    python3 chip_smoke.py

Phases, one JSON line each:

  env      torch/CUDA versions, the card (nvidia-smi name and power
           limit), and the seconds to build the CUDA kernels from
           src/repro_torch/csrc (into build/repro_torch/).
  kernels  each CUDA kernel against its plain PyTorch version at the
           glm4-9b main-path shapes (batch 8, prompt 512, cache 1024,
           lanes with left pad; verify at T = 1, 4 and 511), held per
           element at rtol = atol = 2e-2 (bf16) on the rows that see a
           key, extract_pack exactly: max abs error, finiteness, median
           kernel ms, plain ms, and the ms of one PyTorch library call
           computing the same function.  The paged kernels (page 16,
           shuffled tables, lanes 0-3 sharing their first 8 pages) are
           also held bit for bit (torch.equal) against the dense kernel
           on the gathered view; their library yardstick is two calls,
           the pool[tbl] gather and scaled_dot_product_attention.  The
           verify kernels' tree mode (W = 4, gamma = 3, T = 13), dense
           and paged, against its plain version; W = 1 bit for bit
           against the chain kernel, paged bit for bit against dense on
           the gathered view, also in a window > 0 sweep at a small
           width; yardstick SDPA with the explicit tree mask.  Each
           attention row is also held to pad-shift invariance: one
           lane's prompt at pads 0, 5, 17, 31, 32, 100 of rows 0 and 40
           wider gives the same rows bit for bit (pad_shift_equal).  The
           prefill rows name their path (prefill_path:
           tensor_core_bf16) and the error of a one-bf16-P emulation
           (p_bf16_rel_l2_emulated), the verify rows theirs
           (verify_path: tensor_core_bf16, asserted); every row with a
           library call gets ms_over_library_ms.  linear_rows, the
           prefill's row-invariant matrix product, at glm4-9b's (K, N)
           of k_proj, q_proj/o_proj, ffn_up, ffn_down and lm_head: each
           row of x gives the same row, torch.equal, at M = 1, 2, 126,
           128, 992 and 3968; its time against torch.matmul (which is
           also its plain version) at M 3968 and 128.
  ladder   glm4-9b width at 2 layers, random weights: the same 8
           requests through superstep_rounds=8 and =0 give equal greedy
           streams, dense and paged (page 16), tree speculation at
           W = 2 gives equal streams stepwise, in supersteps (K 8), as a
           stream (K 8 and 3) and in waves, and the card's prefill
           logits agree with the CPU's.
  serve    glm4-9b at full width and depth, random bf16 weights from a
           seeded generator: ServingEngine (batch 8, max_len 1024,
           gamma 3, K=8, greedy, no drafter) serves 16 requests (prompts
           64-512, 64 new tokens; requests 1, 3, 5 and 7 share one
           prompt) with serve_stream.  Every kernel's launch count is
           zeroed just before and read just after.
  cobatch  the serve's shortest prompt refilled alone and beside its
           longest (the engine's own refill packing: another pad, width
           and row count) through glm4-9b at full depth, op by op: the
           first op whose rows of the prompt depart (verdict) and every
           op that departs with equal input rows.  The verdict must be
           none and no op may depart alone.  Beside it, the same steps
           with torch.matmul for the products under
           allow_bf16_reduced_precision_reduction = False: what cuBLAS
           alone would give with that setting (reported, not asserted).
  paged_serve  the same engine configuration with page_size 16 on the
           same weights and requests, twice: with the dense footprint of
           512 pages (no admission can defer, so the schedule is the
           dense serve's: streams, supersteps and host syncs must equal
           it exactly, prefix hits > 0), then with 256 pages (the
           admission guard defers; every request must finish, the peak
           must stay within the pool, every paged kernel must launch,
           and all 16 streams must equal dense).
           The allocator is clean at drain in both.
  tree_serve  the serve's configuration, weights and requests with
           tree speculation, W = 1 (streams, supersteps and host syncs
           must equal the chain serve's) and W = 4 (tokens/s, superstep
           ms, host syncs per superstep no more than the chain's, the
           streams that differ from the chain's and the top-2 logit gap
           at the first flip); each target verify must be one tree-mode
           launch per layer.
  paged_tree_serve  tree speculation over paged KV (page 16) on the same
           weights and requests, three times: W = 1 and W = 4 with the
           dense footprint of 512 pages (W = 1's streams, supersteps
           and host syncs must equal the chain serve's, W = 4's streams
           the dense W = 4 tree serve's), then W = 4 with 256 pages
           (the tree's larger reservation makes the guard defer; its
           streams must equal the dense W = 4 tree's).  Every
           target verify is one launch per layer of the paged kernel in
           tree mode (layers x speculative rounds, asserted), the draft
           attends through the paged kernel in chain mode, the dense
           verify kernel runs only for the refills' draft seeding, and
           no page leaks after a drain.
  profile  torch.profiler over a short serve on the dense engine right
           after its serve, then on the half-pool paged engine, each
           tree engine and the W = 4 paged tree engine, each right after
           its serve: device busy share, device time by kernel class,
           and the host-blocking CUDA calls (synchronizations, pageable
           host-to-device copies) of each; no paged or tree serve may
           block the host more than the chain.  Each engine is freed
           before the next is built.

Then the kernel table (``{"kernels": [...]}``: eight rows, each with its
launch count from the main-path serve that runs it), the nvidia-smi
line, and last ``{"ok": true, "device": {...}}``.  Any failure raises
and exits non-zero before the last line.  Without a CUDA card it exits non-zero
at once.
"""
from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12        # H100 SXM
BF16_FLOPS_PER_S = 989e12        # H100 SXM dense bf16
BF16_TOL = 2e-2                  # per element, as tests/test_kernels.py
# whole tensor: set from readings on an H100 (at most 2.9e-5 at the
# shapes below), so a systematic error above 0.1 % fails
REL_L2_TOL = 1e-3
GLM = dict(B=8, S=512, SMAX=1024, HQ=32, HK=2, D=128, F=3 * 4096, GAMMA=3,
           P=16, TREE_W=4)


T_START = time.perf_counter()


def emit(obj):
    """One JSON line; a phase line also gets the seconds since start."""
    if "phase" in obj:
        obj = dict(obj, elapsed_s=round(time.perf_counter() - T_START, 1))
    print(json.dumps(obj), flush=True)


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, timeout=60, check=True)
    return out.stdout.decode().strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median device time of ``fn`` in ms (CUDA events around each call)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1))
    return statistics.median(times)


def bound(nbytes: float, flops: float):
    mem, ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS_PER_S * 1e3
    return (mem, "bytes") if mem >= ops else (ops, "operations")


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def hold(out, ref, what: str):
    """Hold a bf16 kernel output against its plain version: per element
    at rtol = atol = BF16_TOL, and as a whole at relative L2 error below
    REL_L2_TOL (a key dropped or double-counted in rows that see hundreds
    of keys moves each element by less than the per-element tolerance,
    but the whole tensor by several percent).  Returns (max abs error,
    relative L2 error)."""
    out, ref = out.float(), ref.float()
    torch.testing.assert_close(out, ref, rtol=BF16_TOL, atol=BF16_TOL,
                               msg=lambda m: f"{what}: {m}")
    rel = float((out - ref).norm() / ref.norm())
    assert rel < REL_L2_TOL, f"{what}: relative L2 error {rel}"
    return max_err(out, ref), rel


# ------------------------------------------------------------------ env
def phase_env():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(2)
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(here, "src"))
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build.library()
    emit({"phase": "env", "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0),
          "device_count": torch.cuda.device_count(), "nvidia_smi": smi(),
          "build_s": round(time.perf_counter() - t0, 2),
          "nvcc_s": round(build.BUILD_SECONDS, 2)})


# -------------------------------------------------------------- kernels
def _sdpa(q, k, v, mask):
    """One library call for masked GQA attention (yardstick only)."""
    import torch.nn.functional as F
    g = q.shape[2] // k.shape[2]
    k = k.repeat_interleave(g, dim=2)
    v = v.repeat_interleave(g, dim=2)
    return F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=mask[:, None]).transpose(1, 2)


def phase_kernels():
    from repro_torch.kernels.extract_pack.ops import pack_signals
    from repro_torch.kernels.extract_pack.ref import extract_pack_ref
    from repro_torch.kernels.flash_attn.ops import flash_attention
    from repro_torch.kernels.flash_attn.ref import (flash_attention_ref,
                                                    prefill_mask)
    from repro_torch.kernels.verify_attn.ops import (verify_attention,
                                                     verify_route)
    from repro_torch.kernels.verify_attn.ref import (verify_attention_ref,
                                                     verify_mask)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    B, S, SMAX, HQ, HK, D = (GLM[k] for k in ("B", "S", "SMAX", "HQ", "HK", "D"))
    bf = torch.bfloat16

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).to(bf)

    rows = []
    # ---- prefill (serving prefill with left pad)
    q, k, v = rnd(B, S, HQ, D), rnd(B, S, HK, D), rnd(B, S, HK, D)
    pad = torch.tensor([0, 17, 100, 311, 0, 5, 64, 400], dtype=torch.int32,
                       device=dev)
    out = flash_attention(q, k, v, pad)
    ref = flash_attention_ref(q, k, v, pad)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all(), "flash_attention wrote non-finite"
    valid = (torch.arange(S, device=dev)[None, :] >= pad[:, None])
    err, rel = hold(out[valid], ref[valid], "flash_attention")
    assert not out[~valid].any(), "rows before pad must be zeros"
    vis = torch.clamp(torch.arange(S, device=dev)[None, :] - pad[:, None] + 1,
                      min=0).sum().item() * HQ
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel()) + 4 * B
    mask = prefill_mask(B, S, pad, device=dev)
    b_ms, b_by = bound(nbytes, 4.0 * vis * D)
    rows.append(dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/csrc/flash_attn.cu",
        replaces="src/repro/kernels/flash_attn/kernel.py:167",
        prefill_path="tensor_core_bf16",
        max_abs_err=err, rel_l2_err=rel,
        p_bf16_rel_l2_emulated=_p_bf16_rel_l2(q, k, v, mask, ref, valid),
        ms=cuda_ms(lambda: flash_attention(q, k, v, pad)),
        plain_ms=cuda_ms(lambda: flash_attention_ref(q, k, v, pad), iters=5),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=cuda_ms(lambda: _sdpa(q, k, v, mask)),
        shape=f"q {tuple(q.shape)} kv {tuple(k.shape)} bf16, pad>0"))

    # ---- verify attention at T = 4 (target verify), 1, 511
    kc, vc = rnd(B, SMAX, HK, D), rnd(B, SMAX, HK, D)
    cases = []
    for t, lengths in ((4, [600, 517, 812, 1000, 64, 256, 700, 333]),
                       (1, [600, 517, 812, 1000, 64, 256, 700, 333]),
                       (511, [0] * B)):
        qt = rnd(B, t, HQ, D)
        ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
        pd = torch.minimum(pad, ln) if t < 511 else pad
        o = verify_attention(qt, kc, vc, ln, pd)
        r = verify_attention_ref(qt, kc, vc, ln, pd)
        torch.cuda.synchronize()
        assert torch.isfinite(o).all(), "verify_attention wrote non-finite"
        qpos = ln[:, None] + torch.arange(t, device=dev)[None, :]
        live = qpos >= pd[:, None]
        e, rel_t = hold(o[live], r[live], f"verify_attention T={t}")
        nvis = (torch.clamp(torch.clamp(qpos, max=SMAX - 1) - pd[:, None] + 1,
                            min=0)).sum().item() * HQ
        span = (torch.clamp(ln + t, max=SMAX) - pd).clamp(min=0).sum().item()
        nbytes = 2 * 2 * qt.numel() + 2 * 2 * span * HK * D + 8 * B
        vmask = verify_mask(ln, t, SMAX, pd)
        b_ms, b_by = bound(nbytes, 4.0 * nvis * D)
        cases.append(dict(
            T=t, max_abs_err=e, rel_l2_err=rel_t,
            ms=cuda_ms(lambda: verify_attention(qt, kc, vc, ln, pd)),
            plain_ms=cuda_ms(lambda: verify_attention_ref(qt, kc, vc, ln, pd),
                             iters=5),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=cuda_ms(lambda: _sdpa(qt, kc, vc, vmask))))
    head = cases[0]
    vpath = verify_route(bf, D)
    assert vpath == "tensor_core_bf16", vpath
    rows.append(dict(
        name="verify_attention", route="cuda",
        source="src/repro_torch/csrc/verify_attn.cu",
        replaces="src/repro/kernels/verify_attn/kernel.py:214",
        verify_path=vpath,
        max_abs_err=max(c["max_abs_err"] for c in cases),
        **{k: head[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                "library_ms")},
        shape=f"T=4 q {(B, 4, HQ, D)} cache {tuple(kc.shape)} bf16",
        cases=cases))

    # ---- paged kernels: pools of B * 64 pages + trash at P 16; each lane's
    # table a shuffled page list, lanes 0-3 sharing their first 8 pages
    from repro_torch.core.paging import gather_view
    from repro_torch.kernels.flash_attn.ops import flash_attention_paged
    from repro_torch.kernels.flash_attn.ref import flash_attention_paged_ref
    from repro_torch.kernels.verify_attn.ops import verify_attention_paged
    from repro_torch.kernels.verify_attn.ref import verify_attention_paged_ref
    P = GLM["P"]
    n_tbl = SMAX // P
    n_pages = B * n_tbl
    kpool, vpool = rnd(n_pages + 1, P, HK, D), rnd(n_pages + 1, P, HK, D)
    full = torch.randperm(n_pages, generator=g, device=dev).to(
        torch.int32).reshape(B, n_tbl)
    full[1:4, :8] = full[0, :8]

    def table(need):
        """Rows of ``full`` with entries past need[b] pages on trash."""
        col = torch.arange(n_tbl, device=dev)[None, :]
        return torch.where(col < need[:, None], full,
                           torch.full_like(full, n_pages)).contiguous()

    pcases = []
    for t, lengths in ((4, [600, 517, 812, 1000, 64, 256, 700, 333]),
                       (1, [600, 517, 812, 1000, 64, 256, 700, 333]),
                       (511, [0] * B)):
        qt = rnd(B, t, HQ, D)
        ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
        pd = torch.minimum(pad, ln) if t < 511 else pad
        need = torch.clamp(-(-(ln + t) // P), max=n_tbl)
        tb = table(need)
        kv_k, kv_v = gather_view(kpool, tb), gather_view(vpool, tb)
        o = verify_attention_paged(qt, kpool, vpool, tb, ln, pd)
        r = verify_attention_paged_ref(qt, kpool, vpool, tb, ln, pd)
        dense = verify_attention(qt, kv_k, kv_v, ln, pd)
        torch.cuda.synchronize()
        assert torch.isfinite(o).all(), "verify_attention_paged non-finite"
        assert torch.equal(o, dense), \
            f"verify_attention_paged T={t} != dense kernel on the view"
        qpos = ln[:, None] + torch.arange(t, device=dev)[None, :]
        live = qpos >= pd[:, None]
        e, rel_t = hold(o[live], r[live], f"verify_attention_paged T={t}")
        nvis = (torch.clamp(torch.clamp(qpos, max=SMAX - 1) - pd[:, None] + 1,
                            min=0)).sum().item() * HQ
        span = (torch.clamp(ln + t, max=SMAX) - pd).clamp(min=0).sum().item()
        pages = (need - pd // P).clamp(min=0).sum().item()
        nbytes = (2 * 2 * qt.numel() + 2 * 2 * span * HK * D + 4 * pages
                  + 8 * B)
        vmask = verify_mask(ln, t, SMAX, pd)
        b_ms, b_by = bound(nbytes, 4.0 * nvis * D)
        pcases.append(dict(
            T=t, max_abs_err=e, rel_l2_err=rel_t, equal_dense=True,
            ms=cuda_ms(lambda: verify_attention_paged(qt, kpool, vpool, tb,
                                                      ln, pd)),
            plain_ms=cuda_ms(lambda: verify_attention_paged_ref(
                qt, kpool, vpool, tb, ln, pd), iters=5),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=cuda_ms(lambda: _sdpa(qt, gather_view(kpool, tb),
                                             gather_view(vpool, tb), vmask))))
    head = pcases[0]
    rows.append(dict(
        name="verify_attention_paged", route="cuda",
        source="src/repro_torch/csrc/verify_attn_paged.cu",
        replaces="src/repro/kernels/verify_attn/kernel.py:157",
        verify_path=vpath,
        max_abs_err=max(c["max_abs_err"] for c in pcases),
        **{k: head[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                "library_ms")},
        library="pool[tbl] gather + scaled_dot_product_attention (2 calls)",
        shape=f"T=4 q {(B, 4, HQ, D)} pools {tuple(kpool.shape)} "
              f"tbl {tuple(full.shape)} bf16", cases=pcases))

    need = torch.full((B,), S // P, dtype=torch.int64, device=dev)
    tb = table(need)
    o = flash_attention_paged(q, kpool, vpool, tb, pad)
    r = flash_attention_paged_ref(q, kpool, vpool, tb, pad)
    kv_k = gather_view(kpool, tb)[:, :S].contiguous()
    kv_v = gather_view(vpool, tb)[:, :S].contiguous()
    dense = flash_attention(q, kv_k, kv_v, pad)
    torch.cuda.synchronize()
    assert torch.isfinite(o).all(), "flash_attention_paged wrote non-finite"
    assert torch.equal(o, dense), "flash_attention_paged != dense on the view"
    err, rel = hold(o[valid], r[valid], "flash_attention_paged")
    assert not o[~valid].any(), "rows before pad must be zeros"
    pages = (need - pad // P).sum().item()
    nbytes = (2 * (2 * q.numel() + 2 * B * S * HK * D) - 2 * 2 * HK * D
              * pad.sum().item() + 4 * pages + 4 * B)
    b_ms, b_by = bound(nbytes, 4.0 * vis * D)
    rows.append(dict(
        name="flash_attention_paged", route="cuda",
        source="src/repro_torch/csrc/flash_attn_paged.cu",
        replaces="src/repro/kernels/flash_attn/kernel.py:115",
        prefill_path="tensor_core_bf16",
        max_abs_err=err, rel_l2_err=rel, equal_dense=True,
        ms=cuda_ms(lambda: flash_attention_paged(q, kpool, vpool, tb, pad)),
        plain_ms=cuda_ms(lambda: flash_attention_paged_ref(
            q, kpool, vpool, tb, pad), iters=5),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=cuda_ms(lambda: _sdpa(
            q, gather_view(kpool, tb[:, :S // P]),
            gather_view(vpool, tb[:, :S // P]), mask)),
        library="pool[tbl] gather + scaled_dot_product_attention (2 calls)",
        shape=f"q {tuple(q.shape)} pools {tuple(kpool.shape)} bf16, pad>0"))

    rows += _tree_rows(rnd, kc, vc, pad, kpool, vpool, table)

    # ---- extract_pack (exact)
    F_ = GLM["F"]
    T4 = GLM["GAMMA"] + 1
    feats = rnd(B, T4, F_)
    toks = torch.randint(0, 151552, (B, T4), generator=g, device=dev,
                         dtype=torch.int32)
    msk = torch.rand((B, T4), generator=g, device=dev) < 0.6
    got = pack_signals(feats, toks, msk)
    want = extract_pack_ref(feats, toks, msk)
    torch.cuda.synchronize()
    for a, w in zip(got, want):
        assert torch.equal(a, w), "extract_pack is not exact"
    nbytes = 2 * 2 * feats.numel() + 2 * 4 * toks.numel() + msk.numel() + 4 * B
    b_ms, b_by = bound(nbytes, 0.0)
    rows.append(dict(
        name="extract_pack", route="cuda",
        source="src/repro_torch/csrc/extract_pack.cu",
        replaces="src/repro/kernels/extract_pack/kernel.py:46",
        max_abs_err=0.0,
        ms=cuda_ms(lambda: pack_signals(feats, toks, msk), iters=50),
        plain_ms=cuda_ms(lambda: extract_pack_ref(feats, toks, msk), iters=20),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape=f"feats {tuple(feats.shape)} bf16"))
    rows.append(_linear_rows_row(g))
    for row in rows:
        kinds = SHIFT_KINDS_OF[row["name"]]
        row["pad_shift_equal"] = _pad_shift_equal(kinds) if kinds else None
        if row["library_ms"]:
            row["ms_over_library_ms"] = row["ms"] / row["library_ms"]
    emit({"phase": "kernels", "kernels": rows})
    return rows


# the pad-shift placements (repro_torch.obs.cobatch.placed_rows) each
# kernel row is held to; extract_pack and linear_rows have no pad
SHIFT_KINDS_OF = {
    "flash_attention": ("prefill",), "flash_attention_paged": ("prefill_paged",),
    "verify_attention": ("verify4", "verify1"),
    "verify_attention_paged": ("verify_paged4", "verify_paged1"),
    "verify_attention_tree": ("tree",),
    "verify_attention_paged_tree": ("tree_paged",), "extract_pack": (),
    "linear_rows": ()}

# glm4-9b's (name, K, N) of the prefill's products
LINEAR_KN = (("k_proj", 4096, 256), ("q_proj/o_proj", 4096, 4096),
             ("ffn_up/gate", 4096, 13696), ("ffn_down", 13696, 4096),
             ("lm_head", 4096, 151552))
LINEAR_M = (1, 2, 126, 128, 992, 3968)


def _linear_rows_row(g):
    """linear_rows at glm4-9b's (K, N): every row of x gives the same
    row, bit for bit, at each M of LINEAR_M (the first M rows of one x);
    error against float64 on 128 rows and at most 4096 columns; time
    against torch.matmul (the plain version, and the library call) at
    M 3968 and 128.  The row's headline is ffn_down at M 3968 (a refill
    of 8 x 496 rows)."""
    from repro_torch.kernels.linear_rows.ops import k_splits, linear_rows
    from repro_torch.kernels.linear_rows.ref import linear_rows_ref
    dev = torch.device("cuda")
    bf = torch.bfloat16
    cases = []
    for name, k, n in LINEAR_KN:
        x = torch.randn((max(LINEAR_M), k), generator=g, device=dev).to(bf)
        w = (torch.randn((k, n), generator=g, device=dev) / k ** 0.5).to(bf)
        full = linear_rows(x, w)
        for m in LINEAR_M:
            assert torch.equal(linear_rows(x[:m], w), full[:m]), \
                f"linear_rows {name}: rows move with M = {m}"
        cols = slice(0, min(n, 4096))
        want = x[:128].double() @ w[:, cols].double()
        got = full[:128, cols].double()
        torch.cuda.synchronize()
        assert torch.isfinite(full).all(), f"linear_rows {name} non-finite"
        rel = float((got - want).norm() / want.norm())
        assert rel < 3e-3, f"linear_rows {name}: rel L2 {rel} vs float64"
        case = dict(product=name, K=k, N=n, k_splits=k_splits(n, k),
                    rows_equal_across_M=list(LINEAR_M), rel_l2_vs_f64=rel,
                    max_abs_err=float((got - want).abs().max()))
        for m in (max(LINEAR_M), 128):
            xm = x[:m]
            b_ms, b_by = bound(2 * (m * k + k * n + m * n), 2.0 * m * n * k)
            case[f"M{m}"] = dict(
                ms=cuda_ms(lambda: linear_rows(xm, w)),
                plain_ms=cuda_ms(lambda: linear_rows_ref(xm, w)),
                bound_ms=b_ms, bound_by=b_by,
                library_ms=cuda_ms(lambda: torch.matmul(xm, w)))
        cases.append(case)
        del x, w, full
    head = next(c for c in cases if c["product"] == "ffn_down")
    top = head[f"M{max(LINEAR_M)}"]
    return dict(name="linear_rows", route="cuda",
                source="src/repro_torch/csrc/linear_rows.cu",
                replaces="none: no Pallas kernel; the products of "
                         "src/repro/models/attention.py:373 qkv_proj and the "
                         "FFN, which XLA computes",
                max_abs_err=max(c["max_abs_err"] for c in cases),
                rel_l2_err=max(c["rel_l2_vs_f64"] for c in cases),
                **top, library="torch.matmul (also the plain version)",
                shape=f"ffn_down x ({max(LINEAR_M)}, {head['K']}) @ w "
                      f"({head['K']}, {head['N']}) bf16", cases=cases)


def _pad_shift_equal(kinds) -> bool:
    """One lane's prompt (150 rows, glm4-9b heads, bf16) at pads 0, 5,
    17, 31, 32, 100 of batch rows 0 and 40 wider, beside other lanes:
    its rows of each kernel must be equal bit for bit."""
    from repro_torch.obs.cobatch import lane_inputs, pad_shift_departure
    lane = lane_inputs(150, GLM["HQ"], GLM["HK"], GLM["D"], torch.bfloat16,
                       torch.device("cuda"), 81)
    for kind in kinds:
        moved = pad_shift_departure(kind, lane, extras=(0, 40))
        assert moved is None, \
            f"{kind}: a lane's rows moved with its pad at (pad, +) {moved}"
    return True


def _p_bf16_rel_l2(q, k, v, mask, ref, valid) -> float:
    """Relative L2 error, against the plain version, of the same
    attention with P rounded to bf16 before P·V (the row sums kept in
    fp32): what a tensor-core P·V with one bf16 P would read.  The
    kernel splits P into two bf16 halves instead."""
    import math
    g = q.shape[2] // k.shape[2]
    kf = k.float().repeat_interleave(g, dim=2)
    vf = v.float().repeat_interleave(g, dim=2)
    sc = torch.einsum("bthd,bshd->bhts", q.float(), kf) / math.sqrt(q.shape[3])
    sc = sc.masked_fill(~mask[:, None], float("-inf"))
    mx = sc.amax(-1, keepdim=True)
    p = torch.exp(sc - torch.where(torch.isfinite(mx), mx, torch.zeros_like(mx)))
    p = p.masked_fill(~mask[:, None], 0.0)
    den = p.sum(-1, keepdim=True)
    out = torch.einsum("bhts,bshd->bthd", p.to(torch.bfloat16).float(), vf)
    out = (out / torch.where(den > 0, den, torch.ones_like(den)).transpose(1, 2)
           ).to(q.dtype)
    a, b = out[valid].float(), ref[valid].float()
    return float((a - b).norm() / b.norm())


def _tree_rows(rnd, kc, vc, pad, kpool, vpool, table):
    """The verify kernels' tree mode (the target verify of a tree round):
    W = 4 branches of depth 3, T = 13 rows, at the verify shapes above,
    dense and paged (on the paged section's shuffled pools), against the
    plain version; W = 1 bit for bit against the chain kernel and the
    paged tree bit for bit against the dense tree on the gathered view.
    Then a window > 0 sweep at a small width.  The library yardstick is
    scaled_dot_product_attention with the explicit tree mask."""
    from repro_torch.core.paging import gather_view
    from repro_torch.kernels.verify_attn.ops import (verify_attention,
                                                     verify_attention_paged,
                                                     verify_route)
    from repro_torch.kernels.verify_attn.ref import (
        tree_mask, verify_attention_tree_paged_ref, verify_attention_tree_ref)
    dev = kc.device
    B, SMAX, HQ, HK, D, P = (GLM[k] for k in ("B", "SMAX", "HQ", "HK", "D",
                                              "P"))
    W, G = GLM["TREE_W"], GLM["GAMMA"]
    T = W * G + 1
    ln = torch.tensor([600, 517, 812, 1000, 64, 256, 700, 333],
                      dtype=torch.int32, device=dev)
    pd = torch.minimum(pad, ln)
    qt = rnd(B, T, HQ, D)
    tmask = tree_mask(ln, (W, G), SMAX, pd)
    nvis = tmask.sum().item() * HQ
    span = (torch.clamp(ln + T, max=SMAX) - pd).clamp(min=0).sum().item()
    kv_bytes = 2 * 2 * span * HK * D
    b_ms, b_by = bound(2 * 2 * qt.numel() + kv_bytes + 8 * B, 4.0 * nvis * D)

    o = verify_attention(qt, kc, vc, ln, pd, tree=(W, G))
    r = verify_attention_tree_ref(qt, kc, vc, ln, pd, tree=(W, G))
    q1 = qt[:, :G + 1].contiguous()
    one = verify_attention(q1, kc, vc, ln, pd, tree=(1, G))
    chain = verify_attention(q1, kc, vc, ln, pd)
    torch.cuda.synchronize()
    assert torch.isfinite(o).all(), "tree verify wrote non-finite"
    assert torch.equal(one, chain), "tree W=1 != chain kernel"
    err, rel = hold(o, r, "verify_attention tree")
    dense_row = dict(
        name="verify_attention_tree", route="cuda",
        source="src/repro_torch/csrc/verify_attn.cu (prefill_rows.cuh tree "
               "mode)",
        replaces="src/repro/kernels/verify_attn/kernel.py:27",
        verify_path=verify_route(qt.dtype, D),
        max_abs_err=err, rel_l2_err=rel, w1_equal_chain=True,
        ms=cuda_ms(lambda: verify_attention(qt, kc, vc, ln, pd,
                                            tree=(W, G))),
        plain_ms=cuda_ms(lambda: verify_attention_tree_ref(
            qt, kc, vc, ln, pd, tree=(W, G)), iters=5),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=cuda_ms(lambda: _sdpa(qt, kc, vc, tmask)),
        shape=f"tree=({W},{G}) q {tuple(qt.shape)} cache {tuple(kc.shape)} "
              "bf16")

    need = torch.clamp(-(-(ln + T) // P), max=SMAX // P)
    tb = table(need)
    pages = (need - pd // P).clamp(min=0).sum().item()
    po = verify_attention_paged(qt, kpool, vpool, tb, ln, pd, tree=(W, G))
    pr = verify_attention_tree_paged_ref(qt, kpool, vpool, tb, ln, pd,
                                         tree=(W, G))
    kv_k, kv_v = gather_view(kpool, tb), gather_view(vpool, tb)
    pdense = verify_attention(qt, kv_k, kv_v, ln, pd, tree=(W, G))
    torch.cuda.synchronize()
    assert torch.isfinite(po).all(), "paged tree verify wrote non-finite"
    assert torch.equal(po, pdense), "paged tree != dense tree on the view"
    perr, prel = hold(po, pr, "verify_attention_paged tree")
    pb_ms, pb_by = bound(2 * 2 * qt.numel() + kv_bytes + 4 * pages + 8 * B,
                         4.0 * nvis * D)
    paged_row = dict(
        name="verify_attention_paged_tree", route="cuda",
        source="src/repro_torch/csrc/verify_attn_paged.cu "
               "(prefill_rows.cuh tree mode)",
        replaces="src/repro/kernels/verify_attn/kernel.py:134",
        verify_path=verify_route(qt.dtype, D),
        max_abs_err=perr, rel_l2_err=prel, equal_dense=True,
        ms=cuda_ms(lambda: verify_attention_paged(qt, kpool, vpool, tb, ln,
                                                  pd, tree=(W, G))),
        plain_ms=cuda_ms(lambda: verify_attention_tree_paged_ref(
            qt, kpool, vpool, tb, ln, pd, tree=(W, G)), iters=5),
        bound_ms=pb_ms, bound_by=pb_by,
        library_ms=cuda_ms(lambda: _sdpa(qt, gather_view(kpool, tb),
                                         gather_view(vpool, tb), tmask)),
        library="pool[tbl] gather + scaled_dot_product_attention (2 calls)",
        shape=f"tree=({W},{G}) q {tuple(qt.shape)} pools "
              f"{tuple(kpool.shape)} bf16")

    # window > 0 at a small width (glm4-9b has no window): the tree
    # window compares logical positions, so its lower key bound is not
    # the chain's
    g = torch.Generator(device=dev).manual_seed(7)
    sweep = []
    for w, gam, window in ((2, 4, 6), (4, 2, 5), (4, 3, 8), (1, 3, 4)):
        t = w * gam + 1
        b, hq, hk, d, smax, pg = 4, 8, 2, 64, 256, 16
        q = torch.randn((b, t, hq, d), generator=g, device=dev).to(kc.dtype)
        k = torch.randn((b, smax, hk, d), generator=g, device=dev).to(kc.dtype)
        v = torch.randn((b, smax, hk, d), generator=g, device=dev).to(kc.dtype)
        lw = torch.tensor([20, 100, 200, smax - 2], dtype=torch.int32,
                          device=dev)
        pw = torch.tensor([3, 0, 150, 40], dtype=torch.int32, device=dev)
        ow = verify_attention(q, k, v, lw, pw, window=window, tree=(w, gam))
        rw = verify_attention_tree_ref(q, k, v, lw, pw, window=window,
                                       tree=(w, gam))
        tbl = torch.randperm(b * smax // pg, generator=g, device=dev).to(
            torch.int32).reshape(b, smax // pg)
        kp = torch.zeros((b * smax // pg + 1, pg, hk, d), dtype=k.dtype,
                         device=dev)
        vp = torch.zeros_like(kp)
        kp[tbl.long()] = k.reshape(b, smax // pg, pg, hk, d)
        vp[tbl.long()] = v.reshape(b, smax // pg, pg, hk, d)
        opw = verify_attention_paged(q, kp, vp, tbl, lw, pw, window=window,
                                     tree=(w, gam))
        torch.cuda.synchronize()
        assert torch.equal(opw, ow), f"paged tree != dense, window {window}"
        e, rl = hold(ow, rw, f"tree=({w},{gam}) window={window}")
        case = dict(tree=[w, gam], window=window, max_abs_err=e,
                    rel_l2_err=rl, paged_equal_dense=True)
        if w == 1:
            assert torch.equal(ow, verify_attention(q, k, v, lw, pw,
                                                    window=window)), \
                f"tree W=1 != chain kernel, window {window}"
            case["w1_equal_chain"] = True
        sweep.append(case)
    dense_row["window_sweep"] = sweep
    return [dense_row, paged_row]


# ------------------------------------------------------ model helpers
def _requests(rng, n, lo, hi, new, vocab):
    from repro_torch.serving.request import Request
    return [Request(prompt=rng.integers(0, vocab, size=int(rng.integers(lo, hi + 1))).tolist(),
                    max_new_tokens=new) for _ in range(n)]


def phase_ladder():
    from repro_torch.configs import get
    from repro_torch.core import eagle
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.policy import ServingConfig
    cfg = dataclasses.replace(get("glm4-9b"), num_layers=2)
    dcfg = eagle.draft_config(cfg)
    dev = torch.device("cuda")
    params = T.init(cfg, 1, device=dev)
    dparams = eagle.draft_init(dcfg, 2, device=dev)
    streams = {}
    for k in (8, 0):
        eng = ServingEngine(cfg, params, dcfg, dparams, batch_size=8,
                            max_len=256, gamma=3, superstep_rounds=k,
                            device=dev)
        reqs = _requests(np.random.default_rng(3), 8, 16, 128, 24,
                         cfg.vocab_size)
        eng.serve_wave(reqs)
        streams[k] = [list(r.generated) for r in reqs]
        assert all(len(s) == 24 for s in streams[k])
    assert streams[8] == streams[0], "superstep stream != stepwise stream"
    paged = {}
    for k in (8, 0):
        conf = ServingConfig(batch_size=8, max_len=256, gamma=3,
                             superstep_rounds=k, page_size=GLM["P"])
        eng = ServingEngine(cfg, params, dcfg, dparams, config=conf,
                            device=dev)
        reqs = _requests(np.random.default_rng(3), 8, 16, 128, 24,
                         cfg.vocab_size)
        eng.serve_wave(reqs)
        paged[k] = [list(r.generated) for r in reqs]
        eng.release_prefix_cache()
        eng.allocator.assert_clean()
    assert paged[8] == streams[8], "paged stream != dense stream"
    assert paged[0] == paged[8], "paged stepwise != paged superstep"
    # tree speculation, W = 2: stepwise == superstep (waves of 4) ==
    # stream (K 8 and 3)
    tree = {}
    for mode, k in (("wave", 0), ("wave", 8), ("stream", 8), ("stream", 3)):
        conf = ServingConfig(batch_size=4, max_len=256, gamma=3,
                             superstep_rounds=k, tree_width=2)
        eng = ServingEngine(cfg, params, dcfg, dparams, config=conf,
                            device=dev)
        reqs = _requests(np.random.default_rng(3), 8, 16, 128, 24,
                         cfg.vocab_size)
        if mode == "wave":
            eng.serve_wave(reqs[:4])
            eng.serve_wave(reqs[4:])
        else:
            eng.serve_stream(iter(reqs))
        tree[(mode, k)] = [list(r.generated) for r in reqs]
        assert all(len(s_) == 24 for s_ in tree[(mode, k)])
    ref = tree[("wave", 0)]
    assert all(v == ref for v in tree.values()), \
        "tree W=2: stepwise / superstep / stream / wave streams differ"
    # the card's prefill against the CPU's (plain kernels) on one prompt
    toks = torch.tensor([np.random.default_rng(4).integers(
        0, cfg.vocab_size, size=48).tolist()], dtype=torch.int32)
    pad = torch.tensor([5], dtype=torch.int32)
    gpu = T.prefill(cfg, params, toks.to(dev), pad=pad.to(dev))["logits"]
    gpu = gpu.cpu()
    params.to("cpu")            # moves the module's weights (in place)
    cpu = T.prefill(cfg, params, toks, pad=pad)["logits"]
    assert torch.isfinite(gpu).all()
    rel = float((gpu - cpu).norm() / cpu.norm())
    assert rel < 2e-2, f"card vs CPU prefill logits rel err {rel}"
    emit({"phase": "ladder", "layers": 2, "requests": 8, "new_tokens": 24,
          "streams_equal": True, "paged_streams_equal": True,
          "tree2_stepwise_superstep_stream_wave_equal": True,
          "tree2_requests_equal_chain": sum(
              a == b for a, b in zip(ref, streams[8])),
          "prefill_logits_rel_err_vs_cpu": rel,
          "argmax_equal": bool(gpu.argmax() == cpu.argmax())})
    del params, dparams
    torch.cuda.empty_cache()


def _kernel_fns():
    from repro_torch.kernels.extract_pack.ops import pack_signals
    from repro_torch.kernels.flash_attn.ops import (flash_attention,
                                                    flash_attention_paged)
    from repro_torch.kernels.linear_rows.ops import linear_rows
    from repro_torch.kernels.verify_attn.ops import (verify_attention,
                                                     verify_attention_paged)
    return {"flash_attention": flash_attention,
            "verify_attention": verify_attention,
            "extract_pack": pack_signals,
            "verify_attention_paged": verify_attention_paged,
            "flash_attention_paged": flash_attention_paged,
            "linear_rows": linear_rows}


def _serve_requests(vocab):
    """16 requests, prompts 64-512, 64 new tokens; 1, 3, 5 and 7 (all in
    the first wave) share one prompt."""
    reqs = _requests(np.random.default_rng(5), 16, 64, 512, 64, vocab)
    for i in (3, 5, 7):
        reqs[i].prompt = list(reqs[1].prompt)
    return reqs


def _timed_serve(eng, reqs):
    """serve_stream with every kernel's launch count zeroed just before
    and read just after, and the prefill and superstep ops timed on the
    host clock around a synchronize.  Returns (summary, launches)."""
    from repro_torch.core import eagle
    timed = {"prefill": [], "superstep": []}

    def timing(name, fn):
        def run(*a, **kw):
            torch.cuda.synchronize()
            s = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - s) * 1e3
            # prefill: [rows, width, ms] (a[0] is the token batch)
            timed[name].append([*a[0].shape, ms] if name == "prefill" else ms)
            return out
        return run

    eng._prefill = timing("prefill", eng._prefill)
    eng._superstep = timing("superstep", eng._superstep)
    cfg = eng.cfg
    fns = _kernel_fns()
    torch.cuda.reset_peak_memory_stats()
    for fn in fns.values():
        fn.launches = 0
        if hasattr(fn, "tree_launches"):
            fn.tree_launches = 0
    eng.serve_stream(iter(reqs))
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in fns.items()}
    for name in ("verify_attention", "verify_attention_paged"):
        launches[name + "_tree"] = fns[name].tree_launches
    assert all(len(r.generated) == 64 and r.finish_t is not None
               for r in reqs), "a request did not finish with its tokens"
    assert all(0 <= t < cfg.vocab_size for r in reqs for t in r.generated)
    st = eng.stats
    summary = {
        "model": cfg.name, "layers": cfg.num_layers,
        "params_B": round(cfg.param_count() / 1e9, 3),
        "draft_params_B": round(eagle.draft_param_count(eng.dcfg) / 1e9, 3),
        "requests": len(reqs),
        "tokens_out": st.tokens_out, "wall_s": st.wall_s,
        "tokens_per_s": st.throughput,
        "prefill_rows_width_ms": timed["prefill"],
        "superstep_ms_median": statistics.median(timed["superstep"]),
        "superstep_ms": timed["superstep"],
        "supersteps": st.dispatches, "rounds": st.steps,
        "spec_rounds": st.spec_steps,
        "mean_accept_len": st.accept_len,
        "host_syncs": eng.host_syncs,
        "host_syncs_per_superstep": eng.host_syncs / max(st.dispatches, 1),
        "tree_width": eng.tree_width,
        "signal_windows": eng.extractor.store.total_added,
        "max_memory_allocated_GB": torch.cuda.max_memory_allocated() / 1e9,
        "launches": launches}
    return summary, launches


def phase_serve():
    from repro_torch.configs import get
    from repro_torch.core import eagle
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.core.signals import SignalExtractor, SignalStore
    cfg = get("glm4-9b")
    dcfg = eagle.draft_config(cfg)
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    params = T.init(cfg, 0, device=dev)
    dparams = eagle.draft_init(dcfg, 1, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    eng = ServingEngine(cfg, params, dcfg, dparams, batch_size=8,
                        max_len=1024, gamma=GLM["GAMMA"], superstep_rounds=8,
                        device=dev, extractor=SignalExtractor(SignalStore()))
    reqs = _serve_requests(cfg.vocab_size)
    summary, launches = _timed_serve(eng, reqs)
    for name in ("flash_attention", "verify_attention", "extract_pack"):
        assert launches[name] > 0, launches
    # every prefill op: q, k, v, o, gate, up and down of each layer, and
    # the last-position lm_head
    assert launches["linear_rows"] == len(summary["prefill_rows_width_ms"]) \
        * (7 * cfg.num_layers + 1), launches
    emit({"phase": "serve", **summary, "init_s": round(init_s, 2),
          "nvidia_smi": smi()})
    return launches, eng, summary, [list(r.generated) for r in reqs]


def _first_flip(eng, reqs, streams, ref_streams):
    """The first request whose stream differs from ``ref_streams``, the
    step where it flips, and the target's top-2 logit gap there: one
    prefill of prompt + the common prefix."""
    from repro_torch.models import transformer as T
    i = next(n for n, (a, b) in enumerate(zip(streams, ref_streams))
             if a != b)
    a, b = streams[i], ref_streams[i]
    j = next(n for n in range(len(a)) if a[n] != b[n])
    seq = torch.tensor([reqs[i].prompt + b[:j]], dtype=torch.int32,
                       device=eng.device)
    top = T.prefill(eng.cfg, eng.params, seq)["logits"][0].topk(2).values
    return {"request": i, "step": j, "top2_logit_gap": float(top[0] - top[1])}


def phase_cobatch(eng):
    """One prompt of the serve (its shortest) refilled alone and beside
    the serve's longest prompt, packed by the serving engine's own refill
    (``_refill_arrays``: another left pad, width and row count), through
    glm4-9b at full depth: the first op whose rows of that prompt depart
    (layer by layer: hidden states, K/V rows, last-position logits), or
    none, and every op that departs with its inputs' rows made equal
    (``repro_torch.obs.cobatch``).  No op may depart, alone or through
    its inputs.  The same steps with torch.matmul under
    ``allow_bf16_reduced_precision_reduction = False`` are reported
    beside it."""
    from repro_torch.obs.cobatch import cobatch_diff
    from repro_torch.serving.request import Request
    prompts = sorted((r.prompt for r in _serve_requests(eng.cfg.vocab_size)),
                     key=len)
    short, long_ = prompts[0], prompts[-1]

    def batch(ps):
        reqs = [Request(prompt=list(p), max_new_tokens=1) for p in ps]
        for i, r in enumerate(reqs):
            r.sid = i
        return eng._refill_arrays(list(enumerate(reqs)))[:2]

    a_, b_ = (*batch([short]), 0), (*batch([long_, short]), 1)
    # the library alone, with cuBLAS's reduced-precision bf16 reductions
    # off: does that setting pin its rows at these two row counts?
    flag = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    try:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False
        lib = cobatch_diff(eng.cfg, eng.params, a_, b_, linear=torch.matmul)
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            flag
    d = cobatch_diff(eng.cfg, eng.params, a_, b_)
    emit({"phase": "cobatch", "verdict": d["first_departing_op"] or "none",
          **d, "departing_alone_count": len(d["departing_alone"]),
          "departing_alone": d["departing_alone"][:12],
          "torch_matmul_bf16_reduction_off": {
              "verdict": lib["first_departing_op"] or "none",
              "departing_alone_count": len(lib["departing_alone"]),
              "departing_alone": lib["departing_alone"][:12],
              "logits_max_abs_diff": lib["logits_max_abs_diff"]}})
    assert d["first_departing_op"] is None, \
        f"{d['first_departing_op']} departs with the refill batch"
    assert not d["departing_alone"], d["departing_alone"]
    assert d["kv_rows_equal"] and d["hidden_equal"] and d["logits_equal"]


def phase_paged_serve(dense_eng, dense, dense_streams, blocking):
    """The serve on a paged engine (page 16) with the same weights and
    requests: first with the dense footprint of pages, where the schedule
    must be the dense serve's exactly, then with half of it, whose engine
    is then profiled.  Each engine is freed before the next is built.
    Returns the half run's launches."""
    from repro_torch.core.signals import SignalExtractor, SignalStore
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.policy import ServingConfig
    for name, num_pages in (("dense_footprint", 512), ("half", 256)):
        conf = ServingConfig(batch_size=8, max_len=1024, gamma=GLM["GAMMA"],
                             superstep_rounds=8, page_size=GLM["P"],
                             num_pages=num_pages)
        eng = ServingEngine(dense_eng.cfg, dense_eng.params, dense_eng.dcfg,
                            dense_eng.dparams, config=conf,
                            device=dense_eng.device,
                            extractor=SignalExtractor(SignalStore()))
        reqs = _serve_requests(eng.cfg.vocab_size)
        summary, launches = _timed_serve(eng, reqs)
        st = eng.stats
        streams = [list(r.generated) for r in reqs]
        assert st.pages_peak <= num_pages
        assert st.prefix_hits > 0, "the shared prompt was not adopted"
        eng.release_prefix_cache()
        eng.allocator.assert_clean()
        for k in ("verify_attention_paged", "flash_attention_paged",
                  "verify_attention", "extract_pack"):
            assert launches[k] > 0, launches
        assert launches["flash_attention"] == 0, launches
        emit({"phase": "paged_serve", "run": name, "page_size": GLM["P"],
              "num_pages": num_pages, **summary,
              "pages_peak": st.pages_peak,
              "admission_deferrals": st.admission_deferrals,
              "prefix_hits": st.prefix_hits,
              "prefix_tokens_saved": st.prefix_tokens_saved,
              "streams_equal_dense": streams == dense_streams,
              "requests_equal_dense": sum(
                  a == b for a, b in zip(streams, dense_streams)),
              **({"first_flip": _first_flip(eng, reqs, streams,
                                            dense_streams)}
                 if streams != dense_streams else {}),
              "host_syncs_per_superstep_dense":
                  dense["host_syncs_per_superstep"],
              "nvidia_smi": smi()})
        # the half pool's deferrals move prompts to other refill batches;
        # no op of the prefill departs with its batch (cobatch), so its
        # streams hold as the dense footprint's do
        assert streams == dense_streams, f"{name}: paged streams != dense"
        if name == "half":
            assert st.admission_deferrals > 0, "the guard never deferred"
        if name == "dense_footprint":
            assert st.admission_deferrals == 0
            assert st.dispatches == dense["supersteps"]
            assert eng.host_syncs == dense["host_syncs"], \
                (eng.host_syncs, dense["host_syncs"])
        if name == "half":
            half = launches
            profile_against(eng, "paged", blocking)
        del eng
        torch.cuda.empty_cache()
    return half


def phase_tree_serve(dense_eng, dense, dense_streams, blocking):
    """Greedy tree speculation on the serve phase's engine configuration,
    weights and requests (glm4-9b at full width and depth), W = 1 and
    W = 4.  W = 1 must be the chain serve exactly: streams, supersteps
    and host syncs.  W = 4 commits the target's greedy tokens like the
    chain, but its verify scores 13 rows where the chain scores 4, so
    bf16 products round differently and a near-tie of the top-2 logits
    can flip; the phase reports how many streams differ and the gap at
    the first flip.  Random weights: the draft's proposals are (almost)
    never accepted, so the mean accepted length is about 1.0 and the
    winning branch is 0.  Each engine is profiled right after its serve
    and freed before the next is built.  Returns {W: (launches,
    streams)}."""
    from repro_torch.core.signals import SignalExtractor, SignalStore
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.policy import ServingConfig
    out = {}
    for width in (1, GLM["TREE_W"]):
        conf = ServingConfig(batch_size=8, max_len=1024, gamma=GLM["GAMMA"],
                             superstep_rounds=8, tree_width=width)
        eng = ServingEngine(dense_eng.cfg, dense_eng.params, dense_eng.dcfg,
                            dense_eng.dparams, config=conf,
                            device=dense_eng.device,
                            extractor=SignalExtractor(SignalStore()))
        reqs = _serve_requests(eng.cfg.vocab_size)
        summary, launches = _timed_serve(eng, reqs)
        st = eng.stats
        streams = [list(r.generated) for r in reqs]
        n_layers = eng.cfg.num_layers
        # every target verify of a speculative round is one tree-mode
        # launch per layer; plain rounds and draft calls use the chain
        assert launches["verify_attention_tree"] == n_layers * st.spec_steps, \
            (launches, st.spec_steps)
        assert launches["verify_attention_paged"] == 0, launches
        for k in ("flash_attention", "verify_attention", "extract_pack"):
            assert launches[k] > 0, launches
        diff = [i for i, (a, b) in enumerate(zip(streams, dense_streams))
                if a != b]
        row = {"phase": "tree_serve", "tree_width": width, **summary,
               "streams_differing_from_chain": len(diff),
               "host_syncs_per_superstep_chain":
                   dense["host_syncs_per_superstep"],
               "tokens_per_s_chain": dense["tokens_per_s"],
               "superstep_ms_median_chain": dense["superstep_ms_median"],
               "note": "random weights: mean accepted length ~1.0",
               "nvidia_smi": smi()}
        if width == 1:
            assert streams == dense_streams, "tree W=1 streams != chain"
            assert st.dispatches == dense["supersteps"]
            assert eng.host_syncs == dense["host_syncs"], \
                (eng.host_syncs, dense["host_syncs"])
        else:
            assert summary["host_syncs_per_superstep"] <= \
                dense["host_syncs_per_superstep"], "tree serve syncs more"
            if diff:
                row["first_flip"] = _first_flip(eng, reqs, streams,
                                                dense_streams)
        out[width] = (launches, streams)
        emit(row)
        profile_against(eng, f"tree W={width}", blocking)
        del eng
        torch.cuda.empty_cache()
    return out


def phase_paged_tree_serve(dense_eng, dense, dense_streams, tree_streams,
                           blocking):
    """Greedy tree speculation over paged KV (page 16) on the serve
    phase's weights and requests: W = 1 and W = 4 with the dense
    footprint of 512 pages, then W = 4 with 256.  The target verify of
    every speculative round is one launch per layer of the paged kernel
    in tree mode, and no dense kernel verifies a target block; the draft
    attends through the paged kernel in chain mode (one extend and
    W * gamma proposes a round), and the dense verify kernel runs once
    per prefill op, for the refill's draft seeding on its dense staging
    cache.  With 512 pages W = 1 must be the chain serve (streams,
    supersteps, host syncs) and W = 4 the dense W = 4 tree serve
    (streams); with 256 the tree's reservation (gamma * W + 1 = 13 rows
    where the chain reserves 4) makes the guard defer.  No page leaks
    after a drain.  The W = 4 full-pool engine is profiled.  Each engine
    is freed before the next is built.  Returns the W = 4 full-pool
    launches."""
    from repro_torch.core.signals import SignalExtractor, SignalStore
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.policy import ServingConfig
    W4, G = GLM["TREE_W"], GLM["GAMMA"]
    out = None
    for width, num_pages in ((1, 512), (W4, 512), (W4, 256)):
        conf = ServingConfig(batch_size=8, max_len=1024, gamma=G,
                             superstep_rounds=8, page_size=GLM["P"],
                             num_pages=num_pages, tree_width=width)
        eng = ServingEngine(dense_eng.cfg, dense_eng.params, dense_eng.dcfg,
                            dense_eng.dparams, config=conf,
                            device=dense_eng.device,
                            extractor=SignalExtractor(SignalStore()))
        reqs = _serve_requests(eng.cfg.vocab_size)
        summary, launches = _timed_serve(eng, reqs)
        st = eng.stats
        streams = [list(r.generated) for r in reqs]
        eng.release_prefix_cache()
        eng.allocator.assert_clean()
        assert st.pages_peak <= num_pages
        n_layers = eng.cfg.num_layers
        n_ops = len(summary["prefill_rows_width_ms"])
        draft_paged = (launches["verify_attention_paged"]
                       - launches["verify_attention_paged_tree"])
        assert launches["verify_attention_paged_tree"] == \
            n_layers * st.spec_steps, (launches, st.spec_steps)
        assert launches["verify_attention_tree"] == 0, launches
        assert draft_paged == st.spec_steps * (1 + width * G), launches
        assert launches["verify_attention"] == n_ops, (launches, n_ops)
        assert launches["flash_attention_paged"] == n_layers * n_ops, launches
        assert launches["flash_attention"] == 0, launches
        assert launches["extract_pack"] > 0, launches
        row = {"phase": "paged_tree_serve", "tree_width": width,
               "page_size": GLM["P"], "num_pages": num_pages, **summary,
               "pages_peak": st.pages_peak,
               "admission_deferrals": st.admission_deferrals,
               "prefix_hits": st.prefix_hits,
               "reservation_block_rows": G * width + 1,
               "draft_attention": "verify_attention_paged, chain mode: "
                                  f"{draft_paged} launches",
               "dense_verify_launches_refill_seeding":
                   launches["verify_attention"],
               "streams_differing_from_chain": sum(
                   a != b for a, b in zip(streams, dense_streams)),
               "streams_differing_from_dense_tree": sum(
                   a != b for a, b in zip(streams, tree_streams[width])),
               "tokens_per_s_chain": dense["tokens_per_s"],
               "superstep_ms_median_chain": dense["superstep_ms_median"],
               "note": "random weights: mean accepted length ~1.0",
               "nvidia_smi": smi()}
        if streams != tree_streams[width]:
            row["first_flip_vs_dense_tree"] = _first_flip(
                eng, reqs, streams, tree_streams[width])
        emit(row)
        # at 256 pages the guard defers, so prompts meet other refill
        # batches; no prefill op departs with its batch (cobatch)
        assert streams == tree_streams[width], \
            f"paged tree W={width} at {num_pages} pages != dense tree"
        if num_pages == 512:
            assert st.admission_deferrals == 0
        else:
            assert st.admission_deferrals > 0, "the guard never deferred"
        if width == 1:
            assert streams == dense_streams, "paged tree W=1 != chain"
            assert st.dispatches == dense["supersteps"]
            assert eng.host_syncs == dense["host_syncs"], \
                (eng.host_syncs, dense["host_syncs"])
        if width == W4 and num_pages == 512:
            out = launches
            profile_against(eng, f"paged tree W={W4}", blocking)
        del eng
        torch.cuda.empty_cache()
    return out


def _kernel_class(name: str) -> str:
    n = name.lower()
    if "attn_rows" in n or "mma_rows" in n:
        return "attention kernels (port)"
    if "extract_pack" in n:
        return "extract_pack (port)"
    if "linear_rows" in n:
        return "linear_rows (port)"
    if "gemm" in n or "gemv" in n or "cutlass" in n or "xmma" in n \
            or "splitk" in n or "nvjet" in n:   # nvjet: cuBLAS's sm90 GEMMs
        return "matmul (cuBLAS)"
    return "other (elementwise, copies, reductions)"


def _blocking(name: str) -> bool:
    """A CUDA runtime call or copy that makes the host wait."""
    return "Synchronize" in name or "Pageable" in name


def phase_profile(eng, which="dense"):
    """Where a serve's time goes: ``torch.profiler`` over a short stream
    on a served engine (8 requests, prompt 256, 17 new tokens: one
    prologue prefill and two supersteps), with the count of host-blocking
    CUDA calls.  Returns that count."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    reqs = _requests(np.random.default_rng(6), 8, 256, 256, 17,
                     eng.cfg.vocab_size)
    torch.cuda.synchronize()
    syncs0 = eng.host_syncs
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.serve_stream(iter(reqs))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]

    def dev_ms(e):
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        return us / 1e3

    busy = sum(dev_ms(e) for e in kernels)
    classes = {}
    for e in kernels:
        c = classes.setdefault(_kernel_class(e.key), [0.0, 0])
        c[0] += dev_ms(e)
        c[1] += e.count
    top = sorted(kernels, key=dev_ms, reverse=True)[:10]
    blocking = {e.key: e.count for e in events
                if _blocking(e.key)}
    emit({"phase": "profile", "engine": which, "requests": len(reqs),
          "host_syncs": eng.host_syncs - syncs0, "blocking_calls": blocking,
          "wall_ms": wall_ms,
          "device_busy_ms": busy, "idle_share": 1.0 - busy / wall_ms,
          "classes": {k: {"ms": v[0], "launches": v[1]}
                      for k, v in sorted(classes.items())},
          "top": [{"kernel": e.key[:90], "ms": dev_ms(e), "count": e.count}
                  for e in top]})
    return blocking


def profile_against(eng, which, blocking):
    """Profile a served engine and hold it to the chain's blocking
    calls: no paged or tree serve may block the host more."""
    more = phase_profile(eng, which)
    assert all(n <= blocking.get(k, 0) for k, n in more.items()), \
        f"{which} serve blocks the host more: {more} vs {blocking}"


def main():
    phase_env()
    rows = phase_kernels()
    phase_ladder()
    launches, eng, dense, dense_streams = phase_serve()
    phase_cobatch(eng)
    blocking = phase_profile(eng, "dense")
    paged = phase_paged_serve(eng, dense, dense_streams, blocking)
    for name in ("verify_attention_paged", "flash_attention_paged"):
        launches[name] = paged[name]
    trees = phase_tree_serve(eng, dense, dense_streams, blocking)
    launches["verify_attention_tree"] = \
        trees[GLM["TREE_W"]][0]["verify_attention_tree"]
    ptree = phase_paged_tree_serve(
        eng, dense, dense_streams, {w: s for w, (_, s) in trees.items()},
        blocking)
    launches["verify_attention_paged_tree"] = \
        ptree["verify_attention_paged_tree"]
    del eng, trees
    for row in rows:
        row["launches"] = launches[row["name"]]
        assert row["launches"] > 0, f"{row['name']} had no main-path launch"
    emit({"kernels": [{k: row[k] for k in (
        "name", "route", "source", "replaces", "launches", "max_abs_err",
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
        for row in rows]})
    print(smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
