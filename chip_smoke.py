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
           computing the same function.
  ladder   glm4-9b width at 2 layers, random weights: the same 8
           requests through superstep_rounds=8 and =0 give equal greedy
           streams, and the card's prefill logits agree with the CPU's.
  serve    glm4-9b at full width and depth, random bf16 weights from a
           seeded generator: ServingEngine (batch 8, max_len 1024,
           gamma 3, K=8, greedy, no drafter) serves 16 requests (prompts
           64-512, 64 new tokens) with serve_stream.  Every kernel's
           launch count is zeroed just before and read just after.
  profile  torch.profiler over a short serve on the same engine: device
           busy share and device time by kernel class.

Then the kernel table (``{"kernels": [...]}``), the nvidia-smi line, and
last ``{"ok": true, "device": {...}}``.  Any failure raises and exits
non-zero before the last line.  Without a CUDA card it exits non-zero
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
GLM = dict(B=8, S=512, SMAX=1024, HQ=32, HK=2, D=128, F=3 * 4096, GAMMA=3)


def emit(obj):
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
    from repro_torch.kernels.verify_attn.ops import verify_attention
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
        max_abs_err=err, rel_l2_err=rel,
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
    rows.append(dict(
        name="verify_attention", route="cuda",
        source="src/repro_torch/csrc/verify_attn.cu",
        replaces="src/repro/kernels/verify_attn/kernel.py:214",
        max_abs_err=max(c["max_abs_err"] for c in cases),
        **{k: head[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                "library_ms")},
        shape=f"T=4 q {(B, 4, HQ, D)} cache {tuple(kc.shape)} bf16",
        cases=cases))

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
    emit({"phase": "kernels", "kernels": rows})
    return rows


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
          "streams_equal": True, "prefill_logits_rel_err_vs_cpu": rel,
          "argmax_equal": bool(gpu.argmax() == cpu.argmax())})
    del params, dparams
    torch.cuda.empty_cache()


def phase_serve():
    from repro_torch.configs import get
    from repro_torch.core import eagle
    from repro_torch.kernels.extract_pack.ops import pack_signals
    from repro_torch.kernels.flash_attn.ops import flash_attention
    from repro_torch.kernels.verify_attn.ops import verify_attention
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
    store = SignalStore()
    eng = ServingEngine(cfg, params, dcfg, dparams, batch_size=8,
                        max_len=1024, gamma=GLM["GAMMA"], superstep_rounds=8,
                        device=dev, extractor=SignalExtractor(store))
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
    reqs = _requests(np.random.default_rng(5), 16, 64, 512, 64,
                     cfg.vocab_size)
    torch.cuda.reset_peak_memory_stats()
    for fn in (flash_attention, verify_attention, pack_signals):
        fn.launches = 0
    eng.serve_stream(iter(reqs))
    torch.cuda.synchronize()
    launches = {"flash_attention": flash_attention.launches,
                "verify_attention": verify_attention.launches,
                "extract_pack": pack_signals.launches}
    assert all(len(r.generated) == 64 and r.finish_t is not None
               for r in reqs), "a request did not finish with its tokens"
    assert all(0 <= t < cfg.vocab_size for r in reqs for t in r.generated)
    assert all(n > 0 for n in launches.values()), launches
    st = eng.stats
    emit({"phase": "serve", "model": cfg.name, "layers": cfg.num_layers,
          "params_B": round(cfg.param_count() / 1e9, 3),
          "draft_params_B": round(eagle.draft_param_count(dcfg) / 1e9, 3),
          "init_s": round(init_s, 2), "requests": len(reqs),
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
          "signal_windows": store.total_added,
          "max_memory_allocated_GB": torch.cuda.max_memory_allocated() / 1e9,
          "launches": launches, "nvidia_smi": smi()})
    return launches, eng


def _kernel_class(name: str) -> str:
    n = name.lower()
    if "attn_rows" in n:
        return "attention kernels (port)"
    if "extract_pack" in n:
        return "extract_pack (port)"
    if "gemm" in n or "gemv" in n or "cutlass" in n or "xmma" in n \
            or "splitk" in n:
        return "matmul (cuBLAS)"
    return "other (elementwise, copies, reductions)"


def phase_profile(eng):
    """Where a serve's time goes: ``torch.profiler`` over a short stream
    on the served engine (8 requests, prompt 256, 17 new tokens: one
    prologue prefill and two supersteps)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    reqs = _requests(np.random.default_rng(6), 8, 256, 256, 17,
                     eng.cfg.vocab_size)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.serve_stream(iter(reqs))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]

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
    emit({"phase": "profile", "requests": len(reqs), "wall_ms": wall_ms,
          "device_busy_ms": busy, "idle_share": 1.0 - busy / wall_ms,
          "classes": {k: {"ms": v[0], "launches": v[1]}
                      for k, v in sorted(classes.items())},
          "top": [{"kernel": e.key[:90], "ms": dev_ms(e), "count": e.count}
                  for e in top]})


def main():
    phase_env()
    rows = phase_kernels()
    phase_ladder()
    launches, eng = phase_serve()
    phase_profile(eng)
    del eng
    for row in rows:
        row["launches"] = launches[row["name"]]
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
