"""How far the draft's training moves between seeds, against what the
attention backward kernel changes: one tree of the port at a time.

Serves chip_smoke.py's 16 requests with glm4-9b (random weights from
seeds 0 and 1, as chip_smoke.py's serve phase) and collects their signal
windows, then runs chip_smoke.py's train cycle (``TRAIN_STEPS`` adamw
steps) once per trainer seed on those windows, each from the same draft,
and replays the requests with each trained draft.  Seeds change only
the order the windows are drawn in, so the spread of the last-10 loss
and the accepted length over seeds is the noise that one run of the
train phase carries.  Before that it holds the bf16 ``flash_attention_bwd``
at the train phase's shape (batch 8, S 62, 32/2 heads, D 128) against
its float64 plain version on a few random inputs: the relative L2 error
of each gradient and its bias, the error's projection on the gradient
(<got - want, want> / <want, want>), which a gradient scaled by 1 + e
puts at e while rounding keeps it near 0.  With ``--backward plain`` the
train cycles take their attention gradient from the float64 plain
version (``flash_attention_bwd_ref``, rounded once to bf16) in place of
the kernel: the exact gradient's own spread over seeds, against which
both kernels' runs can be read.

Needs one CUDA card.  Run from the root of a checkout, once per tree:

    python3 scripts/bwd_train_spread.py --out spread_change.json
    python3 scripts/bwd_train_spread.py --src OTHER/src --out spread_other.json

``--src`` picks the ``repro_torch`` package to load (default: this
checkout's ``src``); chip_smoke.py's helpers always come from this
checkout.  Prints one JSON line per seed and a summary line last.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def grad_errors(seeds) -> dict:
    """Relative L2 error and bias of dq, dk, dv against the float64 plain
    version, per input seed, at the train phase's attention shape."""
    from repro_torch.kernels.flash_attn.ops import (flash_attention,
                                                    flash_attention_bwd)
    from repro_torch.kernels.flash_attn.ref import flash_attention_bwd_ref
    import chip_smoke as smoke
    b, hq, hk, d = (smoke.GLM[k] for k in ("B", "HQ", "HK", "D"))
    s = smoke.GLM["TRAIN_WINDOW"] - 1
    dev = torch.device("cuda")
    out = {}
    for seed in seeds:
        g = torch.Generator(device=dev).manual_seed(seed)
        q, do = (torch.randn((b, s, hq, d), generator=g, device=dev)
                 .to(torch.bfloat16) for _ in range(2))
        k, v = (torch.randn((b, s, hk, d), generator=g, device=dev)
                .to(torch.bfloat16) for _ in range(2))
        o, lse = flash_attention(q, k, v, return_lse=True)
        got = flash_attention_bwd(q, k, v, o, do, lse)
        want = flash_attention_bwd_ref(*(t.double() for t in
                                         (q, k, v, o, do, lse)))
        row = {}
        for name, x, y in zip(("dq", "dk", "dv"), got, want):
            e = x.double() - y
            row[name] = {"rel_l2": float(e.norm() / y.norm()),
                         "bias": float((e * y).sum() / (y * y).sum())}
        out[seed] = row
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(HERE, "src"))
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3, 4])
    ap.add_argument("--out", default=None, help="also write the lines here")
    ap.add_argument("--backward", choices=("kernel", "plain"),
                    default="kernel", help="the train cycles' attention "
                    "backward: the CUDA kernel or the float64 plain version")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bwd_train_spread: no CUDA device", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, os.path.abspath(args.src))
    sys.path.insert(1, HERE)
    import repro_torch
    import chip_smoke as smoke
    from repro_torch.configs import get
    from repro_torch.core import eagle
    from repro_torch.core.signals import SignalExtractor, SignalStore
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.training.draft_trainer import DraftTrainer
    lines = []

    def emit(obj):
        lines.append(obj)
        print(json.dumps(obj), flush=True)

    # a namespace package: one tree's only, never two merged
    package = list(repro_torch.__path__)
    assert len(package) == 1, package
    dev = torch.device("cuda")
    emit({"package": package[0], "backward": args.backward,
          "device": torch.cuda.get_device_name(0), "nvidia_smi": smoke.smi(),
          "grad_errors_S62": grad_errors((0, 1, 2))})
    if args.backward == "plain":
        # FlashAttentionFn.backward looks the name up in its module
        from repro_torch.kernels.flash_attn import ops, ref
        ops.flash_attention_bwd = ref.flash_attention_bwd_ref
    cfg = get("glm4-9b")
    dcfg = eagle.draft_config(cfg)
    params = T.init(cfg, 0, device=dev)
    dparams = eagle.draft_init(dcfg, 1, device=dev)

    def engine(draft, extractor=None):
        return ServingEngine(cfg, params, dcfg, draft, batch_size=8,
                             max_len=1024, gamma=smoke.GLM["GAMMA"],
                             superstep_rounds=8, device=dev,
                             extractor=extractor)

    eng = engine(dparams, SignalExtractor(SignalStore()))
    reqs = smoke._serve_requests(cfg.vocab_size)
    served, _ = smoke._timed_serve(eng, reqs)
    streams = [list(r.generated) for r in reqs]
    batches = eng.extractor.store.drain()
    del eng
    torch.cuda.empty_cache()
    runs = []
    for seed in args.seeds:
        trainer = DraftTrainer(cfg, dcfg, params["embed"], device=dev)
        res = trainer.train_cycle(dparams, batches, epochs=2,
                                  min_steps=smoke.TRAIN_STEPS, seed=seed)
        losses = [e["loss"] for e in trainer.log]
        eng = engine(res["dparams"], SignalExtractor(SignalStore()))
        reqs = smoke._serve_requests(cfg.vocab_size)
        replay, _ = smoke._timed_serve(eng, reqs)
        run = {"seed": seed, "steps": res["steps"], "loss_first": losses[0],
               "loss_last10_mean": statistics.mean(losses[-10:]),
               "loss_every_20": losses[::20], "eval_acc": res["eval_acc"],
               "mean_accept_len_before": served["mean_accept_len"],
               "mean_accept_len_after": replay["mean_accept_len"],
               "replay_streams_equal":
                   [list(r.generated) for r in reqs] == streams}
        runs.append(run)
        emit(run)
        del eng, trainer, res
        torch.cuda.empty_cache()
    last10 = [r["loss_last10_mean"] for r in runs]
    accept = [r["mean_accept_len_after"] for r in runs]
    emit({"summary": True, "seeds": args.seeds,
          "loss_last10_mean": {"min": min(last10), "max": max(last10),
                               "mean": statistics.mean(last10)},
          "mean_accept_len_after": {"min": min(accept), "max": max(accept),
                                    "mean": statistics.mean(accept)},
          "replay_streams_equal": all(r["replay_streams_equal"]
                                      for r in runs)})
    if args.out:
        with open(args.out, "w") as f:
            f.writelines(json.dumps(x) + "\n" for x in lines)


if __name__ == "__main__":
    main()
