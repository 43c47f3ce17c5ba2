"""How the target's training loss moves with the Adafactor learning rate at
glm4-9b's full width and depth (random bf16 weights from seed 0), for
chip_smoke.py's launch phase.

For each learning rate it runs the ``launch.train`` loop (batch 8, seq 64,
on the one-domain corpus of ``repro_torch/launch/train.py``) and
``pretrain_target`` on the serve CLI's corpus (batch 8, 47 tokens),
``--steps`` steps each from fresh weights, and prints one JSON line: the
losses, the mean of the last 3 against the first, and the median step
ms.  bf16 weights of std 1/sqrt(4096) ≈ 0.016 have an ulp of ~1.2e-4, and
an Adafactor update moves each element by at most ``lr`` (its RMS is
clipped to 1), so a rate much below that ulp rounds away and a rate near
the weights' own scale oscillates.

    python3 scripts/launch_lr.py [--lrs 1e-4,2e-4,3e-4,5e-4] [--steps 12]

Needs one CUDA card; prints the card's nvidia-smi name and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))


def _timed(opt):
    """``opt`` with the host time between the ends of two updates (one
    step) recorded; the first entry runs from the first update's start."""
    ms, last = [], []

    def update(*a):
        torch.cuda.synchronize()
        if not last:
            last.append(time.perf_counter())
        out = opt.update(*a)
        torch.cuda.synchronize()
        now = time.perf_counter()
        ms.append((now - last[-1]) * 1e3)
        last.append(now)
        return out

    return opt._replace(update=update), ms


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--lrs", default="1e-4,2e-4,3e-4,5e-4")
    ap.add_argument("--steps", type=int, default=12)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("launch_lr: no CUDA device")
    from repro_torch.configs import get
    from repro_torch.launch import serve as S
    from repro_torch.launch import train as TR
    from repro_torch.models import transformer as T
    from repro_torch.training.optimizer import adafactor
    from repro_torch.training.trainer import pretrain_target
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    cfg = get("glm4-9b")
    dev = torch.device("cuda")
    _, corpus = S.serve_corpus(cfg)
    for lr in (float(x) for x in args.lrs.split(",")):
        for what in ("launch_train", "pretrain"):
            params = T.init(cfg, 0, device=dev)
            if what == "launch_train":
                targs = TR.build_parser().parse_args(
                    ["--arch", cfg.name, "--steps", str(args.steps),
                     "--optimizer", "adafactor", "--lr", str(lr)])
                log = TR.train(cfg, params, targs, device=dev)
                losses = [e["loss"] for e in log]
                step_ms = [e["ms"] for e in log]
            else:
                opt, step_ms = _timed(adafactor(lr=lr))
                _, losses = pretrain_target(cfg, params, corpus,
                                            steps=args.steps, opt=opt)
            print(json.dumps({
                "run": what, "lr": lr, "steps": args.steps,
                "losses": losses, "first": losses[0],
                "last3_mean": statistics.mean(losses[-3:]),
                "falls": statistics.mean(losses[-3:]) < losses[0],
                "step_ms_median": statistics.median(step_ms[1:])}),
                flush=True)
            del params
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
