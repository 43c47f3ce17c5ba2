"""Training launcher (port of ``repro/launch/train.py``, its demo mode):
real steps of a reduced config on the card, a live, verifiable training
loop.  ``--dryrun`` (the full config lowered on the production mesh) is
launch tooling, ROADMAP queue 1 item 9, and raises.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch glm4-9b --steps 20

``main(argv, device="cpu")`` runs it on the CPU; ``train(cfg, params,
args, device=...)`` runs the loop on any config (chip_smoke.py drives it
at glm4-9b's full width).
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.data.workloads import make_domains, training_corpus
from repro_torch.training.optimizer import Optimizer, adafactor, adamw
from repro_torch.training.trainer import make_train_step, trainable


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tide-tiny")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--optimizer", choices=["adamw", "adafactor"],
                    default="adamw")
    ap.add_argument("--dryrun", action="store_true")
    ap.add_argument("--shape", default="train_4k")
    return ap


def train(cfg, params, args, *, device, opt: Optional[Optimizer] = None
          ) -> List[dict]:
    """The demo loop: ``args.steps`` steps of ``make_train_step`` (no
    microbatching, no remat) on batches of ``args.batch`` rows of
    ``args.seq`` tokens drawn from a one-domain corpus, as JAX draws them.
    ``params`` (a ``ParamTree``) is trained in place; ``opt`` defaults to
    ``--optimizer`` at ``--lr``.  Prints JAX's lines and returns one dict
    a step: loss, accuracy, grad_norm and the step's host ms (each step
    ends in one host read of its metrics)."""
    opt = opt or (adamw(lr=args.lr) if args.optimizer == "adamw"
                  else adafactor(lr=args.lr))
    step_fn = make_train_step(cfg, opt, n_micro=1, remat=False)
    flat = trainable(params)
    opt_state = opt.init(flat)
    dom = make_domains(cfg.vocab_size, ["train"], seed=0)["train"]
    corpus = training_corpus(dom, 4 * args.batch, args.seq + 1, seed=1)
    rng = np.random.default_rng(0)
    log = []
    t0 = time.perf_counter()
    for it in range(args.steps):
        ts = time.perf_counter()
        sel = rng.integers(0, corpus.shape[0], size=args.batch)
        rows = torch.from_numpy(np.ascontiguousarray(corpus[sel])).to(device)
        flat, opt_state, m = step_fn(
            flat, opt_state, {"tokens": rows[:, :-1], "targets": rows[:, 1:]},
            it)
        loss, acc, gnorm = torch.stack(
            [m["loss"], m["accuracy"], m["grad_norm"]]).tolist()
        log.append({"it": it, "loss": loss, "accuracy": acc,
                    "grad_norm": gnorm,
                    "ms": (time.perf_counter() - ts) * 1e3})
        if it % max(args.steps // 10, 1) == 0:
            print(f"step {it:4d}  loss {loss:.4f}  acc {acc:.3f}  "
                  f"gnorm {gnorm:.2f}")
    dt = time.perf_counter() - t0
    print(f"done: {args.steps} steps in {dt:.1f}s "
          f"({args.steps / dt:.2f} steps/s)")
    return log


def main(argv=None, *, device=None) -> List[dict]:
    """Parse ``argv`` (default ``sys.argv[1:]``), build
    ``configs.get_reduced(--arch)`` with weights from seed 0 and train it
    on ``device`` (default: the CUDA card; raises without one)."""
    args = build_parser().parse_args(argv)
    if args.dryrun:
        raise NotImplementedError(
            "--dryrun is not ported yet (ROADMAP queue 1 item 9: launch "
            "tooling)")
    import repro_torch.configs as configs
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import resolve_device
    cfg = configs.get_reduced(args.arch)
    T.train_check(cfg)
    device = resolve_device(device)
    print(f"training {cfg.name}: {cfg.param_count()/1e6:.2f}M params "
          f"on {device}")
    params = T.init(cfg, 0, device=device)
    return train(cfg, params, args, device=device)


if __name__ == "__main__":
    main()
