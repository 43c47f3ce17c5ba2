"""What slows serving while the draft trains beside it on one card.

Serves chip_smoke.py's 16 requests with glm4-9b (random weights from
seeds 0 and 1, as chip_smoke.py's serve phase; batch 8, max_len 1024,
gamma 3, K 8) once to collect their signal windows, then serves them
again under each of these conditions:

  alone      nothing else runs;
  train      a background thread runs ``DraftTrainer.train_cycle``
             (chip_smoke.py's tide cycle: 8 windows, ``TIDE_STEPS``
             adamw steps) back to back on a CUDA stream of its own, as
             the async ``TrainingService`` does, while the serving thread
             serves on the default stream;
  train_hi   the same, with the serving thread on a stream of the
             highest priority the card offers (the training stream keeps
             the default priority, the lowest);
  train_si   ``train`` with the interpreter's switch interval cut from
             its 5 ms to 0.5 ms (``sys.setswitchinterval``): how long a
             thread that wants the lock waits for the one that holds it;
  gil        a background thread that only runs Python bytecode (no CUDA
             work) holds the interpreter lock as often as it can get it.

For each it prints one JSON line: the superstep ms (the host clock
around each superstep, the serving stream synchronized before and after:
never the device, which would wait for training too), the serve's wall
seconds, and the training thread's step ms and steps (the trainer's own
log).  ``train`` against ``train_hi`` separates the card's block
scheduler (the serving kernels queued behind training kernels on the
SMs) from the host (the interpreter lock, which ``gil`` measures alone).

Needs one CUDA card.  Run from the root of a checkout:

    python3 scripts/async_contention.py
"""
from __future__ import annotations

import json
import os
import statistics
import sys
import threading
import time

import torch


def main():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import chip_smoke as cs
    cs._use_checkout()
    from repro_torch.configs import get
    from repro_torch.core import eagle
    from repro_torch.core.signals import SignalExtractor, SignalStore
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.training.draft_trainer import DraftTrainer

    dev = torch.device("cuda")
    cfg = get("glm4-9b")
    dcfg = eagle.draft_config(cfg)
    params = T.init(cfg, 0, device=dev)
    dparams = eagle.draft_init(dcfg, 1, device=dev)
    eng = ServingEngine(cfg, params, dcfg, dparams, batch_size=8,
                        max_len=1024, gamma=cs.GLM["GAMMA"],
                        superstep_rounds=8, device=dev,
                        extractor=SignalExtractor(SignalStore()))
    eng.serve_stream(iter(cs._serve_requests(cfg.vocab_size)))
    windows = eng.extractor.store.drain()[:8]
    eng.extractor = None
    trainer = DraftTrainer(cfg, dcfg, params["embed"], device=dev)
    superstep = eng._superstep
    lo, hi = torch.cuda.Stream.priority_range() \
        if hasattr(torch.cuda.Stream, "priority_range") else (0, -1)

    def background(kind, stop):
        """The load beside serving: train cycles on a stream of their own,
        or pure bytecode.  Returns the thread."""
        def train():
            s = torch.cuda.Stream(device=dev)
            s.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(s):
                while not stop.is_set():
                    trainer.train_cycle(dparams, windows, epochs=2,
                                        min_steps=cs.TIDE_STEPS, seed=0)
            s.synchronize()

        def spin():
            x = 0
            while not stop.is_set():
                for i in range(1000):
                    x += i * i

        th = threading.Thread(target=train if kind.startswith("train")
                              else spin, daemon=True)
        th.start()
        return th

    def serve(kind):
        stream = (torch.cuda.Stream(device=dev, priority=hi)
                  if kind == "train_hi" else torch.cuda.current_stream())
        switch = sys.getswitchinterval()
        if kind == "train_si":
            sys.setswitchinterval(5e-4)
        served_at = sys.getswitchinterval()
        ms = []

        def timed(*a, **kw):
            stream.synchronize()
            t0 = time.perf_counter()
            out = superstep(*a, **kw)
            stream.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            return out

        eng._superstep = timed
        stop = threading.Event()
        log0 = len(trainer.log)
        th = None if kind == "alone" else background(kind, stop)
        if th is not None and kind.startswith("train"):
            while len(trainer.log) == log0:      # the first step is queued
                time.sleep(0.01)
        stream.wait_stream(torch.cuda.current_stream())
        t0 = time.perf_counter()
        with torch.cuda.stream(stream):
            reqs = cs._serve_requests(cfg.vocab_size)
            eng.serve_stream(iter(reqs))
            stream.synchronize()
        wall = time.perf_counter() - t0
        log1 = len(trainer.log)
        stop.set()
        if th is not None:
            th.join(timeout=600)
            assert not th.is_alive(), "the background thread did not stop"
        sys.setswitchinterval(switch)
        torch.cuda.synchronize()
        steps = [e["ms"] for e in trainer.log[log0:log1]]
        row = {"condition": kind, "superstep_ms_median": statistics.median(ms),
               "superstep_ms_mean": statistics.mean(ms), "supersteps": len(ms),
               "wall_s": wall, "tokens": sum(len(r.generated) for r in reqs),
               "train_steps_during_serve": len(steps),
               "train_step_ms_median": (statistics.median(steps)
                                        if steps else None),
               "stream_priority": stream.priority,
               "switch_interval_s": served_at,
               "priority_range": [lo, hi], "nvidia_smi": cs.smi()}
        print(json.dumps(row), flush=True)
        return [list(r.generated) for r in reqs]

    ref = serve("alone")
    for kind in ("train", "train_hi", "train_si", "gil", "alone"):
        assert serve(kind) == ref, f"{kind}: streams differ"
    print(json.dumps({"ok": True}), flush=True)


if __name__ == "__main__":
    main()
