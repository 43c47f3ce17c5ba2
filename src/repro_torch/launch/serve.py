"""Serving launcher (port of ``repro/launch/serve.py``): runs the full
TIDE system (adaptive speculative decoding + online draft training) on
the card: a target pretrained on the synthetic domains, the paper's
§4.1 startup profiling pass, then ``TideSystem`` over waves or an
arrival trace.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch tide-tiny --requests 48
  PYTHONPATH=src python -m repro_torch.launch.serve --arch tide-tiny --continuous
  PYTHONPATH=src python -m repro_torch.launch.serve --arch glm4-9b --pretrain-steps 40

The flags, their names and defaults, are JAX's; ``build_parser`` and
``config_from_args`` are the one flag → ``ServingConfig`` mapping.  Where
JAX feeds the Eq. 5 gate an analytic TPU roofline, the port measures
T(n) and D0 on the serving device (``measure_profile``).  Refused,
naming its ROADMAP queue 1 item: ``--dryrun`` (9).  ``--trainer-endpoint
spawn`` (or ``unix:``/``tcp:``) trains the draft in a process of its
own, and ``--fleet-replicas N`` serves a Poisson trace over N
data-parallel replicas behind one trainer (``serve_fleet``, JAX's
``_main_fleet``; ``--fleet-route``).  ``--sample`` serves per-request-keyed
sampled decoding from the engine base seed ``--seed``, JAX's threefry
streams; ``--prefill-chunk C`` serves chunked refill prefill, its
pipelines committing under ``--commit`` (cohort or eager); ``--preempt
deadline`` and ``--shed`` serve the overload response (lane spill and
restore, load shedding; superstep mode).

``main(argv, device="cpu")`` runs on the CPU; the pieces it calls
(``serve_corpus``, ``measure_profile``, ``tide_config``, ``serve``,
``report``) take the config, the device and the weights, so that
chip_smoke.py runs them at glm4-9b's full width.
"""
from __future__ import annotations

import argparse
import time
from typing import List, Sequence

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tide-tiny")
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--gamma", type=int, default=3)
    ap.add_argument("--max-len", type=int, default=0,
                    help="engine cache length (0 = auto: 96 for waves, "
                         "160 for --continuous)")
    ap.add_argument("--max-new-tokens", type=int, default=32)
    ap.add_argument("--sample", action="store_true",
                    help="per-request-keyed sampled decoding instead of "
                         "greedy argmax")
    ap.add_argument("--superstep-rounds", type=int, default=8,
                    help="speculative rounds fused per superstep "
                         "dispatch (0 = per-step reference loop)")
    ap.add_argument("--eos-id", type=int, default=None,
                    help="stop token id (default: budget-only stop)")
    ap.add_argument("--accept-ema", type=float, default=0.9,
                    help="acceptance-length EMA decay for the Eq. 5 gate")
    ap.add_argument("--seed", type=int, default=0,
                    help="engine base seed (per-request sampling streams)")
    ap.add_argument("--tree-width", type=int, default=0,
                    help=">=1: tree speculation — draft W top-k "
                         "branches, each gamma deep, verified in one "
                         "tree-masked target pass; the longest accepted "
                         "root path commits (1 = degenerate tree, "
                         "bitwise equal to the chain; 0 = chain)")
    ap.add_argument("--pretrain-steps", type=int, default=120)
    ap.add_argument("--no-adaptive", action="store_true")
    ap.add_argument("--continuous", action="store_true",
                    help="serve a ragged Poisson arrival trace with "
                         "in-flight slot refill instead of waves")
    ap.add_argument("--async-train", action="store_true",
                    help="decoupled draft training: background service, "
                         "zero-sync versioned deploys + draft-cache "
                         "re-seed (default: synchronous drain at "
                         "completion boundaries)")
    ap.add_argument("--gate-arrivals", action="store_true",
                    help="replay trace arrival timestamps (idle "
                         "supersteps in gaps) instead of serving the "
                         "trace as a backlog; implies --continuous")
    ap.add_argument("--idle-wait-s", type=float, default=0.005,
                    help="max host sleep per gated-arrival idle tick")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="chunked refill prefill width (multiple of 8; "
                         "0 = one-shot): bounds the stall a long prompt "
                         "injects into resident decode lanes to one "
                         "chunk per superstep gap")
    ap.add_argument("--page-size", type=int, default=0,
                    help=">0: paged KV cache — target/draft caches "
                         "become block-table page pools with admission-"
                         "time reservations and COW prompt-prefix "
                         "sharing (must divide max_len; 0 = dense)")
    ap.add_argument("--num-pages", type=int, default=0,
                    help="page-pool size (0 = the dense footprint, "
                         "batch * max_len / page_size)")
    ap.add_argument("--no-share-prefix", action="store_true",
                    help="disable COW prompt-prefix page sharing")
    ap.add_argument("--reseed-window", type=int, default=None,
                    help="deploy-time draft-cache re-seed ring size "
                         "(default: 32 under --async-train, else 0; "
                         "paged engines re-seed through the lanes' "
                         "block-table rows in place)")
    ap.add_argument("--policy",
                    choices=["fifo", "priority", "deadline", "wedf"],
                    default="fifo",
                    help="admission policy: fifo (arrival order), "
                         "priority (highest Request.priority first), "
                         "deadline (EDF over Request.deadline — the "
                         "latency-SLO policy), or wedf (EDF with the "
                         "deadline relaxed by priority weight); implies "
                         "--continuous for non-fifo choices")
    ap.add_argument("--preempt", choices=["none", "deadline"],
                    default="none",
                    help="preemption policy: deadline spills the "
                         "loosest resident lane when a tighter-deadline "
                         "candidate is deferred against a full batch, "
                         "and restores it mid-stream when a lane frees "
                         "(superstep mode only)")
    ap.add_argument("--shed", choices=["none", "expired", "queue"],
                    default="none",
                    help="load-shedding policy: expired drops queued "
                         "requests whose deadline already passed; queue "
                         "bounds the arrived queue depth, dropping the "
                         "loosest deadlines first")
    ap.add_argument("--shed-queue-depth", type=int, default=64,
                    help="arrived-queue depth bound for --shed queue")
    ap.add_argument("--commit", choices=["cohort", "eager"],
                    default="cohort",
                    help="chunk-pipeline commit policy: cohort (an "
                         "admission batch's pipelines land together, "
                         "densest decode rounds) or eager (each pipeline "
                         "lands as soon as its prefill completes)")
    ap.add_argument("--admission-lookahead", type=int, default=64,
                    help="queue reorder window for non-FIFO admission")
    ap.add_argument("--spec-park", type=int, default=0,
                    help=">0: park speculation + signal capture after N "
                         "consecutive gated-off rounds; resume via "
                         "periodic forced-speculation acceptance probes")
    ap.add_argument("--spec-probe-interval", type=int, default=8,
                    help="parked dispatches between acceptance probes")
    ap.add_argument("--trainer-threads", type=int, default=0,
                    help=">0: deprioritize the async trainer's host "
                         "thread at the OS scheduler")
    # ---- disaggregation (repro_torch/fleet)
    ap.add_argument("--fleet-replicas", type=int, default=0,
                    help=">0: a data-parallel fleet of N engine replicas "
                         "behind one trainer and a draft-version bus")
    ap.add_argument("--trainer-endpoint", default=None,
                    metavar="ENDPOINT",
                    help="draft training out of process: 'spawn' starts "
                         "a private trainer process; unix:/path or "
                         "tcp:host:port connects to a running "
                         "repro_torch.fleet.trainer_main")
    ap.add_argument("--fleet-route", choices=["least", "rr"],
                    default="least",
                    help="fleet request routing (with --fleet-replicas)")
    ap.add_argument("--dryrun", action="store_true")
    ap.add_argument("--shape", default="decode_32k")
    # ---- observability (repro_torch/obs): main()-consumed, not
    #      ServingConfig knobs
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write a Chrome/Perfetto trace-event JSON of "
                         "the run's host-side spans to PATH at exit")
    ap.add_argument("--metrics-interval", type=float, default=0.0,
                    metavar="N",
                    help=">0: print a Prometheus-text metrics snapshot "
                         "every N seconds from a background thread")
    ap.add_argument("--flight-record", action="store_true",
                    help="enable the per-request flight recorder and "
                         "print a timeline digest for the slowest "
                         "requests at exit")
    return ap


def config_from_args(args):
    """Assemble the ``ServingConfig`` the parsed flags name, field for
    field as JAX's (``completion_sink`` is the one field with no flag)."""
    from repro_torch.serving.policy import ServingConfig

    continuous = (getattr(args, "continuous", False) or args.gate_arrivals
                  or args.policy != "fifo")
    reseed = args.reseed_window
    if reseed is None:
        reseed = 32 if getattr(args, "async_train", False) else 0
    return ServingConfig(
        gamma=args.gamma, batch_size=args.batch,
        max_len=args.max_len or (160 if continuous else 96),
        greedy=not args.sample,
        superstep_rounds=args.superstep_rounds,
        eos_id=args.eos_id, ema=args.accept_ema, seed=args.seed,
        admission=args.policy, commit=args.commit,
        admission_lookahead=args.admission_lookahead,
        preempt=args.preempt, shed=args.shed,
        shed_queue_depth=args.shed_queue_depth,
        gate_arrivals=args.gate_arrivals, idle_wait_s=args.idle_wait_s,
        prefill_chunk=args.prefill_chunk,
        page_size=args.page_size, num_pages=args.num_pages,
        share_prefix=not args.no_share_prefix,
        spec_park_patience=args.spec_park,
        spec_probe_interval=args.spec_probe_interval,
        reseed_window=reseed, trainer_threads=args.trainer_threads,
        tree_width=args.tree_width)


def fleet_config_from_args(args):
    """The ``FleetConfig`` the disaggregation flags name (JAX's
    mapping), or None when neither a fleet nor a trainer endpoint was
    asked for."""
    from repro_torch.fleet import FleetConfig

    if not getattr(args, "fleet_replicas", 0) \
            and getattr(args, "trainer_endpoint", None) is None:
        return None
    return FleetConfig(replicas=args.fleet_replicas,
                       trainer_endpoint=args.trainer_endpoint,
                       route=args.fleet_route)


def serve_corpus(cfg):
    """The CLI's two domains (science, code) and the pretraining corpus
    drawn from them, as JAX's CLI draws them."""
    from repro_torch.data.workloads import make_domains, training_corpus
    domains = make_domains(cfg.vocab_size, ["science", "code"],
                           branchings=[2, 3], seed=3)
    corpus = np.concatenate([
        training_corpus(domains["science"], 64, 48, 1),
        training_corpus(domains["code"], 64, 48, 2)])
    return domains, corpus


def profile_batch_sizes(batch: int, gamma: int) -> List[int]:
    """Powers of two from 1 up to the first at or past batch·(γ+1): the
    batches at which ``LatencyProfile.beta`` reads T."""
    sizes = [1]
    while sizes[-1] < batch * (gamma + 1):
        sizes.append(sizes[-1] * 2)
    return sizes


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@torch.no_grad()
def measure_profile(cfg, params, dcfg, dparams, batch_sizes: Sequence[int],
                    device, *, max_len: int, draft_batch: int):
    """The paper's §4.1 startup profiling pass on ``device``: T(n) is one
    target ``decode_step`` of ``n`` lanes of one token each (caches of
    ``max_len`` filled to half), D0 one draft step
    (``eagle.draft_propose`` of one token) of ``draft_batch`` lanes; each
    call ends in a synchronize, and each time is the mean of 10 calls
    after 2 (on the card a decode step is host-bound, and at 3 calls a
    size its host jitter made T(16) read 0.78 of T(4)).
    Returns ``adaptive.profile_engine``'s ``LatencyProfile``."""
    from repro_torch.core import eagle
    from repro_torch.core.adaptive import profile_engine
    from repro_torch.models import transformer as T
    device = torch.device(device)
    fill = max_len // 2
    caches = {}

    def step_fn(n):
        if n not in caches:
            cache = T.init_cache(cfg, n, max_len, device=device)
            cache["lengths"].fill_(fill)
            caches.clear()          # one batch size's cache at a time
            caches[n] = (cache, torch.zeros((n, 1), dtype=torch.int32,
                                            device=device))
        cache, tok = caches[n]
        T.decode_step(cfg, params, cache, tok)
        _sync(device)

    dcache = eagle.init_draft_cache(dcfg, draft_batch, max_len, device=device)
    dcache["lengths"].fill_(fill)
    h = torch.zeros((draft_batch, dcfg.d_model), dtype=dcfg.act_dtype,
                    device=device)
    logits = torch.zeros((draft_batch, dcfg.vocab_size), dtype=torch.float32,
                         device=device)

    def draft_fn():
        eagle.draft_propose(dcfg, dparams, params["embed"], dcache, h,
                            logits, 1)
        _sync(device)

    prof = profile_engine(step_fn, list(batch_sizes), draft_fn=draft_fn,
                          warmup=2, iters=10)
    caches.clear()
    return prof


def tide_config(args):
    """The CLI's ``TideConfig``: ``config_from_args``'s serving config,
    a train cycle per 4 windows of 16 signals, the Eq. 5 gate unless
    ``--no-adaptive``, sync or async training, observability."""
    from repro_torch.core.tide import TideConfig
    from repro_torch.obs import ObsConfig
    obs = ObsConfig(trace=args.trace_out is not None,
                    trace_path=args.trace_out,
                    record=args.flight_record)
    return TideConfig(serving=config_from_args(args),
                      n_threshold=4, signal_window=16,
                      adaptive_spec=not args.no_adaptive,
                      async_train=args.async_train,
                      obs=obs, fleet=fleet_config_from_args(args))


def serve(args, cfg, params, profile, domains, *, device, dparams=None):
    """Build ``TideSystem`` from ``tide_config(args)`` and serve the CLI's
    workload: ``--requests`` requests, half science then half code, as
    waves of ``--batch`` (``run``) or, with ``--continuous``, as a
    Poisson arrival trace (``run_stream``).  Returns (system, completed
    requests, seconds of wall time)."""
    from repro_torch.core.tide import TideSystem
    from repro_torch.data.workloads import (Phase, WorkloadStream,
                                            arrival_trace)
    sys_ = TideSystem(cfg, params, tide_config(args), profile=profile,
                      dparams=dparams, device=device)
    stop_metrics = _start_metrics_printer(sys_, args.metrics_interval)
    n = args.requests
    t0 = time.perf_counter()
    try:
        if args.continuous:
            # ragged budgets never exceed the user's --max-new-tokens cap
            mx = max(args.max_new_tokens, 1)
            # non-FIFO policies need SLO-annotated traces: a bimodal
            # loose/tight deadline mix for EDF, random priority classes
            slo = {}
            if args.policy == "deadline":
                slo = dict(deadline_slack=(8.0, 16.0), tight_frac=0.3,
                           tight_slack=(0.5, 2.0))
            elif args.policy == "priority":
                slo = dict(priority_levels=3)
            trace = arrival_trace(
                domains, n, mode="poisson", rate=16.0,
                max_new_range=(min(8, mx), mx),
                schedule=[Phase("science", n // 2),
                          Phase("code", n - n // 2)],
                seed=1, **slo)
            done = sys_.run_stream(sys_.requests_from_trace(trace))
        else:
            stream = WorkloadStream(domains, [Phase("science", n // 2),
                                              Phase("code", n - n // 2)],
                                    seed=1)
            done = sys_.run(stream.batches(args.batch),
                            max_new_tokens=args.max_new_tokens)
        if args.async_train:
            # finish any training the stream's signals still owe, then
            # stop the service thread cleanly
            sys_.service.drain()
    finally:
        sys_.close()
        stop_metrics()
    return sys_, done, time.perf_counter() - t0


def serve_fleet(args, cfg, params, profile, domains, *, device,
                dparams=None):
    """JAX's ``_main_fleet``: route a Poisson trace of ``--requests``
    (half science, then half code) over ``--fleet-replicas`` replicas fed
    by one trainer (in process, or at ``--trainer-endpoint``), drain the
    trainer and close it.  Returns (fleet, completed requests, seconds of
    wall time)."""
    from repro_torch.data.workloads import Phase, arrival_trace
    from repro_torch.fleet.router import ServingFleet
    from repro_torch.serving.request import Request
    n = args.requests
    mx = max(args.max_new_tokens, 1)
    trace = arrival_trace(
        domains, n, mode="poisson", rate=16.0,
        max_new_range=(min(8, mx), mx),
        schedule=[Phase("science", n // 2), Phase("code", n - n // 2)],
        seed=1)
    reqs = [Request(prompt=ev.prompt, domain=ev.domain,
                    max_new_tokens=ev.max_new_tokens, arrives_at=ev.t)
            for ev in trace]
    fleet = ServingFleet(cfg, params, tide_config(args), profile=profile,
                         dparams=dparams, device=device)
    t0 = time.perf_counter()
    try:
        done = fleet.serve(reqs)
        fleet.service.drain()
    finally:
        fleet.close()
    return fleet, done, time.perf_counter() - t0


def report_fleet(fleet, wall_s: float):
    """Print JAX's fleet summary.  Returns it."""
    s = fleet.summary()
    print(f"\n== fleet summary ({wall_s:.1f}s wall, "
          f"{s['replicas']} replicas) ==")
    for k, v in s.items():
        print(f"  {k}: {v:.3f}" if isinstance(v, float) else f"  {k}: {v}")
    return s


def accept_trend(sys_):
    """Mean accepted length of the first and the last quarter of the
    engine's rounds (paper Fig. 5)."""
    tl = sys_.engine.stats.timeline
    q = max(len(tl) // 4, 1)
    return (float(np.mean([x["accept_len"] for x in tl[:q]])),
            float(np.mean([x["accept_len"] for x in tl[-q:]])))


def report(args, sys_, wall_s: float):
    """Print JAX's end-of-run report: the summary, the accepted-length
    trend, the trace file and the flight-recorder digest.  Returns the
    summary."""
    s = sys_.summary()
    print(f"\n== TIDE summary ({wall_s:.1f}s wall) ==")
    for k, v in s.items():
        print(f"  {k}: {v:.3f}" if isinstance(v, float) else f"  {k}: {v}")
    if args.async_train:
        print(f"  service: {sys_.service.stats()}")
    first, last = accept_trend(sys_)
    print(f"  accept_len trend: {first:.2f} -> {last:.2f} "
          f"(draft adapted online, paper Fig. 5)")
    if args.trace_out:
        doc = sys_.export_trace()
        print(f"  trace: {len(doc['traceEvents'])} events -> "
              f"{args.trace_out}")
    if args.flight_record:
        _print_flight_digest(sys_.recorder)
    return s


def main(argv=None, *, device=None):
    """Parse ``argv`` (default ``sys.argv[1:]``), refuse what the port
    does not run, then pretrain the target, measure the profile (unless
    ``--no-adaptive``), serve and report on ``device`` (default: the CUDA
    card; raises without one).  Returns (system, completed requests), the
    system a ``ServingFleet`` under ``--fleet-replicas``."""
    args = build_parser().parse_args(argv)
    if args.dryrun:
        raise NotImplementedError(
            "--dryrun is not ported yet (ROADMAP queue 1 item 9: launch "
            "tooling)")
    args.continuous = (args.continuous or args.gate_arrivals
                       or args.policy != "fifo")
    from repro_torch.serving.engine import resolve_device
    scfg = config_from_args(args)

    import repro_torch.configs as configs
    from repro_torch.core import eagle
    from repro_torch.core.tide import TideConfig
    from repro_torch.models import transformer as T
    from repro_torch.training.trainer import pretrain_target

    cfg = configs.get(args.arch) if args.arch == "tide-tiny" \
        else configs.get_reduced(args.arch)
    if args.pretrain_steps > 0:
        T.train_check(cfg)
    device = resolve_device(device)
    print(f"serving {cfg.name} ({cfg.param_count()/1e6:.2f}M params) "
          f"on {device}")
    params = T.init(cfg, 0, device=device)
    domains, corpus = serve_corpus(cfg)
    print(f"pretraining target {args.pretrain_steps} steps...")
    params, losses = pretrain_target(cfg, params, corpus,
                                     steps=args.pretrain_steps, lr=3e-3)
    if losses:
        print(f"  loss {losses[0]:.2f} -> {losses[-1]:.2f}")
    dcfg = eagle.draft_config(cfg)
    # the system's own draft (TideSystem draws it from seed + 7), drawn
    # here so the profile times the draft that serves
    dparams = eagle.draft_init(dcfg, TideConfig.seed + 7, device=device)
    profile = None
    if not args.no_adaptive:
        profile = measure_profile(
            cfg, params, dcfg, dparams,
            profile_batch_sizes(args.batch, args.gamma), device,
            max_len=scfg.max_len, draft_batch=args.batch)
        b, g = args.batch, args.gamma
        print("startup profile (measured): T(n) ms "
              + ", ".join(f"{n}: {t:.3f}" for n, t in
                          zip(profile.batch_sizes, profile.t_ms))
              + f"; D0 {profile.d0_ms:.3f} ms; c({b}) {profile.c(b):.3f}, "
              f"beta({b}, {g}) {profile.beta(b, g):.3f}")
    if args.fleet_replicas > 0:
        fleet, done, wall_s = serve_fleet(args, cfg, params, profile,
                                          domains, device=device,
                                          dparams=dparams)
        report_fleet(fleet, wall_s)
        return fleet, done
    sys_, done, wall_s = serve(args, cfg, params, profile, domains,
                               device=device, dparams=dparams)
    report(args, sys_, wall_s)
    return sys_, done


def _start_metrics_printer(sys_, interval: float):
    """Background Prometheus-text snapshot printer (--metrics-interval).
    Reads only host-side registry state, so it never perturbs serving.
    Returns a stop() callable."""
    if interval <= 0:
        return lambda: None
    import threading
    stop = threading.Event()

    def loop():
        while not stop.wait(interval):
            print(f"\n-- metrics @{time.strftime('%H:%M:%S')} --")
            print(sys_.metrics.to_prometheus(), end="")

    t = threading.Thread(target=loop, name="tide-metrics", daemon=True)
    t.start()

    def stop_fn():
        stop.set()
        t.join(timeout=5.0)

    return stop_fn


def _print_flight_digest(recorder, worst: int = 3):
    """Per-request flight-recorder digest: the ``worst`` highest-latency
    completed requests, with their event timelines."""
    tls = sorted(recorder.timelines(),
                 key=lambda tl: tl.get("latency_s") or 0.0, reverse=True)
    print(f"\n== flight recorder ({len(tls)} requests) ==")
    for tl in tls[:worst]:
        print(f"  rid={tl['rid']} sid={tl['sid']} domain={tl['domain']} "
              f"ttft={tl.get('ttft_s')} latency={tl.get('latency_s')}")
        for ev in tl["events"]:
            extra = {k: v for k, v in ev.items()
                     if k not in ("kind", "round", "t")}
            print(f"    r{ev['round']:>5} t={ev['t']:.3f}s {ev['kind']}"
                  + (f" {extra}" if extra else ""))


if __name__ == "__main__":
    main()
