"""TIDE system orchestrator (paper Fig. 1); port of
``repro/core/tide.py``.

Wires the serving engine, the training-signal extractor, the Algorithm 1
controller, the optional Eq. 5 drafter and the draft training service
into the adaptive loop.  Serving and training meet at two one-way seams
that never block serving:

  * **signals out**: the engine's superstep unpack pushes packed
    hidden-state windows into a bounded drop-oldest
    ``core.transport.SignalChannel``;
  * **drafts in**: ``training.service.TrainingService`` runs
    ``DraftTrainer.train_cycle`` and publishes each gate-accepted draft
    as a versioned ``DraftVersion`` into a lock-free slot, which the
    engine reads through its ``_poll_deploy`` before a dispatch.

Two training modes.  ``async_train=False`` (the default) calls
``service.drain()`` at request-completion boundaries, blocking and
deterministic: a passing draft hot-swaps in mid-stream at the next
dispatch, as in JAX's sync mode.  ``async_train=True`` starts the
service's background thread (on a CUDA card, on a stream of its own) and
serving never waits on training: the engine polls the slot once a
superstep (``deploy_source=service.poll``) and, with ``reseed_window``
set, re-seeds the resident lanes' draft caches from its capture ring at
each deploy.  The training card is ``transport.pick_training_device()``
(None on a one-card host: the thread shares the serving card); the
channel places signals on it, and a draft trained there is copied back
to the engine's card before it is published.  Every control decision
(Algorithm 1's collection gating, deploy-if-improved) is the same in
both modes.  With ``TideConfig.fleet`` naming a ``trainer_endpoint``
the training stack is ``fleet.remote.RemoteTrainingService``, a trainer
in a process of its own behind the same ``poll``/``drain``/``reset``/
``close`` surface (``"spawn"`` starts one on the system's device kind),
so every mode above runs unchanged; the N-replica fleet is
``fleet.router.ServingFleet``.

Serving knobs live in one ``serving.policy.ServingConfig``
(``TideConfig(serving=...)``); the flat ``TideConfig`` fields mirror it.
The system owns one ``obs`` instrument set shared by every component: a
``MetricsRegistry`` (``self.metrics``; ``summary()`` is a view over it)
and the tracer and flight recorder that ``TideConfig.obs`` builds.

The system runs on the CUDA card unless ``device="cpu"`` is passed, as
the engine and the trainer do.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional

from repro_torch.checkpoint import bridge
from repro_torch.checkpoint.ckpt import DraftDeployGate
from repro_torch.core import eagle
from repro_torch.core.adaptive import AdaptiveDrafter, LatencyProfile
from repro_torch.core.controller import TrainingController
from repro_torch.core.signals import SignalExtractor
from repro_torch.core.transport import SignalChannel, pick_training_device
from repro_torch.fleet import FleetConfig
from repro_torch.models.config import ModelConfig
from repro_torch.obs import ObsConfig
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.serving.engine import ServingEngine, resolve_device
from repro_torch.serving.policy import ServingConfig
from repro_torch.serving.request import Request
from repro_torch.training.draft_trainer import DraftTrainer
from repro_torch.training.service import TrainingService


@dataclasses.dataclass
class TideConfig:
    """System configuration.  Serving knobs live in one unified
    ``serving.policy.ServingConfig`` (``TideConfig(serving=...)``); the
    flat legacy fields remain as a convenience layer: when ``serving``
    is omitted they assemble one, when it is given they mirror its
    values.  Fields and defaults are JAX's."""
    gamma: int = 3
    batch_size: int = 4
    max_len: int = 160
    greedy: bool = True
    superstep_rounds: int = 8         # 0 = per-step reference loop
    eos_id: Optional[int] = None
    ema: float = 0.9                  # acceptance-EMA decay
    tree_width: int = 0               # >=1: draft token trees
    adaptive_spec: bool = True        # False = TIDE-default (paper §5.4)
    selective_training: bool = True
    signal_window: int = 24
    n_threshold: int = 96             # windows per training cycle
    train_epochs: int = 2
    train_min_steps: int = 80         # optimizer-step floor per cycle
    seed: int = 0
    # ---- training mode and channel
    async_train: bool = False         # background service vs drain at
    #                                   completion boundaries (sync)
    channel_capacity: int = 512       # SignalChannel bound (batches)
    reseed_window: int = 0            # >0: re-seed resident draft caches
    #                                   at a deploy (async mode only)
    gate_arrivals: bool = False       # respect trace arrival timestamps
    prefill_chunk: int = 0            # chunked refill prefill (0 = one-shot)
    # ---- paged KV cache (core/paging.py; 0 = dense per-lane caches)
    page_size: int = 0
    num_pages: int = 0                # pool size (0 = dense footprint)
    share_prefix: bool = True         # COW prompt-prefix sharing
    # ---- serving control plane (see serving/policy.py)
    admission: str = "fifo"           # fifo | priority | deadline | wedf
    commit: str = "cohort"            # cohort | eager (chunk pipelines)
    admission_lookahead: int = 64     # reorder window (non-FIFO policies)
    preempt: str = "none"             # none | deadline: spill a loose
    #                                   lane for a tighter arrival
    shed: str = "none"                # none | expired | queue: drop
    #                                   hopeless queued requests
    shed_queue_depth: int = 64        # queue-shed depth bound
    idle_wait_s: float = 0.005        # gated-arrival idle-tick bound
    spec_park_patience: int = 0       # >0: park speculation + capture
    spec_probe_interval: int = 8      # parked dispatches between probes
    trainer_threads: int = 0          # >0: deprioritize the trainer thread
    # ---- observability: not a ServingConfig knob; the engine takes the
    #      built tracer/recorder as collaborators
    obs: Optional[ObsConfig] = None
    # ---- disaggregation (fleet.FleetConfig): replicas, trainer endpoint
    fleet: Optional[FleetConfig] = None
    serving: Optional[ServingConfig] = None

    # knobs shared (by name) with ServingConfig: assembled into one
    # when ``serving`` is omitted, mirrored back when it is given
    _SHARED_FIELDS = ("gamma", "batch_size", "max_len", "greedy", "seed",
                      "superstep_rounds", "eos_id", "ema", "tree_width",
                      "gate_arrivals", "prefill_chunk", "reseed_window",
                      "page_size", "num_pages", "share_prefix",
                      "admission", "commit", "admission_lookahead",
                      "preempt", "shed", "shed_queue_depth",
                      "idle_wait_s", "spec_park_patience",
                      "spec_probe_interval", "trainer_threads")

    def __post_init__(self):
        if self.serving is None:
            self.serving = ServingConfig(**{
                f: getattr(self, f) for f in self._SHARED_FIELDS})
            return
        # Flat fields set away from both their default and the serving
        # value override the serving config; the rest become read
        # mirrors of it (so ``dataclasses.replace(tc, batch_size=8)``
        # overrides only what it changes).
        defaults = {f.name: f.default
                    for f in dataclasses.fields(type(self))}
        over = {f: getattr(self, f) for f in self._SHARED_FIELDS
                if getattr(self, f) != defaults[f]
                and getattr(self, f) != getattr(self.serving, f)}
        if over:
            self.serving = dataclasses.replace(self.serving, **over)
        for f in self._SHARED_FIELDS:
            setattr(self, f, getattr(self.serving, f))


class TideSystem:
    def __init__(self, cfg: ModelConfig, params, tide_cfg: TideConfig,
                 profile: Optional[LatencyProfile] = None,
                 dparams=None, device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.tcfg = tide_cfg
        self.dcfg = eagle.draft_config(cfg)
        if dparams is None:
            dparams = eagle.draft_init(self.dcfg, tide_cfg.seed + 7,
                                       device=self.device)
        self._dparams0 = dparams
        self.obs = tide_cfg.obs if tide_cfg.obs is not None else ObsConfig()
        self.metrics = MetricsRegistry()
        self.tracer, self.recorder = self.obs.build()
        n_threshold = tide_cfg.n_threshold * tide_cfg.signal_window
        self.controller = TrainingController(n_threshold=n_threshold,
                                             n_init=4)
        drafter = None
        if tide_cfg.adaptive_spec and profile is not None:
            drafter = AdaptiveDrafter(profile, gamma=tide_cfg.gamma)
        # the training stack: in-process (a thread, on a card of its own
        # where the host has one) or in a process of its own over the
        # fleet wire; both expose the same poll/drain/reset/close surface
        remote = (tide_cfg.fleet is not None
                  and tide_cfg.fleet.trainer_endpoint is not None)
        if remote:
            from repro_torch.fleet.remote import RemoteTrainingService
            self.service = RemoteTrainingService(
                tide_cfg.fleet.trainer_endpoint,
                tcfg=cfg, dcfg=self.dcfg,
                embed_params=params["embed"], dparams0=dparams,
                n_threshold=n_threshold,
                signal_window=tide_cfg.signal_window,
                train_epochs=tide_cfg.train_epochs,
                train_min_steps=tide_cfg.train_min_steps,
                seed=tide_cfg.seed, async_train=tide_cfg.async_train,
                channel_capacity=max(tide_cfg.channel_capacity,
                                     tide_cfg.n_threshold),
                controller=self.controller,
                selective=tide_cfg.selective_training,
                engine_steps_fn=lambda: self.engine.stats.steps,
                device=self.device,
                tracer=self.tracer, registry=self.metrics)
            self.channel = self.service.channel
            self.trainer = None             # lives in the trainer process
            self.gate = self.service.gate   # serving-side version mirror
        else:
            # async mode trains on a card of its own where the host has
            # one
            train_device = (pick_training_device() if tide_cfg.async_train
                            and self.device.type == "cuda" else None)
            if train_device == self.device:
                train_device = None
            # the channel must be able to buffer at least one cycle's
            # worth of windows, or training starves behind the
            # drop-oldest bound
            self.channel = SignalChannel(
                capacity=max(tide_cfg.channel_capacity,
                             tide_cfg.n_threshold),
                device=train_device)
            embed = params["embed"]
            if train_device is not None:
                embed = bridge.tree_to(embed, train_device)
            self.trainer = DraftTrainer(cfg, self.dcfg, embed,
                                        device=train_device or self.device)
            self.gate = DraftDeployGate(dparams)
            self.service = TrainingService(
                self.trainer, self.gate, self.channel,
                controller=self.controller,
                selective=tide_cfg.selective_training,
                n_threshold=n_threshold,
                signal_window=tide_cfg.signal_window,
                train_epochs=tide_cfg.train_epochs,
                train_min_steps=tide_cfg.train_min_steps,
                seed=tide_cfg.seed,
                device=train_device,
                publish_device=(self.device if train_device is not None
                                else None),
                trainer_threads=tide_cfg.trainer_threads,
                engine_steps_fn=lambda: self.engine.stats.steps,
                tracer=self.tracer, registry=self.metrics)
        self.extractor = SignalExtractor(self.channel,
                                         window=tide_cfg.signal_window)
        self.events = self.service.events
        # re-seeding only makes sense with the async deploy path, so
        # sync mode zeroes it
        scfg = dataclasses.replace(
            tide_cfg.serving,
            reseed_window=(tide_cfg.reseed_window if tide_cfg.async_train
                           else 0))
        self.engine = ServingEngine(
            cfg, params, self.dcfg, dparams, config=scfg,
            policy=scfg.make_policy(drafter),
            controller=(self.controller if tide_cfg.selective_training
                        else None),
            extractor=self.extractor,
            deploy_source=(self.service.poll if tide_cfg.async_train
                           else None),
            tracer=self.tracer, recorder=self.recorder,
            metrics=self.metrics, device=self.device)
        # start in collection mode so the cold draft trains immediately
        self.controller.collection_enabled = True
        if tide_cfg.async_train:
            self.service.start()

    # ----------------------------------------------------------- training
    def _drain_train(self, _req=None):
        """Run every cycle the buffered signals allow, blocking serving,
        then deploy at once so the next dispatch uses the new draft (the
        engine's own pickup protocol)."""
        self.service.drain()
        self.engine._poll_deploy(self.service.poll)

    # ------------------------------------------------------------ serving
    def run(self, waves: Iterable[List], max_new_tokens: int = 48
            ) -> List[Request]:
        """Serve a workload already grouped into waves of (domain,
        prompt) pairs, training after each wave in sync mode.  Returns
        all completed requests."""
        done: List[Request] = []
        sync = not self.tcfg.async_train
        for wave in waves:
            reqs = [Request(prompt=p, domain=d,
                            max_new_tokens=max_new_tokens)
                    for d, p in wave]
            self.engine.serve_wave(reqs)
            done.extend(reqs)
            if sync:
                self._drain_train()
        return done

    def run_stream(self, requests: Iterable[Request]) -> List[Request]:
        """Serve a request stream with continuous batching.  Sync mode
        drains the training service at request-completion boundaries (a
        passing draft hot-swaps in mid-stream); async mode never waits:
        the service trains in the background and the engine picks
        deploys up from the slot once a superstep."""
        on_complete = (None if self.tcfg.async_train
                       else self._drain_train)
        return self.engine.serve_stream(requests, on_complete=on_complete)

    def requests_from_trace(self, trace) -> List[Request]:
        """``data.workloads.ArrivalEvent`` records as engine requests, in
        trace order; arrival times are replayed only when
        ``gate_arrivals`` is set.  SLO annotations ride along for the
        deadline/priority admission policies."""
        return [Request(prompt=ev.prompt, domain=ev.domain,
                        max_new_tokens=ev.max_new_tokens,
                        arrives_at=ev.t,
                        deadline=getattr(ev, "deadline", None),
                        priority=getattr(ev, "priority", 0))
                for ev in trace]

    # ----------------------------------------------------------- lifecycle
    def close(self):
        """Stop the background training service (async mode) and join its
        thread, and close its channel; buffered signals remain
        drainable.  Idempotent."""
        self.service.close()

    def reset_adaptation(self):
        """Reset every adaptation-side component to its post-construction
        state (draft params, deploy gate, controller, channel, signal
        windows, serving stats) while keeping the engine and its
        buffers.  Holds the service's train lock throughout, so a
        background cycle in flight completes (against the pre-reset
        gate) before anything is cleared and can never publish a stale
        draft into the fresh run."""
        with self.service._train_lock:
            self.channel.reset()
            self.extractor.reset()
            self.controller.reset()
            self.controller.collection_enabled = True   # as in __init__
            self.gate.reset(self._dparams0)
            self.service.reset()
            self.engine.reset_adaptation(self._dparams0)

    # ------------------------------------------------------------- stats
    def export_trace(self, path: Optional[str] = None) -> Dict:
        """The span tracer's buffer as a Chrome/Perfetto trace-event JSON
        document, written to ``path`` (default ``ObsConfig.trace_path``)
        when one is known."""
        return self.tracer.export(path if path is not None
                                  else self.obs.trace_path)

    def snapshot(self) -> Dict:
        """Flat metrics snapshot across every registry namespace."""
        return self.metrics.snapshot()

    def summary(self) -> Dict:
        st = self.engine.stats
        return {
            "tokens": st.tokens_out,
            "throughput_tok_s": st.throughput,
            "accept_len": st.accept_len,
            "steps": st.steps,
            "spec_steps": st.spec_steps,
            "refills": st.refills,
            "occupancy": st.occupancy,
            "ttft_p50_s": st.ttft_p50,
            "latency_p95_s": st.latency_p95,
            "idle_supersteps": st.idle_supersteps,
            "deploys": st.deploys,
            "reseeds": st.reseeds,
            "spec_parks": self.engine.policy.speculation.parks,
            "spec_resumes": self.engine.policy.speculation.resumes,
            "train_cycles": len([e for e in self.events
                                 if e["kind"] == "train_cycle"]),
            "deployed": self.gate.version,
            "trainer_failures": self.service.failures,
            "signals_collected": self.channel.total_added,
            "signal_bytes": self.channel.total_bytes,
            "signals_dropped": self.channel.dropped,
        }
