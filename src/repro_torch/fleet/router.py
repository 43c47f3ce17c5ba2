"""Front-end router and data-parallel serving fleet (port of
``repro/fleet/router.py``).

One trainer amortized over N ``ServingEngine`` replicas.  The
``FleetRouter`` load-balances a trace over the replicas
deterministically (cost-estimate least-loaded by default);
``ServingFleet`` wires the shared trainer stack (the in-process
``TrainingService`` or the out-of-process ``RemoteTrainingService``), a
``DraftVersionBus`` fanning every published draft out to every replica,
and N engines over one params object (``ServingEngine.adopt_compiled``
refuses anything else, so N replicas of glm4-9b hold one copy of the
target).

Per-replica determinism: greedy token streams are draft- and
scheduling-invariant (the target verifies every draft token), so a
request's stream is the same whichever replica serves it.

On one host the replicas serve serially (one process, one card:
concurrent engines would only time-slice), so the fleet's wall clock is
modeled, not measured: per-replica wall and rounds are tracked apart,
and ``summary()`` reports the aggregate over the slowest replica, the
bound a data-parallel deployment sees.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

from repro_torch.checkpoint.ckpt import DraftDeployGate
from repro_torch.core import eagle
from repro_torch.core.adaptive import AdaptiveDrafter, LatencyProfile
from repro_torch.core.controller import TrainingController
from repro_torch.core.signals import SignalExtractor
from repro_torch.core.transport import SignalChannel
from repro_torch.fleet import FleetConfig
from repro_torch.fleet.bus import DraftVersionBus
from repro_torch.serving.engine import ServingEngine, resolve_device
from repro_torch.serving.request import Request
from repro_torch.training.draft_trainer import DraftTrainer
from repro_torch.training.service import TrainingService


def request_cost(req: Request) -> float:
    """Deterministic per-request work estimate for load balancing:
    decode rounds scale with the token budget, prefill with prompt
    width (8 = the refill shape bucket)."""
    return len(req.prompt) / 8.0 + float(req.max_new_tokens)


class FleetRouter:
    """Deterministic request→replica assignment.

    ``least``: cost-estimate least-loaded (ties to the lowest replica
    index), the default.  ``rr``: round-robin, the oblivious
    baseline."""

    def __init__(self, n: int, policy: str = "least"):
        if n < 1:
            raise ValueError(f"router needs >= 1 replica, got {n}")
        if policy not in ("least", "rr"):
            raise ValueError(f"unknown route policy {policy!r}")
        self.n = n
        self.policy = policy
        self.load = [0.0] * n
        self.assigned = [0] * n
        self._rr = 0

    def assign(self, req: Request) -> int:
        if self.policy == "rr":
            idx = self._rr % self.n
            self._rr += 1
        else:
            idx = min(range(self.n), key=lambda i: (self.load[i], i))
        self.load[idx] += request_cost(req)
        self.assigned[idx] += 1
        return idx

    def split(self, requests: Sequence[Request]) -> List[List[Request]]:
        """Shard a trace, preserving arrival order within each shard."""
        shards: List[List[Request]] = [[] for _ in range(self.n)]
        for req in requests:
            shards[self.assign(req)].append(req)
        return shards


class ServingFleet:
    """N data-parallel serving replicas fed by one shared trainer.

    Mirrors ``TideSystem``'s wiring (channel → service → deploy pickup)
    with two substitutions: published drafts fan out through a
    ``DraftVersionBus`` (each replica's subscription is its
    ``deploy_source``), and with ``TideConfig.fleet.trainer_endpoint``
    set the trainer stack is a ``RemoteTrainingService`` in another
    process.  Signals from every replica go into the one shared channel.
    Runs on the CUDA card unless ``device="cpu"`` is passed."""

    def __init__(self, cfg, params, tide_cfg,
                 profile: Optional[LatencyProfile] = None, dparams=None,
                 device=None):
        fleet = tide_cfg.fleet if tide_cfg.fleet is not None \
            else FleetConfig(replicas=1)
        self.device = resolve_device(device)
        self.fleet_cfg = fleet
        self.n = max(fleet.replicas, 1)
        self.cfg = cfg
        self.tcfg = tide_cfg
        self.dcfg = eagle.draft_config(cfg)
        if dparams is None:
            dparams = eagle.draft_init(self.dcfg, tide_cfg.seed + 7,
                                       device=self.device)
        self._dparams0 = dparams
        self.async_train = tide_cfg.async_train
        n_threshold = tide_cfg.n_threshold * tide_cfg.signal_window
        self.controller = TrainingController(n_threshold=n_threshold,
                                             n_init=4)
        self.controller.collection_enabled = True

        if fleet.trainer_endpoint is not None:
            from repro_torch.fleet.remote import RemoteTrainingService
            self.service = RemoteTrainingService(
                fleet.trainer_endpoint, tcfg=cfg, dcfg=self.dcfg,
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
                engine_steps_fn=self._total_steps, device=self.device)
            self.channel = self.service.channel
            self.gate = self.service.gate
            self.trainer = None
        else:
            self.channel = SignalChannel(
                capacity=max(tide_cfg.channel_capacity,
                             tide_cfg.n_threshold))
            self.trainer = DraftTrainer(cfg, self.dcfg, params["embed"],
                                        device=self.device)
            self.gate = DraftDeployGate(dparams)
            self.service = TrainingService(
                self.trainer, self.gate, self.channel,
                controller=self.controller,
                selective=tide_cfg.selective_training,
                n_threshold=n_threshold,
                signal_window=tide_cfg.signal_window,
                train_epochs=tide_cfg.train_epochs,
                train_min_steps=tide_cfg.train_min_steps,
                seed=tide_cfg.seed)
        self.bus = DraftVersionBus(source=self.service.poll)
        self.router = FleetRouter(self.n, fleet.route)
        self.events = self.service.events

        scfg = dataclasses.replace(
            tide_cfg.serving,
            reseed_window=(tide_cfg.reseed_window if tide_cfg.async_train
                           else 0))
        self.extractors: List[SignalExtractor] = []
        self.engines: List[ServingEngine] = []
        self.subs = []
        for i in range(self.n):
            extractor = SignalExtractor(self.channel,
                                        window=tide_cfg.signal_window)
            sub = self.bus.subscribe(f"replica{i}")
            drafter = (AdaptiveDrafter(profile, gamma=tide_cfg.gamma)
                       if tide_cfg.adaptive_spec and profile is not None
                       else None)
            engine = ServingEngine(
                cfg, params, self.dcfg, dparams, config=scfg,
                policy=scfg.make_policy(drafter),
                controller=(self.controller
                            if tide_cfg.selective_training else None),
                extractor=extractor,
                deploy_source=(sub if tide_cfg.async_train else None),
                device=self.device)
            if i > 0:
                engine.adopt_compiled(self.engines[0])
            self.extractors.append(extractor)
            self.engines.append(engine)
            self.subs.append(sub)
        if tide_cfg.async_train:
            self.service.start()

    def _total_steps(self) -> int:
        return sum(e.stats.steps for e in getattr(self, "engines", []))

    # ------------------------------------------------------------ serving
    def serve(self, requests: Sequence[Request]) -> List[Request]:
        """Route the trace over the replicas and serve every shard.

        One host serves the replicas one after another, each its shard
        to completion with the stream loop; in sync mode every replica
        drains the shared trainer at its request-completion boundaries
        and picks published drafts up from its bus subscription (the
        pickup of ``TideSystem._drain_train``)."""
        shards = self.router.split(list(requests))
        done: List[Request] = []
        for engine, sub, shard in zip(self.engines, self.subs, shards):
            if not shard:
                continue
            engine._poll_deploy(sub)   # deploys won while others served
            on_complete = None
            if not self.async_train:
                def on_complete(_req=None, engine=engine, sub=sub):
                    self.service.drain()
                    engine._poll_deploy(sub)
            done.extend(engine.serve_stream(shard,
                                            on_complete=on_complete))
        return done

    # ---------------------------------------------------------- lifecycle
    def close(self):
        self.service.close()

    def reset_adaptation(self):
        """Fleet-wide adaptation reset (cf. ``TideSystem
        .reset_adaptation``): every replica, the shared channel,
        controller, gate and service, and the bus, under the service's
        train lock."""
        with self.service._train_lock:
            self.channel.reset()
            self.controller.reset()
            self.controller.collection_enabled = True
            self.gate.reset(self._dparams0)
            self.service.reset()
            self.bus._latest = None
            self.bus.published = 0
            for extractor in self.extractors:
                extractor.reset()
            for sub in self.subs:
                sub.delivered_seq = 0
                sub.deliveries = 0
            for engine in self.engines:
                engine.reset_adaptation(self._dparams0)
        self.router = FleetRouter(self.n, self.fleet_cfg.route)

    # ------------------------------------------------------------- stats
    def summary(self) -> Dict:
        """Aggregate fleet summary.  ``agg_tokens_per_s`` divides total
        tokens by the slowest replica's wall (what a data-parallel
        deployment is bounded by)."""
        tokens = sum(e.stats.tokens_out for e in self.engines)
        walls = [e.stats.wall_s for e in self.engines]
        rounds = [e.stats.steps for e in self.engines]
        service_stats = self.service.stats()
        return {
            "replicas": self.n,
            "tokens": tokens,
            "replica_tokens": [e.stats.tokens_out for e in self.engines],
            "replica_rounds": rounds,
            "max_rounds": max(rounds) if rounds else 0,
            "replica_wall_s": walls,
            "max_wall_s": max(walls) if walls else 0.0,
            "agg_tokens_per_s": tokens / max(max(walls, default=0.0),
                                             1e-9),
            "deploys": sum(e.stats.deploys for e in self.engines),
            "bus": self.bus.stats(),
            "router_load": list(self.router.load),
            "router_assigned": list(self.router.assigned),
            "train_cycles": self.service.cycles,
            "deployed": self.gate.version,
            "trainer_failures": service_stats.get("failures", 0),
            "signals_collected": self.channel.total_added,
            "signals_dropped": self.channel.dropped,
        }
