"""Draft-training service, synchronous surface (port of
``repro/training/service.py``, paper §3.3 + §5.5).

Signals arrive through a bounded ``core.transport.SignalChannel``;
``drain()``, called at request-completion boundaries, runs every
``DraftTrainer.train_cycle`` the buffered windows allow, offers each
trained draft to the ``DraftDeployGate`` and publishes an accepted one
as a versioned ``DraftVersion`` into a "latest deploy" slot.  The
serving engine reads that slot (``poll``) through its ``_poll_deploy``
and hot-swaps the draft before its next dispatch.  This is JAX's
deterministic parity mode: the same training schedule, byte for byte.

The ``TrainingController`` (Algorithm 1) decides *whether* a cycle
deploys and whether collection goes on; the service runs the cycle.

The background thread (``start``), a training device apart from the
serving one (``device``, ``publish_device``) and ``trainer_threads``
are the asynchronous half of the loop, ROADMAP queue 1 item 2; they
raise ``NotImplementedError`` until it is ported.
"""
from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, NamedTuple, Optional

from repro_torch.checkpoint.ckpt import DraftDeployGate
from repro_torch.core.controller import TrainingController
from repro_torch.core.transport import SignalChannel
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.training.draft_trainer import DraftTrainer

_ASYNC = "(ROADMAP queue 1 item 2: asynchronous adaptation loop)"


class DraftVersion(NamedTuple):
    """One published draft deploy: monotonic sequence number (the deploy
    gate's version counter), the parameters, and the eval acceptance
    that won the gate."""
    seq: int
    dparams: Any
    eval_acc: float


class TrainingService:
    """Draft-training cycles around a ``DraftTrainer``.

    ``train_once``/``drain`` are serialized by a reentrant lock (which
    ``TideSystem.reset_adaptation`` also holds across its compound
    reset).  The deploy slot is one attribute set after the gate
    accepts: a reader sees the old or the new ``DraftVersion``, never a
    partial one."""

    def __init__(self, trainer: DraftTrainer, gate: DraftDeployGate,
                 channel: SignalChannel, *,
                 controller: Optional[TrainingController] = None,
                 selective: bool = True,
                 n_threshold: int = 2048, signal_window: int = 24,
                 train_epochs: int = 2, train_min_steps: int = 80,
                 seed: int = 0,
                 device=None, publish_device=None,
                 trainer_threads: int = 0,
                 engine_steps_fn: Optional[Callable[[], int]] = None,
                 tracer=None, registry=None):
        for bad, what in ((device is not None, "device"),
                          (publish_device is not None, "publish_device"),
                          (trainer_threads > 0, "trainer_threads>0")):
            if bad:
                raise NotImplementedError(
                    f"TrainingService({what}) is not ported yet {_ASYNC}")
        self.trainer = trainer
        self.gate = gate
        self.channel = channel
        # observability (host-side): train-cycle spans and publish
        # instants on the shared tracer, ``train.*`` gauges on the shared
        # registry; both optional and null-cheap
        self.tracer = tracer if tracer is not None else NULL_TRACER
        if registry is not None:
            self.register_metrics(registry)
        self.controller = controller
        self.selective = selective
        self.n_threshold = n_threshold
        self.signal_window = signal_window
        self.train_epochs = train_epochs
        self.train_min_steps = train_min_steps
        self.seed = seed
        self.engine_steps_fn = engine_steps_fn or (lambda: -1)
        self.events: List[Dict] = []
        self.cycles = 0
        self.failures = 0
        self.last_error: Optional[str] = None
        self._latest: Optional[DraftVersion] = None
        self._train_lock = threading.RLock()
        capacity = getattr(channel, "capacity", None)
        if capacity is not None and capacity < self._min_batches():
            raise ValueError(
                f"SignalChannel capacity {capacity} can never buffer the "
                f"{self._min_batches()} windows one train cycle needs "
                f"(n_threshold={n_threshold} / signal_window="
                f"{signal_window}); training would silently starve")

    # ------------------------------------------------------------ control
    def should_train(self) -> bool:
        """Enough signal windows buffered for one cycle."""
        return (self.channel.peek_count() * self.signal_window
                >= self.n_threshold)

    def _min_batches(self) -> int:
        return max(-(-self.n_threshold // max(self.signal_window, 1)), 1)

    # ----------------------------------------------------------- training
    def train_once(self) -> bool:
        """Run one training cycle if ``should_train``; returns whether a
        cycle ran."""
        with self._train_lock:
            if not self.should_train():
                return False
            batches = self.channel.drain()
            baseline = (self.controller.alpha_train
                        if self.controller is not None else 0.0)
            dparams, _ = self.gate.current()
            with self.tracer.span("train.cycle", batches=len(batches)):
                result = self.trainer.train_cycle(
                    dparams, batches, epochs=self.train_epochs,
                    min_steps=self.train_min_steps, seed=self.seed)
            deployed = self.gate.offer(result["dparams"],
                                       result["eval_acc"], baseline)
            if self.selective and self.controller is not None:
                self.controller.training_result(result["eval_acc"])
            if deployed:
                self._latest = DraftVersion(self.gate.version,
                                            result["dparams"],
                                            result["eval_acc"])
                if self.tracer.enabled:
                    self.tracer.instant("train.publish",
                                        seq=self.gate.version,
                                        eval_acc=result["eval_acc"])
            self.events.append({
                "kind": "train_cycle", "eval_acc": result["eval_acc"],
                "train_acc": result["train_acc"], "baseline": baseline,
                "deployed": deployed, "steps": result["steps"],
                "seconds": result["seconds"],
                "engine_steps": self.engine_steps_fn(),
            })
            self.cycles += 1
            return True

    def drain(self) -> int:
        """Synchronously run every cycle the buffered signals allow.
        Returns the number of cycles run.  A cycle that raises is counted
        in ``failures``/``last_error`` and ends the drain (returning the
        cycles that completed): serving keeps the last published draft
        and goes on."""
        n = 0
        while True:
            try:
                if not self.train_once():
                    break
            except Exception as exc:  # degrade, don't kill serving
                self._record_failure(exc)
                break
            n += 1
        return n

    def _record_failure(self, exc: Exception):
        self.failures += 1
        self.last_error = f"{type(exc).__name__}: {exc}"

    def poll(self) -> Optional[DraftVersion]:
        """Lock-free read of the latest accepted deploy (or None)."""
        return self._latest

    def reset(self):
        """Clear the deploy slot and cycle history."""
        with self._train_lock:
            self._latest = None
            self.events.clear()
            self.cycles = 0
            self.failures = 0
            self.last_error = None

    # ------------------------------------------------------------- thread
    def start(self):
        raise NotImplementedError(
            f"TrainingService.start (the background training thread) is "
            f"not ported yet {_ASYNC}")

    @property
    def running(self) -> bool:
        """Whether a background loop runs: never, in this slice."""
        return False

    def close(self):
        """Close the channel (its buffered signals stay drainable).
        Idempotent."""
        self.channel.close()

    # --------------------------------------------------------------- stats
    def stats(self) -> Dict:
        return {"cycles": self.cycles, "deploy_version": self.gate.version,
                "running": self.running,
                "trainer_threads": 0, "thread_cap": None,
                "failures": self.failures, "last_error": self.last_error,
                **self.channel.stats()}

    def register_metrics(self, registry):
        """The service and its channel as ``train.*`` callback gauges;
        ``stats()`` is a view over the same state."""
        registry.gauge("train.cycles", fn=lambda: self.cycles)
        registry.gauge("train.deploy_version",
                       fn=lambda: self.gate.version)
        registry.gauge("train.running", fn=lambda: int(self.running))
        self.channel.register_metrics(registry)
