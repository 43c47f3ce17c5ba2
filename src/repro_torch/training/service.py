"""Decoupled draft-training service (port of
``repro/training/service.py``, paper §3.3 + §5.5).

Runs ``DraftTrainer.train_cycle`` off the serving path: signals arrive
through a bounded ``core.transport.SignalChannel``, cycles run on a
background thread (``start``) or, in JAX's deterministic parity mode, at
request-completion boundaries on the caller's thread (``drain``), and
every draft the ``DraftDeployGate`` accepts is published as a versioned
``DraftVersion`` into a "latest deploy" slot.  The serving engine reads
that slot (``poll``) once a superstep, a Python attribute read, and
hot-swaps the draft before its next dispatch.

The ``TrainingController`` (Algorithm 1) decides *whether* a cycle
deploys and whether collection goes on; the service only decides that
training never blocks serving.

On a CUDA card the background thread trains on a stream of its own
(the current stream is per thread, and a new thread starts on the
default stream, which serving uses):

  * each cycle runs under ``torch.cuda.stream(s)``, ``s`` a
    ``torch.cuda.Stream`` the service owns on its training card, so the
    hand-written kernels, which launch on the current stream, follow;
  * at the start of a cycle the training stream waits on the stream that
    made the gate's current draft, at the point where ``start`` (or
    ``reset``) handed it over: the caller's stream then, or the
    training stream itself after a publish;
  * a draft is published only after the thread has synchronized its
    own stream (the ``publish_device`` copy included), so serving never
    waits on it;
  * the engine's pickup records its stream on every leaf of a new draft
    (``ServingEngine._poll_deploy``), so the caching allocator does not
    hand the training stream a block that queued serving kernels still
    read.

Neither thread synchronizes the whole device: the trainer's one
``.tolist()`` a step waits for the training stream alone.  ``drain``
stays on the caller's thread and stream.
"""
from __future__ import annotations

import contextlib
import os
import threading
from typing import Any, Callable, Dict, List, NamedTuple, Optional

import torch

from repro_torch.checkpoint import bridge
from repro_torch.checkpoint.ckpt import DraftDeployGate
from repro_torch.core.controller import TrainingController
from repro_torch.core.transport import SignalChannel
from repro_torch.models.param import ParamTree
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.training.draft_trainer import DraftTrainer


class DraftVersion(NamedTuple):
    """One published draft deploy: monotonic sequence number (the deploy
    gate's version counter), the parameters, and the eval acceptance
    that won the gate."""
    seq: int
    dparams: Any
    eval_acc: float


class TrainingService:
    """Draft-training cycles around a ``DraftTrainer``.

    ``train_once``/``drain`` are serialized by a reentrant lock (the
    background loop and an explicit ``drain`` never run a cycle at once;
    ``TideSystem.reset_adaptation`` also holds it across its compound
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
                 poll_s: float = 0.05,
                 baseline_fn: Optional[Callable[[], float]] = None,
                 on_publish: Optional[Callable[["DraftVersion"], None]] = None,
                 on_event: Optional[Callable[[Dict], None]] = None,
                 tracer=None, registry=None):
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
        # the card the background thread trains on (None: the trainer's)
        # and the card a published draft is copied to (None: left where
        # it was trained)
        self.device = None if device is None else torch.device(device)
        self.publish_device = (None if publish_device is None
                               else torch.device(publish_device))
        # trainer-thread contention knob (ServingConfig.trainer_threads):
        # > 0 lowers the background thread's OS scheduling priority
        # (Linux per-thread nice), so the serving thread wins the host's
        # cores whenever both are runnable.  ``stats()`` reports the
        # mechanism applied ("thread_nice" or None).
        self.trainer_threads = int(trainer_threads)
        self._thread_cap: Optional[str] = None
        self.engine_steps_fn = engine_steps_fn or (lambda: -1)
        self.poll_s = poll_s
        # fleet hooks (a trainer in another process): baseline_fn stands
        # in for the in-process controller's alpha_train; on_publish and
        # on_event mirror accepted deploys and cycle events.  All
        # optional; the in-process path never sets them.
        self.baseline_fn = baseline_fn
        self.on_publish = on_publish
        self.on_event = on_event
        self.events: List[Dict] = []
        self.cycles = 0
        self.failures = 0
        self.last_error: Optional[str] = None
        self._latest: Optional[DraftVersion] = None   # lock-free slot
        self._train_lock = threading.RLock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # the background thread's CUDA streams (made by ``start`` on a
        # card) and the hand-over event its stream waits on each cycle
        self._stream: Optional[torch.cuda.Stream] = None
        self._publish_stream: Optional[torch.cuda.Stream] = None
        self._handover: Optional[torch.cuda.Event] = None
        capacity = getattr(channel, "capacity", None)
        if capacity is not None and capacity < self._min_batches():
            raise ValueError(
                f"SignalChannel capacity {capacity} can never buffer the "
                f"{self._min_batches()} windows one train cycle needs "
                f"(n_threshold={n_threshold} / signal_window="
                f"{signal_window}); training would silently starve")

    # ------------------------------------------------------------ control
    def _deprioritize_thread(self) -> Optional[str]:
        """Lower the calling (training) thread's OS scheduling priority
        (Linux threads are schedulable tasks, so a per-thread nice bounds
        how much host time a cycle takes from the serving thread)."""
        try:
            tid = threading.get_native_id()
            cur = os.getpriority(os.PRIO_PROCESS, tid)
            os.setpriority(os.PRIO_PROCESS, tid, min(cur + 10, 19))
            return "thread_nice"
        except (AttributeError, OSError, PermissionError):
            return None

    def should_train(self) -> bool:
        """Enough signal windows buffered for one cycle."""
        return (self.channel.peek_count() * self.signal_window
                >= self.n_threshold)

    def _min_batches(self) -> int:
        return max(-(-self.n_threshold // max(self.signal_window, 1)), 1)

    # ----------------------------------------------------------- training
    def train_once(self) -> bool:
        """Run one training cycle if ``should_train``; returns whether a
        cycle ran.  Safe from any thread."""
        with self._train_lock:
            if not self.should_train():
                return False
            batches = self.channel.drain()
            if self.controller is not None:
                baseline = self.controller.alpha_train
            elif self.baseline_fn is not None:
                baseline = self.baseline_fn()
            else:
                baseline = 0.0
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
                dp = result["dparams"]
                if self.publish_device is not None:
                    # ship the accepted draft to the serving card now, so
                    # the engine's hot-swap is a reference swap
                    dp = self._publish_copy(dp)
                self._publish_barrier()
                self._latest = DraftVersion(self.gate.version, dp,
                                            result["eval_acc"])
                if self.on_publish is not None:
                    self.on_publish(self._latest)
                if self.tracer.enabled:
                    self.tracer.instant("train.publish",
                                        seq=self.gate.version,
                                        eval_acc=result["eval_acc"])
            event = {
                "kind": "train_cycle", "eval_acc": result["eval_acc"],
                "train_acc": result["train_acc"], "baseline": baseline,
                "deployed": deployed, "steps": result["steps"],
                "seconds": result["seconds"],
                "engine_steps": self.engine_steps_fn(),
            }
            self.events.append(event)
            if self.on_event is not None:
                self.on_event(event)
            self.cycles += 1
            return True

    def _publish_copy(self, dparams) -> ParamTree:
        """The draft on ``publish_device``.  A card-to-card copy runs on
        the service's own stream of the destination card, so it never
        orders itself against the serving thread's stream there."""
        dev = self.publish_device
        if dev.type != "cuda" or self._stream is None:
            return bridge.tree_to(dparams, dev, non_blocking=True)
        if self._publish_stream is None:
            self._publish_stream = torch.cuda.Stream(device=dev)
        self._publish_stream.wait_stream(self._stream)
        with torch.cuda.stream(self._publish_stream):
            return bridge.tree_to(dparams, dev, non_blocking=True)

    def _publish_barrier(self):
        """On the background thread's stream: wait until the draft (and
        its publish copy) is written, so a reader on any stream may use
        it at once.  Synchronizes that stream alone; a no-op on the
        caller's thread (``drain``)."""
        s = self._stream
        if s is None or torch.cuda.current_stream(s.device) != s:
            return
        s.synchronize()
        if self._publish_stream is not None:
            self._publish_stream.synchronize()

    def drain(self) -> int:
        """Synchronously run every cycle the buffered signals allow, on
        the caller's thread and stream.  Returns the number of cycles
        run.  A cycle that raises is counted in ``failures``/
        ``last_error`` and ends the drain (returning the cycles that
        completed): serving keeps the last published draft and goes
        on."""
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
        """Clear the deploy slot and cycle history (waits for any cycle
        in flight; the background thread keeps running).  The gate's
        draft after a reset was made on the caller's stream, so the
        training stream waits on it again."""
        with self._train_lock:
            self._latest = None
            self.events.clear()
            self.cycles = 0
            self.failures = 0
            self.last_error = None
            self._hand_over()

    # ------------------------------------------------------------- thread
    def _hand_over(self):
        """Record where the caller's stream stands: the training stream
        starts each cycle behind it (the gate's draft and the frozen
        embeddings were made there)."""
        if self._stream is not None:
            self._handover = torch.cuda.current_stream(
                self._stream.device).record_event()

    def start(self):
        """Start (or restart) the background training loop."""
        if self._thread is not None and self._thread.is_alive():
            return
        dev = (self.device if self.device is not None
               else getattr(self.trainer, "device", None))
        if self._stream is None and dev is not None and dev.type == "cuda":
            self._stream = torch.cuda.Stream(device=dev)
        self._hand_over()
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="tide-draft-training", daemon=True)
        self._thread.start()

    @contextlib.contextmanager
    def _on_stream(self):
        """One cycle of the background thread: on the training card and
        the service's stream, behind the hand-over point."""
        s = self._stream
        if s is None:
            yield
            return
        with torch.cuda.device(s.device), torch.cuda.stream(s):
            if self._handover is not None:
                s.wait_event(self._handover)
            yield

    def _loop(self):
        if self.trainer_threads > 0:
            self._thread_cap = self._deprioritize_thread()
        while not self._stop.is_set():
            self.channel.wait(self._min_batches(), timeout=self.poll_s)
            if self._stop.is_set():
                break
            if self.should_train():
                try:
                    with self._on_stream():
                        self.train_once()
                except Exception as exc:   # trainer died: stop the loop,
                    self._record_failure(exc)   # keep the last deploy
                    break

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def close(self, timeout: float = 30.0):
        """Stop the loop and join the thread.  Idempotent, and safe after
        a trainer died: a thread that does not join within ``timeout``
        (wedged inside a cycle) is abandoned (it is a daemon) and counted
        in ``failures``; close never raises and never hangs serving
        shutdown.  The channel is closed (waking a blocked waiter) but
        its buffered signals stay drainable."""
        self._stop.set()
        self.channel.close()
        t, self._thread = self._thread, None
        if t is not None and t.is_alive():
            t.join(timeout=timeout)
            if t.is_alive():
                self._record_failure(RuntimeError(
                    f"training thread failed to stop within {timeout}s; "
                    "abandoned (daemon)"))

    # --------------------------------------------------------------- stats
    def stats(self) -> Dict:
        return {"cycles": self.cycles, "deploy_version": self.gate.version,
                "running": self.running,
                "trainer_threads": self.trainer_threads,
                "thread_cap": self._thread_cap,
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
