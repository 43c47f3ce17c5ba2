"""Serving-side endpoints of the out-of-process trainer (port of
``repro/fleet/remote.py``).

``RemoteTrainingService`` stands in for the in-process
``training.service.TrainingService`` as the serving engine sees it (the
same ``poll``/``drain``/``reset``/``close``/``stats`` surface, the same
``events``/``cycles`` telemetry, the same ``_train_lock`` reset
protocol), but every training cycle runs in another process
(``repro_torch.fleet.trainer_main``), connected by the ``fleet.wire``
frame protocol.

Serving-path contract:

- **signals out** go through ``RemoteSignalChannel``, the in-process
  bounded drop-oldest ring (a ``SignalChannel`` whose ``_prepare`` keeps
  host arrays), drained onto the socket by a sender thread (async mode)
  or by ``drain()`` (sync mode).  ``add()`` is an append under a host
  lock: no sync, never blocked on the wire.
- **drafts in** arrive as DRAFT frames on a receiver thread, which
  decodes them into arrays viewing the frame and copies them to the
  serving device on a CUDA stream of its own, then waits for that
  stream (the receiver thread only) before it publishes into a
  ``RemoteDeploySource``, the lock-free newest-wins slot the engine
  polls once a superstep.  So the leaves are complete when the serving
  stream first reads them, and the serving thread gains no host sync;
  the engine's pickup records the serving stream on every leaf, so the
  allocator keeps their blocks from the receiver's stream while serving
  kernels that read them are queued.

Determinism: in sync mode ``drain()`` flushes buffered signals and a
DRAIN barrier over the socket in one critical section, and the trainer
emits every DRAFT/EVENT for the barrier's cycles before the DRAIN_ACK on
the same ordered stream, so when ``drain()`` returns the deploy slot
holds what the in-process schedule would have published.

Failure model: trainer death (EOF, ECONNRESET, a corrupt frame) marks
the service dead, counts a failure and wakes every waiter: serving keeps
the last published draft and never hangs; ``close()`` is idempotent and
never raises.

``"spawn"`` starts ``python -m repro_torch.fleet.trainer_main`` on a
private unix socket, on the serving side's device kind (a CPU engine
spawns a CPU trainer; a card engine a trainer on that card) and with its
torch intra-op thread count.  The wire figures (``wire_log``: spawn to
ready, the INIT and each DRAFT frame's bytes and seconds on both sides,
both processes' peak RSS) are host clock readings.
"""
from __future__ import annotations

import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from typing import Callable, Dict, List, Optional

import torch

from repro_torch.core.signals import SignalBatch
from repro_torch.core.transport import SignalChannel
from repro_torch.fleet import wire
from repro_torch.fleet.trainer_main import peak_rss_mb
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.serving.engine import resolve_device
from repro_torch.training.service import DraftVersion


class RemoteSignalChannel(SignalChannel):
    """The in-process drop-oldest signal ring, reused as the socket's
    send queue.  Producers (the signal extractor) are unchanged;
    ``_prepare`` keeps batches as host arrays for the sender instead of
    placing them on a trainer device that lives in another process."""

    def __init__(self, capacity: int = 512,
                 spill_dir: Optional[str] = None):
        super().__init__(capacity=capacity, device=None,
                         spill_dir=spill_dir)

    def _prepare(self, batch: SignalBatch) -> SignalBatch:
        return batch    # host arrays; the wire is the placement


class RemoteDeploySource:
    """Lock-free newest-wins slot for drafts received off the wire.
    Callable, so it is a valid engine ``deploy_source`` and a valid
    ``DraftVersionBus`` source."""

    def __init__(self):
        self._latest: Optional[DraftVersion] = None

    def publish(self, ver: DraftVersion):
        cur = self._latest
        if cur is None or ver.seq > cur.seq:
            self._latest = ver

    def poll(self) -> Optional[DraftVersion]:
        return self._latest

    __call__ = poll

    def reset(self):
        self._latest = None


class _GateView:
    """Serving-side mirror of the trainer process's deploy gate: tracks
    the highest published version, so ``summary()['deployed']`` and the
    reset protocol keep working without the gate's params."""

    def __init__(self):
        self.version = 0

    def observe(self, seq: int):
        if seq > self.version:
            self.version = seq

    def reset(self, dparams0=None):
        self.version = 0


class RemoteTrainingService:
    """Out-of-process ``TrainingService`` over the fleet wire protocol.

    ``endpoint``: ``"spawn"`` starts a private trainer process on a
    temporary unix socket; ``unix:/path`` / ``tcp:host:port`` connect to
    a running ``python -m repro_torch.fleet.trainer_main``.  ``device``
    is the serving device (default: the current CUDA card): published
    drafts land there, and a spawned trainer runs on its kind.

    ``poll_s`` bounds how long the async sender sleeps with nothing to
    send: a batch or ``close()`` wakes it at once, so the bound only
    paces its checks for a dead link.  JAX polls every 0.01 s; each
    wake-up takes the interpreter lock from the serving thread, whose
    idle supersteps on glm4-9b ran 739 and 805 ms at 0.01 s against 608
    ms at 1 s in one call (0.01, 1, 0.01 in turn;
    ``scripts/fleet_smoke.py``, PERF.md), so the port sleeps up to 1 s."""

    def __init__(self, endpoint: str, *, tcfg, dcfg, embed_params,
                 dparams0,
                 n_threshold: int = 2048, signal_window: int = 24,
                 train_epochs: int = 2, train_min_steps: int = 80,
                 seed: int = 0, async_train: bool = False,
                 channel_capacity: int = 512,
                 controller=None, selective: bool = False,
                 engine_steps_fn: Optional[Callable[[], int]] = None,
                 poll_s: float = 1.0,
                 connect_timeout: float = 180.0,
                 drain_timeout: float = 600.0,
                 device=None, tracer=None, registry=None):
        self.endpoint = endpoint
        self.device = resolve_device(device)
        self.async_train = async_train
        self.controller = controller
        self.selective = selective
        self.engine_steps_fn = engine_steps_fn or (lambda: -1)
        self.poll_s = poll_s
        self.drain_timeout = drain_timeout
        self.tracer = tracer if tracer is not None else NULL_TRACER

        self.channel = RemoteSignalChannel(
            capacity=max(channel_capacity,
                         -(-n_threshold // max(signal_window, 1))))
        self.deploy_source = RemoteDeploySource()
        self.gate = _GateView()
        self.events: List[Dict] = []
        self.cycles = 0
        self.deploys = 0
        self.failures = 0
        self.last_error: Optional[str] = None
        self._trainer_failures = 0   # high-water mark off DRAIN_ACKs
        self.frames_sent = 0
        self.bytes_sent = 0
        self.frames_recv = 0
        self.bytes_recv = 0
        # host-clock figures of the wire: "init" (bytes, encode and send
        # seconds), "spawn_to_ready_s", the trainer's HELLO-ack figures
        # ("trainer_ready", "trainer_pid"), one record per DRAFT frame
        # received ("drafts") and per cycle event's trainer figures
        # ("trainer")
        self.wire_log: Dict[str, object] = {"drafts": [], "trainer": []}

        self._train_lock = threading.RLock()
        self._send_lock = threading.Lock()
        self._stop = threading.Event()
        self._closed = threading.Event()
        self._closing = False
        self._dead = False
        self._ready = threading.Event()
        self._acks: Dict[int, Dict] = {}
        self._ack_cond = threading.Condition()
        self._token = 0
        self._sender: Optional[threading.Thread] = None
        self._receiver: Optional[threading.Thread] = None
        self._proc: Optional[subprocess.Popen] = None
        self._tmpdir: Optional[str] = None
        self._copy_stream = None     # the receiver's CUDA stream

        t0 = time.perf_counter()
        if endpoint == "spawn":
            endpoint = self._spawn()
        self._sock = self._connect_retry(endpoint, connect_timeout)
        hello = {
            "tcfg": wire.config_to_dict(tcfg),
            "dcfg": wire.config_to_dict(dcfg),
            "train": {"n_threshold": int(n_threshold),
                      "signal_window": int(signal_window),
                      "train_epochs": int(train_epochs),
                      "train_min_steps": int(train_min_steps),
                      "seed": int(seed)},
            "async": bool(async_train),
        }
        self._send(wire.FT_HELLO, wire.json_payload(hello))
        self._receiver = threading.Thread(target=self._recv_loop,
                                          name="tide-fleet-recv",
                                          daemon=True)
        self._receiver.start()
        t1 = time.perf_counter()
        init = {f"e/{k}": v
                for k, v in wire.flatten_tree(embed_params).items()}
        init.update({f"p/{k}": v
                     for k, v in wire.flatten_tree(dparams0).items()})
        payload = wire.npz_payload(init)
        del init
        t2 = time.perf_counter()
        try:
            self._send(wire.FT_INIT, payload)
        except OSError as exc:
            self._mark_dead(exc)
        t3 = time.perf_counter()
        self.wire_log["init"] = {"bytes": wire.HEADER.size + len(payload),
                                 "encode_s": t2 - t1, "send_s": t3 - t2}
        del payload
        if not self._ready.wait(connect_timeout) or self._dead:
            err = self.last_error or "no HELLO ack"
            self.close()
            raise RuntimeError(
                f"trainer at {endpoint} not ready within "
                f"{connect_timeout}s ({err})")
        self.wire_log["spawn_to_ready_s"] = time.perf_counter() - t0
        if registry is not None:
            self.register_metrics(registry)

    # ---------------------------------------------------------- transport
    def _spawn(self) -> str:
        self._tmpdir = tempfile.mkdtemp(prefix="tide-fleet-")
        endpoint = f"unix:{os.path.join(self._tmpdir, 'trainer.sock')}"
        env = dict(os.environ)
        import repro_torch
        # namespace package: no __file__, locate via __path__
        src = os.path.dirname(os.path.abspath(list(repro_torch.__path__)[0]))
        env["PYTHONPATH"] = src + (
            os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
        self._proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.fleet.trainer_main",
             "--listen", endpoint, "--device", str(self.device),
             "--threads", str(torch.get_num_threads())],
            env=env, stdin=subprocess.DEVNULL)
        return endpoint

    def _connect_retry(self, endpoint: str, timeout: float):
        deadline = time.monotonic() + timeout
        while True:
            if self._proc is not None and self._proc.poll() is not None:
                self._cleanup_spawn()
                raise RuntimeError(
                    f"trainer subprocess exited with code "
                    f"{self._proc.returncode} before accepting")
            try:
                return wire.connect(endpoint, timeout=1.0)
            except OSError as exc:
                if time.monotonic() >= deadline:
                    self._cleanup_spawn()
                    raise RuntimeError(
                        f"could not reach trainer at {endpoint} within "
                        f"{timeout}s: {exc}") from exc
                time.sleep(0.05)

    def _cleanup_spawn(self):
        if self._proc is not None and self._proc.poll() is None:
            self._proc.kill()
            self._proc.wait()
        if self._tmpdir is not None:
            shutil.rmtree(self._tmpdir, ignore_errors=True)
            self._tmpdir = None

    def _count_sent(self, n: int):
        self.frames_sent += 1
        self.bytes_sent += n

    def _send(self, ftype: int, payload=b""):
        with self._send_lock:
            self._count_sent(wire.send_frame(self._sock, ftype, payload))

    def _send_unlocked(self, ftype: int, payload=b""):
        self._count_sent(wire.send_frame(self._sock, ftype, payload))

    def _baseline(self) -> float:
        return (self.controller.alpha_train
                if self.controller is not None else 0.0)

    def _mark_dead(self, exc):
        if self._dead or self._closing:
            self._dead = True
        else:
            self._dead = True
            self.failures += 1
            self.last_error = f"{type(exc).__name__}: {exc}"
        self._ready.set()
        with self._ack_cond:
            self._ack_cond.notify_all()

    # ----------------------------------------------------------- receiver
    def _recv_loop(self):
        reader = wire.FrameReader()
        try:
            for ftype, _flags, payload in wire.recv_frames(self._sock,
                                                           reader):
                self.frames_recv += 1
                self.bytes_recv += wire.HEADER.size + len(payload)
                self._handle(ftype, payload)
        except Exception as exc:   # any fault ends the link, never a hang
            self._mark_dead(exc)
            return
        self._mark_dead(RuntimeError("trainer connection closed"))

    def _draft_to_device(self, tree):
        """The decoded draft on the serving device.  On a card the copy
        runs on the receiver's own stream, and this (receiver) thread
        waits for it, so the published leaves are complete."""
        if self.device.type != "cuda":
            return wire.tree_to_tensors(tree, self.device)
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(device=self.device)
        with torch.cuda.stream(self._copy_stream):
            dparams = wire.tree_to_tensors(tree, self.device)
        self._copy_stream.synchronize()
        return dparams

    def _handle(self, ftype: int, payload):
        if ftype == wire.FT_HELLO:
            ack = wire.decode_json(payload)
            self.wire_log["trainer_ready"] = {
                k: v for k, v in ack.items() if k.startswith("wire_")}
            self.wire_log["trainer_pid"] = ack.get("pid")
            self._ready.set()
        elif ftype == wire.FT_DRAFT:
            t0 = time.perf_counter()
            seq, tree, eval_acc = wire.decode_draft(payload)
            t1 = time.perf_counter()
            dparams = self._draft_to_device(tree)
            t2 = time.perf_counter()
            del tree
            self.wire_log["drafts"].append(
                {"seq": seq, "bytes": wire.HEADER.size + len(payload),
                 "decode_s": t1 - t0, "copy_s": t2 - t1,
                 "t_start": t0, "t_end": t2, "rss_mb": peak_rss_mb()})
            self.deploy_source.publish(DraftVersion(seq, dparams, eval_acc))
            self.gate.observe(seq)
            self.deploys += 1
            if self.tracer.enabled:
                self.tracer.instant("train.publish", seq=seq,
                                    eval_acc=eval_acc)
        elif ftype == wire.FT_EVENT:
            ev = wire.decode_json(payload)
            fig = {k: ev.pop(k) for k in list(ev) if k.startswith("wire_")}
            if ev.get("kind") == "train_cycle":
                ev["engine_steps"] = self.engine_steps_fn()
                self.events.append(ev)
                self.cycles += 1
                self.wire_log["trainer"].append(fig)
                if self.selective and self.controller is not None:
                    self.controller.training_result(ev["eval_acc"])
        elif ftype in (wire.FT_DRAIN_ACK, wire.FT_RESET_ACK):
            ack = wire.decode_json(payload)
            with self._ack_cond:
                self._acks[int(ack.get("token", -1))] = ack
                self._ack_cond.notify_all()
        # BYE and others: nothing to do

    def _await_ack(self, token: int, timeout: float) -> Optional[Dict]:
        deadline = time.monotonic() + timeout
        with self._ack_cond:
            while token not in self._acks:
                if self._dead:
                    return None
                left = deadline - time.monotonic()
                if left <= 0:
                    self.failures += 1
                    self.last_error = (f"timed out after {timeout}s "
                                       "waiting for trainer ack")
                    return None
                self._ack_cond.wait(timeout=min(left, 1.0))
            return self._acks.pop(token)

    # ------------------------------------------------------------- sender
    def start(self):
        """Start the background signal sender (async mode).  The
        trainer-side cycle loop was started by the handshake."""
        if self._sender is not None and self._sender.is_alive():
            return
        self._sender = threading.Thread(target=self._send_loop,
                                        name="tide-fleet-send",
                                        daemon=True)
        self._sender.start()

    def _flush_unlocked(self):
        batches = self.channel.drain()
        if batches:
            self._send_unlocked(wire.FT_SIGNALS,
                                wire.signals_payload(batches,
                                                     self._baseline()))

    def _send_loop(self):
        while not self._stop.is_set() and not self._dead:
            self.channel.wait(1, timeout=self.poll_s)
            if self._stop.is_set() or self._dead:
                break
            try:
                with self._send_lock:
                    self._flush_unlocked()
            except OSError as exc:
                self._mark_dead(exc)
                break

    # ------------------------------------------------- service interface
    def poll(self) -> Optional[DraftVersion]:
        """Lock-free read of the latest received deploy (or None)."""
        return self.deploy_source.poll()

    def drain(self) -> int:
        """Deterministic barrier: flush buffered signals and run every
        cycle they allow in the trainer process, blocking until its
        DRAIN_ACK.  The trainer emits all DRAFT/EVENT frames of those
        cycles before the ack on the same ordered stream, so the deploy
        slot is final when this returns.  Returns the cycles run; 0
        (never a hang) if the trainer is dead."""
        with self._train_lock:
            if self._dead or self._closing:
                return 0
            self._token += 1
            token = self._token
            try:
                with self._send_lock:
                    self._flush_unlocked()
                    self._send_unlocked(
                        wire.FT_DRAIN, wire.json_payload({"token": token}))
            except OSError as exc:
                self._mark_dead(exc)
                return 0
            ack = self._await_ack(token, self.drain_timeout)
            if ack is None:
                return 0
            # trainer-side cycle failures ride back on the ack: mirror
            # them, so summary()/stats() show the degradation although
            # the trainer process caught the exception
            tf = int(ack.get("failures", 0))
            if tf > self._trainer_failures:
                self.failures += tf - self._trainer_failures
                self._trainer_failures = tf
                self.last_error = ("trainer-side cycle failure "
                                   "(see trainer process log)")
            return int(ack["cycles"])

    def reset(self):
        """Round-trip reset: clear the serving-side mirrors, then reset
        the trainer process (gate back to the initial draft, channel and
        cycle history cleared).  Degrades to a local clear if the
        trainer is dead."""
        with self._train_lock:
            self.channel.reset()
            self.deploy_source.reset()
            self.gate.reset()
            self.events.clear()
            self.cycles = 0
            self.deploys = 0
            self.failures = 0
            self.last_error = None
            self._trainer_failures = 0
            if self._dead or self._closing:
                return
            self._token += 1
            token = self._token
            try:
                self._send(wire.FT_RESET, wire.json_payload(
                    {"token": token}))
            except OSError as exc:
                self._mark_dead(exc)
                return
            self._await_ack(token, self.drain_timeout)

    @property
    def running(self) -> bool:
        return (not self._dead and self._receiver is not None
                and self._receiver.is_alive())

    def kill_trainer(self):
        """Hard-kill a spawned trainer process (failure injection).
        Serving must keep the last published draft, never hang."""
        if self._proc is not None:
            self._proc.kill()

    def close(self, timeout: float = 10.0):
        """Idempotent, never raises, never hangs: best-effort BYE, close
        the socket, join the threads with a bound, reap a spawned
        process."""
        if self._closed.is_set():
            return
        self._closed.set()
        self._closing = True
        self._stop.set()
        self.channel.close()
        try:
            self._send(wire.FT_BYE)
        except OSError:
            pass
        try:
            self._sock.shutdown(2)   # SHUT_RDWR: wakes the receiver
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        for t in (self._sender, self._receiver):
            if t is not None and t.is_alive():
                t.join(timeout=timeout)
        if self._proc is not None:
            try:
                self._proc.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                self._proc.terminate()
                try:
                    self._proc.wait(timeout=5.0)
                except subprocess.TimeoutExpired:
                    self._proc.kill()
                    self._proc.wait()
        if self._tmpdir is not None:
            shutil.rmtree(self._tmpdir, ignore_errors=True)
            self._tmpdir = None

    # --------------------------------------------------------------- stats
    def stats(self) -> Dict:
        return {"cycles": self.cycles, "deploy_version": self.gate.version,
                "running": self.running, "trainer_threads": 0,
                "thread_cap": "process",
                "failures": self.failures, "last_error": self.last_error,
                "frames_sent": self.frames_sent,
                "bytes_sent": self.bytes_sent,
                "frames_recv": self.frames_recv,
                "bytes_recv": self.bytes_recv,
                **self.channel.stats()}

    def register_metrics(self, registry):
        registry.gauge("train.cycles", fn=lambda: self.cycles)
        registry.gauge("train.deploy_version",
                       fn=lambda: self.gate.version)
        registry.gauge("train.running", fn=lambda: int(self.running))
        registry.gauge("train.trainer_failures", fn=lambda: self.failures)
        registry.gauge("train.wire_bytes_sent", fn=lambda: self.bytes_sent)
        registry.gauge("train.wire_bytes_recv", fn=lambda: self.bytes_recv)
        self.channel.register_metrics(registry)
