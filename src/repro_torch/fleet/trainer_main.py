"""The draft trainer in a process of its own (port of
``repro/fleet/trainer_main.py``).

``python -m repro_torch.fleet.trainer_main --listen unix:/path`` (or
``tcp:host:port``) accepts one serving-side connection and runs the
port's ``training.service.TrainingService`` in this process: its own
interpreter (the serving process's interpreter lock never waits on a
training step) and, on a card, its own CUDA context.  It runs on the
card unless ``--device cpu`` is given, and ``--threads N`` sets torch's
intra-op threads (the spawner passes its own, so a CPU trainer computes
as the in-process one does).

Protocol (``fleet.wire``): the serving side opens with HELLO (model and
draft configs, train kwargs, async flag) and INIT (frozen embeddings and
the initial draft); the host builds the trainer stack, starts the
background service in async mode, and only then acks HELLO, so the ack
means "ready" (JAX acks first and starts the service after, so a client
can see the ack before the service runs).  Then it loops on SIGNALS /
DRAIN / RESET / BYE.  Published drafts and cycle events stream back as
DRAFT / EVENT frames through the service's ``on_publish``/``on_event``
hooks: in async mode from the background loop, in sync mode inline
before the DRAIN_ACK, which makes the remote drain barrier deterministic
for the serving engine.

Besides JAX's fields, the HELLO ack carries the INIT's decode and copy
seconds, and each EVENT the cycle's end on the host clock, the DRAFT
frame it published (bytes, encode and send seconds), this process's
resident set (its largest sample so far) and peak device memory, all
under ``wire_`` keys, which the serving
side files apart from the cycle events (``RemoteTrainingService
.wire_log``).

``TrainerHost`` is transport-agnostic (any connected stream socket), so
tests drive the whole protocol over ``socket.socketpair()`` with a stub
service factory.
"""
from __future__ import annotations

import argparse
import os
import resource
import threading
import time
from typing import Callable, Dict, Optional

import torch

from repro_torch.fleet import wire
from repro_torch.models.param import unflatten
from repro_torch.serving.engine import resolve_device


def peak_rss_mb() -> float:
    """This process's peak resident set since it started, MB
    (``getrusage``; Linux reports KiB).  A process started by fork and
    exec may report its parent's peak here, so the trainer process
    samples its own (``rss_mb``)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


def rss_mb() -> Optional[float]:
    """This process's resident set now, MB (``/proc/self/statm``), or
    None where /proc does not say."""
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
    except (OSError, ValueError, IndexError):
        return None
    return pages * os.sysconf("SC_PAGE_SIZE") / 2 ** 20


def default_service_factory(hello: Dict, embed, dparams0,
                            host: "TrainerHost"):
    """Build the trainer stack from the handshake: a ``DraftTrainer`` on
    this process's device, a deploy gate seeded with the shipped draft,
    and a ``TrainingService`` whose baseline comes off the wire (the
    serving side ships its controller's ``alpha_train`` with each
    SIGNALS frame) and whose publish and event hooks frame straight back
    onto the socket."""
    from repro_torch.checkpoint import bridge
    from repro_torch.checkpoint.ckpt import DraftDeployGate
    from repro_torch.core import eagle
    from repro_torch.core.transport import SignalChannel
    from repro_torch.models.param import check_tree
    from repro_torch.training.draft_trainer import DraftTrainer
    from repro_torch.training.service import TrainingService

    tcfg = wire.config_from_dict(hello["tcfg"])
    dcfg = wire.config_from_dict(hello["dcfg"])
    check_tree(eagle.draft_specs(dcfg), unflatten(bridge.flat(dparams0)))
    t = hello["train"]
    trainer = DraftTrainer(tcfg, dcfg, embed, device=host.device)
    gate = DraftDeployGate(dparams0)
    min_batches = -(-int(t["n_threshold"]) // max(int(t["signal_window"]),
                                                 1))
    channel = SignalChannel(capacity=max(512, min_batches))
    return TrainingService(
        trainer, gate, channel,
        controller=None, selective=False,
        n_threshold=int(t["n_threshold"]),
        signal_window=int(t["signal_window"]),
        train_epochs=int(t["train_epochs"]),
        train_min_steps=int(t["train_min_steps"]),
        seed=int(t["seed"]),
        baseline_fn=lambda: host.baseline,
        on_publish=host.send_draft,
        on_event=host.send_event)


class TrainerHost:
    """One serving connection's trainer: handshake, then frame loop.

    ``conn`` is any connected stream socket.  ``service_factory(hello,
    embed, dparams0, host)`` builds the service from the handshake, the
    trees already tensors on ``device`` (tests substitute a stub)."""

    def __init__(self, conn, service_factory: Optional[Callable] = None,
                 device=None):
        self.conn = conn
        self.service_factory = service_factory or default_service_factory
        self.device = resolve_device(device)
        self.baseline = 0.0       # freshest serving-side deploy baseline
        self.service = None
        self.dparams0 = None
        self._send_lock = threading.Lock()
        self._draft_wire: Dict = {}   # the last DRAFT frame's figures
        # the largest resident set seen where this process holds the most:
        # an INIT's arrays with its frame, a DRAFT's frame, each event
        self.rss_peak_mb: Optional[float] = None

    def _note_rss(self):
        now = rss_mb()
        if now is not None:
            self.rss_peak_mb = max(now, self.rss_peak_mb or 0.0)

    # ------------------------------------------------------------- frames
    def _send(self, ftype: int, payload=b"") -> int:
        with self._send_lock:
            return wire.send_frame(self.conn, ftype, payload)

    def send_draft(self, ver):
        t0 = time.perf_counter()
        payload = wire.draft_payload(ver.seq, ver.dparams, ver.eval_acc)
        t1 = time.perf_counter()
        self._note_rss()
        sent = self._send(wire.FT_DRAFT, payload)
        self._draft_wire = {"wire_cycle_end_t": t0,
                            "wire_draft_bytes": sent,
                            "wire_draft_encode_s": t1 - t0,
                            "wire_draft_send_s": time.perf_counter() - t1}

    def send_event(self, event: Dict):
        """One cycle's event, with this process's figures under ``wire_``
        keys: the cycle's end on the host's monotonic clock (what
        ``time.perf_counter`` reads in every process of a Linux host),
        the DRAFT frame it published, peak RSS and device memory."""
        body = {k: v for k, v in event.items()
                if isinstance(v, (str, int, float, bool)) or v is None}
        body["wire_cycle_end_t"] = time.perf_counter()
        self._note_rss()
        body.update(self._draft_wire, wire_rss_mb=self.rss_peak_mb)
        if self.device.type == "cuda":
            body["wire_device_peak_gb"] = \
                torch.cuda.max_memory_allocated(self.device) / 1e9
        self._draft_wire = {}
        self._send(wire.FT_EVENT, wire.json_payload(body))

    # --------------------------------------------------------------- loop
    def run(self):
        reader = wire.FrameReader()
        frames = wire.recv_frames(self.conn, reader)
        try:
            self._handshake(frames)
            for ftype, _flags, payload in frames:
                if ftype == wire.FT_SIGNALS:
                    batches, baseline = wire.decode_signals(payload)
                    self.baseline = baseline
                    for b in batches:
                        self.service.channel.add(b)
                elif ftype == wire.FT_DRAIN:
                    token = wire.decode_json(payload).get("token", -1)
                    cycles = self.service.drain()
                    self._send(wire.FT_DRAIN_ACK, wire.json_payload(
                        {"token": token, "cycles": cycles,
                         "version": self.service.gate.version,
                         "failures": self.service.failures}))
                elif ftype == wire.FT_RESET:
                    token = wire.decode_json(payload).get("token", -1)
                    with self.service._train_lock:
                        self.service.channel.reset()
                        self.service.gate.reset(self.dparams0)
                        self.service.reset()
                    self.baseline = 0.0
                    self._send(wire.FT_RESET_ACK,
                               wire.json_payload({"token": token}))
                elif ftype == wire.FT_BYE:
                    break
                else:
                    raise wire.WireError(
                        f"unexpected frame "
                        f"{wire.FRAME_NAMES.get(ftype, ftype)} "
                        "from serving side")
        finally:
            if self.service is not None:
                self.service.close()   # never raises (abandons on wedge)

    def _handshake(self, frames):
        _ftype, _flags, payload = self._next(frames, wire.FT_HELLO)
        hello = wire.decode_json(payload)
        _ftype, _flags, payload = self._next(frames, wire.FT_INIT)
        t0 = time.perf_counter()
        arrays = wire.decode_npz(payload)
        t1 = time.perf_counter()
        embed = wire.tree_to_tensors(unflatten(
            {k[2:]: v for k, v in arrays.items() if k.startswith("e/")}),
            self.device)
        self.dparams0 = wire.tree_to_tensors(unflatten(
            {k[2:]: v for k, v in arrays.items() if k.startswith("p/")}),
            self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t2 = time.perf_counter()
        self._note_rss()
        del arrays, payload
        self.service = self.service_factory(hello, embed, self.dparams0,
                                            self)
        if hello.get("async"):
            # started before the ack: the ack means the service runs
            self.service.start()
        self._send(wire.FT_HELLO, wire.json_payload(
            {"ok": True, "pid": os.getpid(), "wire_init_decode_s": t1 - t0,
             "wire_init_copy_s": t2 - t1, "wire_rss_mb": self.rss_peak_mb}))

    @staticmethod
    def _next(frames, expect: int):
        for frame in frames:
            if frame[0] != expect:
                raise wire.WireError(
                    f"handshake expected {wire.FRAME_NAMES[expect]}, got "
                    f"{wire.FRAME_NAMES.get(frame[0], frame[0])}")
            return frame
        raise wire.WireError(
            f"connection closed before {wire.FRAME_NAMES[expect]}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="TIDE out-of-process draft trainer (PyTorch port)")
    parser.add_argument("--listen", required=True,
                        help="unix:/path or tcp:host:port to listen on")
    parser.add_argument("--device", default=None,
                        help="torch device to train on (default: the "
                             "current CUDA card; 'cpu' for the CPU)")
    parser.add_argument("--threads", type=int, default=0,
                        help=">0: torch intra-op threads")
    args = parser.parse_args(argv)
    if args.threads > 0:
        torch.set_num_threads(args.threads)
    device = resolve_device(args.device)
    srv = wire.listen(args.listen)
    try:
        conn, _addr = srv.accept()
        try:
            TrainerHost(conn, device=device).run()
        finally:
            conn.close()
    finally:
        srv.close()
        kind, addr = wire.parse_endpoint(args.listen)
        if kind == "unix":
            try:
                os.unlink(addr)
            except OSError:
                pass
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
