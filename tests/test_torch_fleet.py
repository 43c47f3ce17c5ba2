"""The port's fleet (``repro_torch/fleet``) against JAX's on the CPU.

* JAX's ``tests/test_fleet.py`` protocol cases on the port: the config,
  router, bus, deploy source, gate view and remote channel; the
  ``TrainerHost`` protocol over ``socket.socketpair()`` with a stub
  service (DRAFT and EVENT strictly before the DRAIN_ACK, RESET, BYE);
  the handshake errors and EOF; ``RemoteTrainingService`` against a
  trainer host thread (drain, pickup, reset, close); trainer death that
  degrades and never hangs; a clean connect failure.  Every wait has a
  bound.  The async handshake waits on the ack alone: the port starts
  the service before it acks (JAX acks first, the race behind JAX's
  flaky ``test_trainer_host_async_handshake_starts_service``).
* On tide_tiny pretrained 40 steps in JAX (as tests/test_torch_tide.py),
  JAX's initial draft bridged in, with JAX's fleet configuration
  (``_FLEET_TCFG``):
  - the port's 2-replica ``ServingFleet`` gives JAX ``ServingFleet``'s
    per-request streams, router assignments and summary counts (a
    deploy decision may differ only as a near-tie: JAX's margin eval -
    baseline within 1e-6); both replicas serve one params object;
    ``reset_adaptation`` reproduces the run;
  - ``TideSystem(fleet=FleetConfig(trainer_endpoint="spawn"))`` in sync
    mode (a CPU trainer process) gives the port's in-process sync run
    exactly: streams, cycles, events, deploy rounds, gate version, with
    selective training off (JAX's configuration) and on (the card's);
    the in-process run gives JAX's (near-tie rule only);
  - ``kill_trainer`` degrades: the next stream completes on the last
    deployed draft, ``drain()`` returns 0 at once, failures show.
* The kernel build's file lock: a second build waits for the first.
"""
import dataclasses
import socket
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import repro.configs as C  # noqa: E402
from repro.checkpoint import ckpt as jckpt  # noqa: E402
from repro.core import eagle as jeagle  # noqa: E402
from repro.core import tide as jtide  # noqa: E402
from repro.data import workloads as jwork  # noqa: E402
from repro.fleet import FleetConfig as JaxFleetConfig  # noqa: E402
from repro.fleet.router import ServingFleet as JaxServingFleet  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serving.request import Request as JaxRequest  # noqa: E402
from repro.training.trainer import pretrain_target  # noqa: E402
from repro_torch.checkpoint import bridge  # noqa: E402
from repro_torch.configs import get  # noqa: E402
from repro_torch.core import eagle, tide  # noqa: E402
from repro_torch.core.signals import SignalBatch  # noqa: E402
from repro_torch.fleet import FleetConfig, wire  # noqa: E402
from repro_torch.fleet.bus import DraftVersionBus  # noqa: E402
from repro_torch.fleet.remote import (RemoteDeploySource,  # noqa: E402
                                      RemoteSignalChannel,
                                      RemoteTrainingService, _GateView)
from repro_torch.fleet.router import (FleetRouter, ServingFleet,  # noqa: E402
                                      request_cost)
from repro_torch.fleet.trainer_main import TrainerHost  # noqa: E402
from repro_torch.kernels import build as kbuild  # noqa: E402
from repro_torch.serving.request import Request  # noqa: E402
from repro_torch.training.service import DraftVersion  # noqa: E402

WAIT_S = 10.0        # bound of every join and protocol read
ACC_TOL = 1e-6


def _batch(i, s=8, f=6):
    return SignalBatch(feats=np.full((s, f), i, np.float32),
                       tokens=np.full((s,), i, np.int32))


# ===================================================== config + router
def test_fleet_config_validation():
    assert not FleetConfig().enabled
    assert FleetConfig(replicas=2).enabled
    assert FleetConfig(trainer_endpoint="spawn").enabled
    with pytest.raises(ValueError):
        FleetConfig(replicas=-1)
    with pytest.raises(ValueError):
        FleetConfig(route="random")
    assert [f.name for f in dataclasses.fields(FleetConfig)] == \
        [f.name for f in dataclasses.fields(JaxFleetConfig)]
    assert dataclasses.asdict(FleetConfig()) == \
        dataclasses.asdict(JaxFleetConfig())


def test_router_least_loaded_balances():
    r = FleetRouter(2, "least")
    big = Request(prompt=[1] * 8, max_new_tokens=100)
    small = Request(prompt=[1] * 8, max_new_tokens=10)
    assert r.assign(big) == 0           # tie -> lowest index
    assert r.assign(small) == 1
    assert r.assign(small) == 1         # 11 + 11 < 101
    assert r.assign(small) == 1
    assert r.load[0] == pytest.approx(request_cost(big))
    assert r.assigned == [1, 3]


def test_router_round_robin_and_split_order():
    r = FleetRouter(3, "rr")
    reqs = [Request(prompt=[1], max_new_tokens=i + 1) for i in range(7)]
    shards = r.split(reqs)
    assert [len(s) for s in shards] == [3, 2, 2]
    assert [q.max_new_tokens for q in shards[0]] == [1, 4, 7]
    assert [q.max_new_tokens for q in shards[1]] == [2, 5]


def test_router_validation():
    with pytest.raises(ValueError, match="replica"):
        FleetRouter(0)
    with pytest.raises(ValueError, match="policy"):
        FleetRouter(2, "hash")


# ============================================================== the bus
def test_bus_newest_wins_fanout_and_idempotent_subscribe():
    bus = DraftVersionBus()
    a, b = bus.subscribe("r0"), bus.subscribe("r1")
    assert bus.subscribe("r0") is a
    assert a() is None
    bus.publish(DraftVersion(2, {"w": 2}, 0.5))
    bus.publish(DraftVersion(1, {"w": 1}, 0.4))   # stale: ignored
    assert bus.published == 1
    assert a().seq == 2 and b().seq == 2
    assert a().seq == 2
    assert a.deliveries == 1 and a.delivered_seq == 2
    bus.publish(DraftVersion(3, {"w": 3}, 0.6))
    assert b().seq == 3 and b.deliveries == 2
    st = bus.stats()
    assert st["latest_seq"] == 3 and st["published"] == 2
    assert st["subscribers"]["r0"]["delivered_seq"] == 2


def test_bus_pulls_from_upstream_source():
    slot = RemoteDeploySource()
    bus = DraftVersionBus(source=slot.poll)
    sub = bus.subscribe("r0")
    assert sub() is None
    slot.publish(DraftVersion(1, {"w": 1}, 0.5))
    assert sub().seq == 1 and bus.published == 1
    slot.publish(DraftVersion(5, {"w": 5}, 0.9))
    slot.publish(DraftVersion(4, {"w": 4}, 0.8))
    assert sub().seq == 5


def test_remote_deploy_source_and_gate_view():
    slot = RemoteDeploySource()
    slot.publish(DraftVersion(3, {"w": 3}, 0.5))
    assert slot() is slot.poll() and slot().seq == 3
    slot.reset()
    assert slot.poll() is None
    gate = _GateView()
    gate.observe(2)
    gate.observe(1)
    assert gate.version == 2
    gate.reset()
    assert gate.version == 0


def test_remote_signal_channel_keeps_host_arrays():
    ch = RemoteSignalChannel(capacity=2)
    for i in range(3):
        ch.add(_batch(i))
    assert ch.dropped == 1 and ch.peek_count() == 2
    kept = ch.drain()
    assert isinstance(kept[0].feats, np.ndarray)
    assert [int(b.tokens[0]) for b in kept] == [1, 2]


# ============================ TrainerHost protocol (socketpair, stub)
class _StubChannel:
    def __init__(self):
        self.batches = []

    def add(self, b):
        self.batches.append(b)

    def reset(self):
        self.batches.clear()


class _StubGate:
    def __init__(self):
        self.version = 0
        self.reset_to = None

    def reset(self, dp=None):
        self.reset_to = dp


class _StubService:
    """Stand-in for TrainingService inside TrainerHost: drain publishes
    one draft and one event back through the host, so the
    DRAFT/EVENT-before-DRAIN_ACK order is observable."""

    def __init__(self, hello, embed, dparams0, host):
        self.hello, self.embed, self.dparams0 = hello, embed, dparams0
        self.host = host
        self.channel = _StubChannel()
        self.gate = _StubGate()
        self.failures = 0
        self._train_lock = threading.RLock()
        self.drains = self.resets = self.closed = 0
        self.started = False

    def drain(self):
        self.drains += 1
        self.gate.version += 1
        self.host.send_draft(DraftVersion(
            self.gate.version,
            {"fc": {"w": torch.full((3,), float(self.gate.version))}},
            0.75))
        self.host.send_event({"kind": "train_cycle", "eval_acc": 0.75,
                              "train_acc": 0.7,
                              "baseline": self.host.baseline,
                              "deployed": True, "steps": 3,
                              "seconds": 0.01, "dropme": object()})
        return 1

    def reset(self):
        self.resets += 1

    def start(self):
        self.started = True

    def close(self):
        self.closed += 1


def _handshake_frames(async_train=False):
    cfg = get("tide-tiny")
    hello = {"tcfg": wire.config_to_dict(cfg),
             "dcfg": wire.config_to_dict(eagle.draft_config(cfg)),
             "train": {"n_threshold": 8, "signal_window": 8,
                       "train_epochs": 1, "train_min_steps": 2,
                       "seed": 0},
             "async": async_train}
    init = {"e/w": np.zeros((4, 2), np.float32),
            "p/fc/w": np.ones(3, np.float32)}
    return (wire.encode_frame(wire.FT_HELLO, wire.json_payload(hello))
            + wire.encode_frame(wire.FT_INIT, wire.npz_payload(init)))


def _run_host(conn, holder):
    host = TrainerHost(conn, service_factory=_StubService, device="cpu")
    holder["host"] = host
    try:
        host.run()
    except Exception as exc:            # surfaced by the test
        holder["err"] = exc
    finally:
        conn.close()


def _recv_n(sock, reader, n, timeout=WAIT_S):
    sock.settimeout(timeout)
    out = []
    while len(out) < n:
        data = sock.recv(1 << 16)
        assert data, "peer closed early"
        out.extend(reader.feed(data))
    return out


def _host_pair():
    client, server = socket.socketpair()
    holder = {}
    t = threading.Thread(target=_run_host, args=(server, holder),
                         daemon=True)
    t.start()
    return client, holder, t


def test_trainer_host_protocol_roundtrip():
    """Handshake ack, SIGNALS with the baseline riding along, DRAFT +
    EVENT strictly before the DRAIN_ACK, RESET round trip, BYE (which
    closes the service)."""
    client, holder, t = _host_pair()
    reader = wire.FrameReader()
    client.sendall(_handshake_frames())
    (ftype, _f, payload), = _recv_n(client, reader, 1)
    ack = wire.decode_json(payload)
    assert ftype == wire.FT_HELLO and ack["ok"]
    assert ack["wire_rss_mb"] > 0 and ack["wire_init_decode_s"] >= 0
    stub = holder["host"].service
    assert stub.hello["train"]["n_threshold"] == 8
    assert tuple(stub.embed["w"].shape) == (4, 2)
    assert torch.equal(stub.dparams0["fc"]["w"], torch.ones(3))
    assert not stub.started                     # sync handshake

    client.sendall(wire.encode_frame(
        wire.FT_SIGNALS,
        wire.signals_payload([_batch(3)], baseline=0.375)))
    client.sendall(wire.encode_frame(
        wire.FT_DRAIN, wire.json_payload({"token": 7})))
    frames = _recv_n(client, reader, 3)
    assert [f[0] for f in frames] == \
        [wire.FT_DRAFT, wire.FT_EVENT, wire.FT_DRAIN_ACK]
    seq, dparams, acc = wire.decode_draft(frames[0][2])
    assert seq == 1 and acc == 0.75
    np.testing.assert_array_equal(dparams["fc"]["w"],
                                  np.full(3, 1, np.float32))
    event = wire.decode_json(frames[1][2])
    assert event["kind"] == "train_cycle"
    assert event["baseline"] == 0.375           # shipped with SIGNALS
    assert "dropme" not in event                # non-scalars filtered
    assert event["wire_draft_bytes"] == \
        wire.HEADER.size + len(frames[0][2])
    assert event["wire_rss_mb"] > 0
    ack = wire.decode_json(frames[2][2])
    assert ack == {"token": 7, "cycles": 1, "version": 1, "failures": 0}
    assert len(stub.channel.batches) == 1
    np.testing.assert_array_equal(stub.channel.batches[0].feats,
                                  _batch(3).feats)

    client.sendall(wire.encode_frame(
        wire.FT_RESET, wire.json_payload({"token": 8})))
    (ftype, _f, payload), = _recv_n(client, reader, 1)
    assert ftype == wire.FT_RESET_ACK
    assert wire.decode_json(payload)["token"] == 8
    assert stub.resets == 1 and stub.channel.batches == []
    assert stub.gate.reset_to is holder["host"].dparams0
    assert holder["host"].baseline == 0.0

    client.sendall(wire.encode_frame(wire.FT_BYE))
    t.join(timeout=WAIT_S)
    assert not t.is_alive() and "err" not in holder
    assert stub.closed == 1
    client.close()


def test_trainer_host_async_handshake_starts_service():
    """The ack means ready: the service runs by the time the client
    reads it (nothing else is waited on)."""
    client, holder, t = _host_pair()
    reader = wire.FrameReader()
    client.sendall(_handshake_frames(async_train=True))
    (ftype, _f, _p), = _recv_n(client, reader, 1)
    assert ftype == wire.FT_HELLO
    assert holder["host"].service.started
    client.sendall(wire.encode_frame(wire.FT_BYE))
    t.join(timeout=WAIT_S)
    assert not t.is_alive()
    client.close()


def test_trainer_host_rejects_out_of_order_handshake():
    client, holder, t = _host_pair()
    client.sendall(wire.encode_frame(
        wire.FT_SIGNALS, wire.signals_payload([_batch(0)])))
    t.join(timeout=WAIT_S)
    assert not t.is_alive()
    assert isinstance(holder.get("err"), wire.WireError)
    assert "expected HELLO" in str(holder["err"])
    client.close()


def test_trainer_host_eof_before_handshake():
    client, holder, t = _host_pair()
    client.close()
    t.join(timeout=WAIT_S)
    assert not t.is_alive()
    assert isinstance(holder.get("err"), wire.WireError)
    assert "closed before HELLO" in str(holder["err"])


def test_trainer_host_rejects_unexpected_frame():
    client, holder, t = _host_pair()
    reader = wire.FrameReader()
    client.sendall(_handshake_frames())
    _recv_n(client, reader, 1)
    client.sendall(wire.encode_frame(wire.FT_DRAFT, wire.draft_payload(
        1, {"w": np.zeros(2, np.float32)}, 0.5)))
    t.join(timeout=WAIT_S)
    assert not t.is_alive()
    assert "unexpected frame DRAFT" in str(holder.get("err"))
    assert holder["host"].service.closed == 1
    client.close()


# ================== RemoteTrainingService against a trainer host thread
def _tiny_handshake_args():
    cfg = get("tide-tiny")
    return dict(tcfg=cfg, dcfg=eagle.draft_config(cfg),
                embed_params={"w": torch.zeros((4, 2))},
                dparams0={"fc": {"w": torch.ones(3)}},
                n_threshold=8, signal_window=8, connect_timeout=30.0,
                drain_timeout=30.0, device="cpu")


def _host_thread(endpoint, holder):
    srv = wire.listen(endpoint)
    holder["srv"] = srv

    def serve():
        conn, _ = srv.accept()
        _run_host(conn, holder)

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    return t


def test_remote_service_drain_draft_pickup_and_close(tmp_path):
    """drain() flushes signals and the barrier; when it returns, the DRAFT
    published during the barrier is in the deploy slot as tensors on the
    service's device, and the event and cycle mirrors are updated (the
    trainer's ``wire_`` figures filed apart).  close() is idempotent and
    tears the host down with BYE."""
    ep = f"unix:{tmp_path}/t.sock"
    holder = {}
    t = _host_thread(ep, holder)
    svc = RemoteTrainingService(ep, engine_steps_fn=lambda: 42,
                                **_tiny_handshake_args())
    try:
        assert svc.running and svc.poll() is None
        assert svc.wire_log["init"]["bytes"] > 0
        assert svc.wire_log["spawn_to_ready_s"] > 0
        svc.channel.add(_batch(5))
        assert svc.drain() == 1
        ver = svc.poll()
        assert ver is not None and ver.seq == 1 and ver.eval_acc == 0.75
        w = ver.dparams["fc"]["w"]
        assert isinstance(w, torch.Tensor) and w.device.type == "cpu"
        assert torch.equal(w, torch.full((3,), 1.0))
        assert svc.gate.version == 1 and svc.deploys == 1
        assert svc.cycles == 1
        ev = svc.events[0]
        assert ev["kind"] == "train_cycle" and ev["engine_steps"] == 42
        assert not any(k.startswith("wire_") for k in ev)
        assert svc.wire_log["trainer"][0]["wire_draft_bytes"] == \
            svc.wire_log["drafts"][0]["bytes"]
        stub = holder["host"].service
        assert len(stub.channel.batches) == 1
        assert svc.drain() == 1                  # empty flush still cycles
        st = svc.stats()
        assert st["thread_cap"] == "process" and st["trainer_threads"] == 0
        assert st["frames_sent"] >= 4 and st["frames_recv"] >= 4
        assert st["failures"] == 0

        svc.reset()
        assert svc.poll() is None and svc.cycles == 0
        assert svc.gate.version == 0
        assert holder["host"].service.resets == 1
    finally:
        svc.close()
        svc.close()                              # idempotent
        t.join(timeout=WAIT_S)
        holder["srv"].close()
    assert holder["host"].service.closed == 1
    assert not svc.running


def test_remote_service_trainer_death_degrades_not_hangs(tmp_path):
    ep = f"unix:{tmp_path}/t.sock"
    holder = {}
    t = _host_thread(ep, holder)
    svc = RemoteTrainingService(ep, **_tiny_handshake_args())
    try:
        holder["host"].conn.shutdown(socket.SHUT_RDWR)   # trainer "dies"
        deadline = time.monotonic() + WAIT_S
        while svc.running and time.monotonic() < deadline:
            time.sleep(0.02)
        assert not svc.running
        assert svc.failures >= 1 and svc.last_error is not None
        svc.channel.add(_batch(0))
        t0 = time.monotonic()
        assert svc.drain() == 0
        assert time.monotonic() - t0 < 5.0, "dead drain must not hang"
        svc.reset()                                      # local-only clear
        assert svc.poll() is None
    finally:
        svc.close()
        t.join(timeout=WAIT_S)
        holder["srv"].close()


def test_remote_service_connect_failure_is_clean(tmp_path):
    with pytest.raises(RuntimeError, match="could not reach"):
        RemoteTrainingService(f"unix:{tmp_path}/nobody.sock",
                              **{**_tiny_handshake_args(),
                                 "connect_timeout": 0.3})


def test_build_lock_serializes_builds(monkeypatch, tmp_path):
    """A second build (in another process, or here through another open
    of the lock file) waits on the build directory's file lock, then
    finds the first one's library."""
    import fcntl
    monkeypatch.setattr(kbuild, "BUILD_DIR", tmp_path)
    calls = []
    monkeypatch.setattr(kbuild, "_build",
                        lambda: calls.append(time.monotonic()) or tmp_path)
    with open(tmp_path / ".build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        t = threading.Thread(target=kbuild.build, daemon=True)
        t.start()
        time.sleep(0.3)
        assert calls == [], "built while another build held the lock"
        released = time.monotonic()
        fcntl.flock(lock, fcntl.LOCK_UN)
    t.join(timeout=WAIT_S)
    assert len(calls) == 1 and calls[0] >= released


# ======================================================= pretrained e2e
_FLEET_TCFG = dict(gamma=3, batch_size=2, max_len=96, adaptive_spec=False,
                   selective_training=False, signal_window=8, n_threshold=4,
                   train_epochs=1, train_min_steps=6, seed=0)
_BUDGETS = (24, 16, 24, 12, 20, 24, 16, 24)


@pytest.fixture(scope="module")
def tiny():
    """tide_tiny pretrained in JAX (40 steps), JAX's initial draft, both
    bridged to the port, and the science domain."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    jcfg = C.get("tide-tiny")
    jdcfg = jeagle.draft_config(jcfg)
    jp = jax.jit(JT.init, static_argnums=0)(jcfg, jax.random.key(0))
    domains = jwork.make_domains(jcfg.vocab_size, ["science"],
                                 branchings=[2], seed=3)
    corpus = jwork.training_corpus(domains["science"], 64, 40, 1)
    jp, _ = pretrain_target(jcfg, jp, corpus, steps=40, lr=3e-3)
    jdp = jax.jit(jeagle.draft_init, static_argnums=0)(jdcfg,
                                                       jax.random.key(7))
    cfg = get("tide-tiny")
    dcfg = eagle.draft_config(cfg)
    tp = bridge.target_from_numpy(cfg, jckpt._flatten(jp), device="cpu")
    tdp = bridge.draft_from_numpy(dcfg, jckpt._flatten(jdp), device="cpu")
    yield dict(jcfg=jcfg, jp=jp, jdp=jdp, cfg=cfg, dcfg=dcfg, tp=tp,
               tdp=tdp, domains=domains)
    torch.set_num_threads(threads)


def _prompts(t, n, seed):
    rng = np.random.default_rng(seed)
    return [list(map(int, t["domains"]["science"].sample_prompt(rng)))
            for _ in range(n)]


def _reqs(cls, t, budgets, seed):
    return [cls(prompt=p, max_new_tokens=m, domain="science")
            for p, m in zip(_prompts(t, len(budgets), seed), budgets)]


def _decisions_match(jev, pev):
    """Equal deploy decisions, or a JAX near-tie where they differ."""
    assert len(pev) == len(jev), (len(pev), len(jev))
    for i, (a, b) in enumerate(zip(jev, pev)):
        margin = a["eval_acc"] - a["baseline"]
        assert b["deployed"] == a["deployed"] or abs(margin) <= ACC_TOL, (
            f"cycle {i}: deployed JAX {a['deployed']}, port "
            f"{b['deployed']}; JAX margin eval - baseline {margin}")
        assert b["steps"] == a["steps"], (i, a, b)
        for k in ("eval_acc", "train_acc", "baseline"):
            assert b[k] == pytest.approx(a[k], abs=ACC_TOL), (i, k)


@pytest.fixture(scope="module")
def fleets(tiny):
    """JAX's and the port's 2-replica fleets after one serve of the same
    trace, and the port's after ``reset_adaptation`` and a second."""
    t = tiny
    jf = JaxServingFleet(t["jcfg"], t["jp"], jtide.TideConfig(
        **_FLEET_TCFG, fleet=JaxFleetConfig(replicas=2)), dparams=t["jdp"])
    jreqs = _reqs(JaxRequest, t, _BUDGETS, 11)
    jf.serve(jreqs)
    jf.close()
    pf = ServingFleet(t["cfg"], t["tp"], tide.TideConfig(
        **_FLEET_TCFG, fleet=FleetConfig(replicas=2)), dparams=t["tdp"],
        device="cpu")
    preqs = _reqs(Request, t, _BUDGETS, 11)
    done = pf.serve(preqs)
    first = dict(summary=pf.summary(), events=list(pf.events),
                 streams=[list(r.generated) for r in preqs])
    pf.reset_adaptation()
    again = _reqs(Request, t, _BUDGETS, 11)
    pf.serve(again)
    pf.close()
    return dict(jax=jf, port=pf, jreqs=jreqs, preqs=preqs, done=done,
                first=first, again=again)


def test_fleet_streams_match_jax(fleets):
    """Each request's stream equals JAX's, and both replicas serve one
    params object (no second target)."""
    f = fleets
    assert len(f["done"]) == len(_BUDGETS)
    assert f["first"]["streams"] == [list(r.generated) for r in f["jreqs"]]
    assert all(len(s) == m for s, m in zip(f["first"]["streams"], _BUDGETS))
    e0, e1 = f["port"].engines
    assert e1.params is e0.params and e1._base_key is e0._base_key


def test_fleet_summary_matches_jax(fleets):
    """Router assignments and loads, the summary's counts, the bus and the
    train cycles equal JAX's (deploys: near-tie rule only)."""
    f = fleets
    a, b = f["jax"].summary(), f["first"]["summary"]
    assert set(b) == set(a)
    _decisions_match(f["jax"].events, f["first"]["events"])
    for k in ("replicas", "tokens", "replica_tokens", "replica_rounds",
              "max_rounds", "deploys", "router_assigned", "router_load",
              "train_cycles", "deployed", "trainer_failures",
              "signals_collected", "signals_dropped", "bus"):
        assert b[k] == a[k], (k, a[k], b[k])
    assert all(n > 0 for n in b["router_assigned"])
    assert b["train_cycles"] >= 1 and b["deployed"] >= 1
    assert b["bus"]["published"] >= 1 and b["trainer_failures"] == 0


def test_fleet_reset_adaptation_reproduces_run(fleets):
    f = fleets
    assert [list(r.generated) for r in f["again"]] == f["first"]["streams"]
    s = f["port"].summary()
    for k in ("router_assigned", "tokens", "train_cycles", "deployed",
              "deploys", "bus"):
        assert s[k] == f["first"]["summary"][k], k


def _strip(events):
    return [{k: v for k, v in e.items() if k != "seconds"} for e in events]


@pytest.mark.parametrize("selective", [False, True],
                         ids=["jax_config", "selective"])
def test_remote_spawn_sync_equals_in_process(tiny, selective):
    """A spawned CPU trainer in sync mode gives the in-process run
    exactly: streams, cycles and their events (timing aside), deploy
    rounds, gate version; and the in-process run gives JAX's (near-tie
    rule only)."""
    t = tiny
    kw = dict(_FLEET_TCFG, selective_training=selective)
    budgets = (24, 16, 24, 20, 24, 24, 16, 24)
    ref = tide.TideSystem(t["cfg"], t["tp"], tide.TideConfig(**kw),
                          dparams=t["tdp"], device="cpu")
    ref_reqs = _reqs(Request, t, budgets, 5)
    ref.run_stream(iter(ref_reqs))
    assert ref.service.cycles >= 2 and ref.gate.version >= 1, \
        "scenario never trained and deployed"
    rem = tide.TideSystem(t["cfg"], t["tp"], tide.TideConfig(
        **kw, fleet=FleetConfig(trainer_endpoint="spawn")),
        dparams=t["tdp"], device="cpu")
    try:
        assert isinstance(rem.service, RemoteTrainingService)
        assert rem.trainer is None
        got = _reqs(Request, t, budgets, 5)
        rem.run_stream(iter(got))
        assert [r.generated for r in got] == [r.generated for r in ref_reqs]
        assert rem.service.cycles == ref.service.cycles
        assert rem.gate.version == ref.gate.version
        assert _strip(rem.events) == _strip(ref.events)
        assert rem.engine.stats.deploys == ref.engine.stats.deploys
        assert rem.summary()["trainer_failures"] == 0
        assert rem.service.stats()["thread_cap"] == "process"
        assert [d["seq"] for d in rem.service.wire_log["drafts"]] == \
            list(range(1, rem.gate.version + 1))
        served = bridge.flat(rem.engine.dparams)
        want = bridge.flat(ref.engine.dparams)
        assert all(torch.equal(served[k], want[k]) for k in want)
    finally:
        rem.close()
        ref.close()
    js = jtide.TideSystem(t["jcfg"], t["jp"], jtide.TideConfig(**kw),
                          dparams=t["jdp"])
    jreqs = _reqs(JaxRequest, t, budgets, 5)
    js.run_stream(iter(jreqs))
    assert [r.generated for r in ref_reqs] == \
        [list(r.generated) for r in jreqs]
    _decisions_match(js.events, ref.events)
    assert [e["engine_steps"] for e in ref.events] == \
        [e["engine_steps"] for e in js.events]


def test_remote_spawn_trainer_kill_degrades(tiny):
    """Kill the trainer process mid-workload: the next stream completes on
    the last deployed draft, drain() returns 0 at once, and summary()
    shows the failure (JAX's test, on the port)."""
    t = tiny
    sys_ = tide.TideSystem(t["cfg"], t["tp"], tide.TideConfig(
        **_FLEET_TCFG, fleet=FleetConfig(trainer_endpoint="spawn")),
        dparams=t["tdp"], device="cpu")
    try:
        first = _reqs(Request, t, (24, 16), 9)
        sys_.run_stream(iter(first))
        served = sys_.engine.dparams
        sys_.service.kill_trainer()
        deadline = time.monotonic() + 30.0
        while sys_.service.running and time.monotonic() < deadline:
            time.sleep(0.05)
        assert not sys_.service.running
        second = _reqs(Request, t, (20, 24, 12), 10)
        t0 = time.monotonic()
        done = sys_.run_stream(iter(second))
        assert len(done) == 3
        assert [len(r.generated) for r in second] == [20, 24, 12]
        assert time.monotonic() - t0 < 120.0
        assert sys_.engine.dparams is served
        assert sys_.service.drain() == 0
        assert sys_.summary()["trainer_failures"] >= 1
    finally:
        sys_.close()
        sys_.close()                             # idempotent
    assert sys_.service._proc.poll() is not None
