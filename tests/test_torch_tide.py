"""The port's synchronous adaptation loop against the JAX package on the CPU
(tide_tiny, fp32, fixed seeds; JAX is the oracle).

* The loop: JAX's and the port's ``TideSystem`` in sync mode, on a
  tide_tiny target pretrained in JAX (40 steps, as
  tests/test_torch_training.py) and JAX's initial draft, both bridged to
  the port, run with tests/test_service.py's ``_TCFG`` through ``run``
  (waves; train after each) and ``run_stream`` (requests; train at
  request-completion boundaries).  Exact: token streams, the count of
  train-cycle events, each cycle's ``deployed``, ``steps`` and
  ``engine_steps`` (the engine's round count, ``stats.steps``, when the
  cycle ran; a deployed draft serves from the next dispatch on),
  ``gate.version``, the deploy log's
  decisions, ``stats.deploys`` and ``summary()``'s integer keys.  Within
  1e-6 absolute: ``eval_acc``, ``train_acc``, ``baseline``.  A deploy
  decision that differs passes only as a near-tie: JAX's margin
  ``eval - baseline`` within 1e-6 (the message prints it).  A different
  ``engine_steps`` fails; the message names the first round whose
  accepted length differs, where a draft near-tie would have to be
  shown.
* Port-internal: ``TideSystem.reset_adaptation`` reproduces a run
  exactly, and ``ServingEngine.reset_adaptation`` restores a paged
  engine.
* The parts, one op sequence on both packages: ``SignalChannel`` (the
  four channel tests of tests/test_service.py), the starving-channel
  ``ValueError``, ``DraftDeployGate`` offers and log, ``drain`` surviving
  a trainer that raises, ``ckpt.save``/``load`` both ways between the
  packages, and ``data/workloads.py`` against JAX's for a few seeds.
* Refusals: every unported configuration raises ``NotImplementedError``
  naming its ROADMAP queue 1 item (the ones since ported serve, the
  fleet's through a spawned trainer process); ``TideSystem`` without
  ``device`` needs a card.  (Async mode, the service thread and the channel's
  device are held in tests/test_torch_async.py.)
* The config mirror: the port's ``ServingConfig`` and ``TideConfig``
  field names and defaults equal JAX's, and the flat fields mirror into
  ``serving`` as JAX's do."""
import dataclasses
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
from repro.core import transport as jtransport  # noqa: E402
from repro.core.signals import SignalBatch as JaxSignalBatch  # noqa: E402
from repro.data import workloads as jwork  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.obs import ObsConfig as JaxObsConfig  # noqa: E402
from repro.serving import policy as jpolicy  # noqa: E402
from repro.serving.request import Request as JaxRequest  # noqa: E402
from repro.training import service as jservice  # noqa: E402
from repro.training.draft_trainer import DraftTrainer as JaxTrainer  # noqa: E402
from repro.training.trainer import pretrain_target  # noqa: E402
from repro_torch.checkpoint import bridge, ckpt  # noqa: E402
from repro_torch.configs import get  # noqa: E402
from repro_torch.core import eagle, tide, transport  # noqa: E402
from repro_torch.core.signals import SignalBatch  # noqa: E402
from repro_torch.data import workloads  # noqa: E402
from repro_torch.fleet import FleetConfig  # noqa: E402
from repro_torch.obs import ObsConfig  # noqa: E402
from repro_torch.serving import policy  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from repro_torch.serving.request import Request  # noqa: E402
from repro_torch.training import optimizer as topt  # noqa: E402
from repro_torch.training import service  # noqa: E402
from repro_torch.training.draft_trainer import DraftTrainer  # noqa: E402

# tests/test_service.py's sync-mode configuration
_TCFG = dict(gamma=3, batch_size=2, max_len=96, adaptive_spec=False,
             selective_training=True, signal_window=8, n_threshold=4,
             train_epochs=1, train_min_steps=6, seed=0)
ACC_TOL = 1e-6          # eval/train accuracy and baseline, absolute
MAX_NEW = 24


@pytest.fixture(scope="module")
def tiny():
    """tide_tiny pretrained in JAX (40 steps), JAX's initial draft, both
    bridged to the port, and four waves of two science prompts."""
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
    rng = np.random.default_rng(1)
    waves = [[("science", domains["science"].sample_prompt(rng))
              for _ in range(2)] for _ in range(4)]
    yield dict(jcfg=jcfg, jdcfg=jdcfg, jp=jp, jdp=jdp, cfg=cfg, dcfg=dcfg,
               tp=tp, tdp=tdp, waves=waves)
    torch.set_num_threads(threads)


def _port_system(t, **kw):
    return tide.TideSystem(t["cfg"], t["tp"],
                           tide.TideConfig(**{**_TCFG, **kw}),
                           dparams=t["tdp"], device="cpu")


# the stream runs trace (the tracer is host-side only: the streams and
# events must not change)
TRACED = "run_stream"


def _serve(system, t, mode, request_cls):
    if mode == "run":
        return system.run(iter(t["waves"]), max_new_tokens=MAX_NEW)
    return system.run_stream(iter([
        request_cls(prompt=list(p), domain=d, max_new_tokens=MAX_NEW)
        for wave in t["waves"] for d, p in wave]))


@pytest.fixture(scope="module")
def loops(tiny):
    """Each package's sync-mode TideSystem after ``run`` and after
    ``run_stream`` (a fresh system each), with its completed requests."""
    out = {}
    for mode in ("run", "run_stream"):
        traced = mode == TRACED
        js = jtide.TideSystem(
            tiny["jcfg"], tiny["jp"], jtide.TideConfig(
                **_TCFG, obs=JaxObsConfig(trace=True) if traced else None),
            dparams=tiny["jdp"])
        jdone = _serve(js, tiny, mode, JaxRequest)
        ps = _port_system(tiny, obs=ObsConfig(trace=True) if traced else None)
        pdone = _serve(ps, tiny, mode, Request)
        out[mode] = dict(jax=js, port=ps, jdone=jdone, pdone=pdone)
    return out


MODES = ["run", "run_stream"]


def _first_round_apart(js, ps) -> str:
    a = [r["accept_len"] for r in js.engine.stats.timeline]
    b = [r["accept_len"] for r in ps.engine.stats.timeline]
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return f"round {i}: accepted length JAX {x}, port {y}"
    return f"rounds JAX {len(a)}, port {len(b)}, accepted lengths equal"


# ============================================================ the loop
@pytest.mark.parametrize("mode", MODES)
def test_sync_loop_streams_match_jax(loops, mode):
    """Equal greedy streams, in completion order, with the draft
    hot-swapped mid-run."""
    lp = loops[mode]
    assert [r.generated for r in lp["pdone"]] == \
        [r.generated for r in lp["jdone"]]
    assert all(len(r.generated) == MAX_NEW for r in lp["pdone"])


@pytest.mark.parametrize("mode", MODES)
def test_sync_loop_cycles_match_jax(loops, mode):
    """The same train cycles: count, steps, the engine round each ran at
    and its deploy decision exactly, accuracies and baseline within
    1e-6.  The scenario trains and deploys at least once."""
    js, ps = loops[mode]["jax"], loops[mode]["port"]
    je, pe = js.events, ps.events
    assert len(pe) == len(je) >= 2, (len(pe), len(je))
    assert any(e["deployed"] for e in je), "the scenario never deployed"
    for i, (a, b) in enumerate(zip(je, pe)):
        assert b["kind"] == a["kind"] == "train_cycle"
        assert b["steps"] == a["steps"], (i, a, b)
        assert b["engine_steps"] == a["engine_steps"], (
            f"cycle {i}: engine_steps JAX {a['engine_steps']}, port "
            f"{b['engine_steps']}; {_first_round_apart(js, ps)}")
        for k in ("eval_acc", "train_acc", "baseline"):
            assert b[k] == pytest.approx(a[k], abs=ACC_TOL), (i, k, a, b)
        margin = a["eval_acc"] - a["baseline"]
        assert b["deployed"] == a["deployed"] or abs(margin) <= ACC_TOL, (
            f"cycle {i}: deployed JAX {a['deployed']}, port "
            f"{b['deployed']}; JAX margin eval - baseline {margin}")


@pytest.mark.parametrize("mode", MODES)
def test_sync_loop_gate_and_deploys_match_jax(loops, mode):
    """Gate version, deploy log decisions, the engine's deploy count and
    the version it serves."""
    js, ps = loops[mode]["jax"], loops[mode]["port"]
    assert ps.gate.version == js.gate.version >= 1
    assert [(d["deployed"], d["version"]) for d in ps.gate.deploy_log] == \
        [(d["deployed"], d["version"]) for d in js.gate.deploy_log]
    assert ps.engine.stats.deploys == js.engine.stats.deploys
    assert ps.engine._deploy_seq == js.engine._deploy_seq == ps.gate.version
    served, version = ps.gate.current()
    assert ps.engine.dparams is served and version == ps.gate.version


@pytest.mark.parametrize("mode", MODES)
def test_sync_loop_summary_matches_jax(loops, mode):
    """``summary()`` has JAX's keys; its integer keys are equal, its
    accepted length and occupancy too (sums of equal per-round values)."""
    js, ps = loops[mode]["jax"], loops[mode]["port"]
    a, b = js.summary(), ps.summary()
    assert set(b) == set(a)
    ints = [k for k, v in a.items() if isinstance(v, (int, np.integer))
            and not isinstance(v, bool)]
    assert "train_cycles" in ints and "signals_collected" in ints
    assert {k: b[k] for k in ints} == {k: int(a[k]) for k in ints}
    for k in ("accept_len", "occupancy"):
        assert b[k] == pytest.approx(a[k], abs=1e-12), k
    assert b["train_cycles"] >= 2 and b["deployed"] >= 1
    train = {k: v for k, v in js.snapshot().items() if k.startswith("train.")}
    assert {k: v for k, v in ps.snapshot().items()
            if k.startswith("train.")} == train
    assert train["train.cycles"] == b["train_cycles"]


def test_sync_loop_trace_matches_jax(loops):
    """With the tracer on, the port records JAX's ``train.cycle`` spans
    (with their batch counts), ``train.publish`` and ``deploy`` instants
    in the same order."""
    names = ("train.cycle", "train.publish", "deploy")

    def seq(system):
        return [(e["name"], e["ph"], e.get("args", {}).get("batches"))
                for e in system.export_trace()["traceEvents"]
                if e["name"] in names]

    lp = loops[TRACED]
    want = seq(lp["jax"])
    assert seq(lp["port"]) == want
    assert [n for n, _, _ in want].count("train.cycle") == \
        len(lp["port"].events)
    assert ("deploy", "i", None) in want


def test_sync_stream_deploys_mid_stream(loops):
    """In ``run_stream`` the first deploy lands while requests are still
    being served: at a completion boundary before the last round, after
    which the engine serves the gate's draft."""
    ps = loops["run_stream"]["port"]
    first = next(e for e in ps.events if e["deployed"])
    assert 0 < first["engine_steps"] < ps.engine.stats.steps
    assert ps.summary()["deploys"] >= 1


# ======================================================= reset (port)
def _strip(events):
    return [{k: v for k, v in e.items() if k != "seconds"} for e in events]


def test_reset_adaptation_reproduces_run(tiny):
    """reset_adaptation restores the post-construction adaptive state
    exactly: a re-run emits identical events, streams and summary
    counts (as tests/test_service.py holds JAX's)."""
    sys_ = _port_system(tiny)
    a = sys_.run(iter(tiny["waves"][:3]), max_new_tokens=MAX_NEW)
    ev_a, sum_a = _strip(sys_.events), sys_.summary()
    assert len(ev_a) >= 1
    sys_.reset_adaptation()
    assert sys_.gate.version == 0 and sys_.engine.stats.steps == 0
    assert sys_.engine.dparams is tiny["tdp"]
    assert sys_.controller.collection_enabled
    b = sys_.run(iter(tiny["waves"][:3]), max_new_tokens=MAX_NEW)
    assert [r.generated for r in b] == [r.generated for r in a]
    assert _strip(sys_.events) == ev_a
    sum_b = sys_.summary()
    for k in ("tokens", "steps", "deploys", "train_cycles", "deployed",
              "signals_collected"):
        assert sum_b[k] == sum_a[k], k


def test_engine_reset_adaptation_restores_paged_engine(tiny):
    """``ServingEngine.reset_adaptation`` on a paged engine: the draft,
    EMA, counters, allocator and stats return to their start, and the
    same stream served again gives the same tokens and pages."""
    t = tiny
    eng = ServingEngine(t["cfg"], t["tp"], t["dcfg"], t["tdp"],
                        device="cpu", config=policy.ServingConfig(
                            batch_size=2, max_len=96, page_size=8))

    def serve():
        reqs = [Request(prompt=list(p), max_new_tokens=MAX_NEW)
                for wave in t["waves"][:2] for _, p in wave]
        eng.serve_stream(iter(reqs))
        return [r.generated for r in reqs], eng.stats.pages_peak

    first = serve()
    other = bridge.draft_from_numpy(
        t["dcfg"], bridge.tree_to_numpy(t["tdp"]), device="cpu")
    eng.deploy_draft(other)
    eng.reset_adaptation(t["tdp"])
    assert eng.dparams is t["tdp"] and eng.accept_ema == 1.0
    assert eng._deploy_seq == 0 and eng._sid_next == 0
    assert eng.stats.steps == 0 and eng.stats.tokens_out == 0
    assert eng.allocator.pages_in_use == 0
    assert serve() == first


# ======================================================== SignalChannel
def _batch(cls, i, s=8, f=6):
    return cls(feats=np.full((s, f), i, np.float32),
               tokens=np.full((s,), i, np.int32))


def _both(scenario):
    """``scenario(channel_cls, batch)`` on JAX's and the port's channel;
    returns the two records."""
    return (scenario(jtransport.SignalChannel,
                     lambda i: _batch(JaxSignalBatch, i)),
            scenario(transport.SignalChannel,
                     lambda i: _batch(SignalBatch, i)))


def test_channel_overflow_drop_oldest():
    def scenario(cls, batch):
        ch = cls(capacity=4)
        for i in range(7):
            ch.add(batch(i))
        rec = dict(depth=ch.peek_count(), dropped=ch.dropped,
                   added=ch.total_added, bytes=ch.total_bytes)
        rec["kept"] = [int(b.tokens[0]) for b in ch.drain()]
        rec["stats"] = ch.stats()
        return rec

    want, got = _both(scenario)
    assert got == want
    assert got["kept"] == [3, 4, 5, 6] and got["dropped"] == 3
    assert got["stats"]["pushed"] == 7 and got["stats"]["depth"] == 0


def test_channel_wait_and_close_wakes_consumer():
    def scenario(cls, batch):
        ch = cls(capacity=8)
        got = {}
        t = threading.Thread(target=lambda: got.update(
            n=ch.wait(min_count=2, timeout=5.0)))
        t.start()
        ch.add(batch(0))
        ch.add(batch(1))
        t.join(timeout=5.0)
        rec = dict(first_alive=t.is_alive(), n=got.get("n"))
        t2 = threading.Thread(target=lambda: ch.wait(min_count=99,
                                                     timeout=10.0))
        t2.start()
        time.sleep(0.05)
        ch.close()
        t2.join(timeout=2.0)
        rec.update(second_alive=t2.is_alive(), closed=ch.closed,
                   depth=ch.depth)
        return rec

    want, got = _both(scenario)
    assert got == want
    assert got == dict(first_alive=False, n=2, second_alive=False,
                       closed=True, depth=2)


def test_channel_add_after_close_drops_and_counts():
    def scenario(cls, batch):
        ch = cls(capacity=8)
        ch.add(batch(0))
        ch.add(batch(1))
        ch.close()
        ch.add(batch(2))
        ch.add(batch(3))
        rec = dict(depth=ch.peek_count(), rejected=ch.rejected_after_close,
                   stats=ch.stats())
        rec["kept"] = [int(b.tokens[0]) for b in ch.drain()]
        rec["again"] = ch.drain()
        ch.add(batch(4))
        rec.update(late=ch.drain(), rejected_late=ch.rejected_after_close,
                   added=ch.total_added)
        return rec

    want, got = _both(scenario)
    assert got == want
    assert got["kept"] == [0, 1] and got["again"] == [] == got["late"]
    assert got["rejected_late"] == 3 and got["added"] == 2


def test_channel_reset_clears_rejection_counter():
    def scenario(cls, batch):
        ch = cls(capacity=4)
        ch.close()
        ch.add(batch(0))
        before = ch.rejected_after_close
        ch.reset()
        return dict(before=before, after=ch.rejected_after_close,
                    depth=ch.peek_count(), closed=ch.closed)

    want, got = _both(scenario)
    assert got == want == dict(before=1, after=0, depth=0, closed=True)


# ======================================================= the service
def _trainers(t):
    return (JaxTrainer(t["jcfg"], t["jdcfg"], t["jp"]["embed"]),
            DraftTrainer(t["cfg"], t["dcfg"], t["tp"]["embed"],
                         device="cpu"))


def test_service_rejects_starving_channel(tiny):
    """A per-cycle threshold the bounded channel can never buffer fails at
    construction, with JAX's message."""
    jt, pt = _trainers(tiny)
    msgs = []
    for svc_mod, ch_mod, gate_cls, tr, dp in (
            (jservice, jtransport, jckpt.DraftDeployGate, jt, tiny["jdp"]),
            (service, transport, ckpt.DraftDeployGate, pt, tiny["tdp"])):
        with pytest.raises(ValueError, match="starve") as exc:
            svc_mod.TrainingService(tr, gate_cls(dp),
                                    ch_mod.SignalChannel(capacity=4),
                                    n_threshold=100, signal_window=10)
        msgs.append(str(exc.value))
    assert msgs[1] == msgs[0]


def test_deploy_gate_offers_and_log_match_jax(tiny):
    """tests/test_service.py's deploy-version sequence on both gates and
    services: accepted offers bump the version, a losing one does not,
    the published version is what ``poll`` reads, and ``reset`` clears."""
    jt, pt = _trainers(tiny)
    recs = []
    for gate_cls, svc_mod, ch_mod, tr, dp in (
            (jckpt.DraftDeployGate, jservice, jtransport, jt, tiny["jdp"]),
            (ckpt.DraftDeployGate, service, transport, pt, tiny["tdp"])):
        gate = gate_cls(dp)
        svc = svc_mod.TrainingService(tr, gate, ch_mod.SignalChannel(8),
                                      n_threshold=1, signal_window=1,
                                      train_epochs=1, train_min_steps=2)
        rec = [svc.poll() is None]
        rec.append(gate.offer("a", 0.5, 0.1))
        svc._latest = svc_mod.DraftVersion(gate.version, "a", 0.5)
        rec.append(svc.poll().seq)
        rec.append(gate.offer("b", 0.05, 0.5))
        rec.append(gate.version)
        rec.append(gate.offer("c", 0.9, 0.1))
        svc._latest = svc_mod.DraftVersion(gate.version, "c", 0.9)
        rec.append(svc.poll().seq)
        rec.append(gate.offer("d", 0.3, 0.3))       # a tie never deploys
        rec.append(gate.current())
        rec.append(list(gate.deploy_log))
        gate.reset(dp)
        rec.append((gate.current()[1], gate.deploy_log))
        recs.append(rec)
    assert recs[1] == recs[0]
    assert recs[1][1:8] == [True, 1, False, 1, True, 2, False]
    assert recs[1][8] == ("c", 2)


class _Dies:
    """A trainer whose cycle raises."""

    def train_cycle(self, *a, **kw):
        raise RuntimeError("trainer died")


def test_drain_survives_a_trainer_that_raises(tiny):
    """A cycle that raises is counted and ends the drain without
    propagating; the windows it drained are gone, the served draft and
    the deploy slot stay, as in JAX."""
    recs = []
    for svc_mod, ch_mod, gate_cls, batch_cls, dp in (
            (jservice, jtransport, jckpt.DraftDeployGate, JaxSignalBatch,
             tiny["jdp"]),
            (service, transport, ckpt.DraftDeployGate, SignalBatch,
             tiny["tdp"])):
        ch = ch_mod.SignalChannel(capacity=8)
        gate = gate_cls(dp)
        svc = svc_mod.TrainingService(_Dies(), gate, ch, n_threshold=2,
                                      signal_window=1)
        for i in range(3):
            ch.add(_batch(batch_cls, i))
        rec = [svc.should_train(), svc.drain(), svc.failures,
               svc.last_error, svc.poll(), gate.version, svc.stats()]
        rec += [svc.drain(), svc.failures, ch.depth]
        svc.close()
        rec += [ch.closed, svc.running]
        svc.close()                                 # idempotent
        recs.append(rec)
    assert recs[1] == recs[0]
    assert recs[1][:6] == [True, 0, 1, "RuntimeError: trainer died", None, 0]
    assert recs[1][7:] == [0, 1, 0, True, False]


# ========================================================== checkpoints
def test_ckpt_port_save_loads_in_jax(tiny, tmp_path):
    """A draft the port saves loads into JAX's pytree bit for bit, with
    its metadata."""
    path = str(tmp_path / "sub" / "draft.npz")
    ckpt.save(path, tiny["tdp"], metadata={"version": 3})
    got = jckpt._flatten(jckpt.load(path, tiny["jdp"]))
    want = bridge.tree_to_numpy(tiny["tdp"])
    assert set(got) == set(want)
    assert all(np.array_equal(got[k], want[k]) for k in want)
    with open(path + ".json") as f:
        assert f.read().count('"version": 3') == 1


def test_ckpt_jax_save_loads_in_port(tiny, tmp_path):
    """A draft JAX saves loads into the port's ``ParamTree`` bit for bit,
    servable (frozen leaves)."""
    path = str(tmp_path / "draft.npz")
    jckpt.save(path, tiny["jdp"])
    tree = ckpt.load(path, tiny["tdp"])
    assert isinstance(tree, type(tiny["tdp"]))
    assert not any(p.requires_grad for p in tree.parameters())
    got, want = bridge.tree_to_numpy(tree), jckpt._flatten(tiny["jdp"])
    assert set(got) == set(want)
    assert all(np.array_equal(got[k], np.asarray(want[k])) for k in want)


def test_ckpt_nested_dict_and_bf16_round_trip(tiny, tmp_path):
    """A nested dict of tensors (AdamW state of the draft) crosses to JAX
    under its keys and back; a bf16 tree comes back bf16, exactly, from
    the port's file (widened to fp32) and from JAX's (raw bf16 words)."""
    flat = bridge.flat(tiny["tdp"])
    opt = topt.adamw(lr=1e-3)
    state = opt.init({k: v.clone() for k, v in flat.items()})
    for i, v in enumerate(state["m"].values()):
        v.add_(float(i))
    path = str(tmp_path / "opt.npz")
    ckpt.save(path, state)
    back = ckpt.load(path, state)
    assert set(back) == {"m", "v"} and set(back["m"]) == set(state["m"])
    assert all(torch.equal(bridge.flat(back)[k], t)
               for k, t in bridge.flat(state).items())
    jlike = jax.tree.map(np.asarray, bridge.tree_to_numpy(state))
    jgot = jckpt._flatten(jckpt.load(path, jlike))
    assert all(np.array_equal(jgot[k], v)
               for k, v in bridge.tree_to_numpy(state).items())
    bf = {"a": {"w": torch.randn(3, 5).bfloat16()}, "b": torch.ones(4)}
    ckpt.save(str(tmp_path / "bf.npz"), bf)
    bf2 = ckpt.load(str(tmp_path / "bf.npz"), bf)
    assert bf2["a"]["w"].dtype == torch.bfloat16
    assert torch.equal(bf2["a"]["w"], bf["a"]["w"])
    assert torch.equal(bf2["b"], bf["b"])
    # JAX writes bf16 leaves as raw 16-bit words
    jbf = {"a": {"w": jax.numpy.asarray(np.asarray(bf["a"]["w"].float()),
                                        dtype=jax.numpy.bfloat16)}}
    jckpt.save(str(tmp_path / "jbf.npz"), jbf)
    got = ckpt.load(str(tmp_path / "jbf.npz"), {"a": {"w": bf["a"]["w"]}})
    assert torch.equal(got["a"]["w"], bf["a"]["w"])


def test_ckpt_shape_mismatch_raises(tmp_path):
    path = str(tmp_path / "x.npz")
    ckpt.save(path, {"w": torch.zeros(2, 3)})
    with pytest.raises(ValueError, match="shape"):
        ckpt.load(path, {"w": torch.zeros(3, 2)})
    with pytest.raises(ValueError, match="shape"):
        jckpt.load(path, {"w": np.zeros((3, 2), np.float32)})


# ============================================================ workloads
@pytest.mark.parametrize("seed", [0, 1, 7])
def test_workloads_match_jax(seed):
    """``make_domains``, ``arrival_trace`` (both modes, every annotation),
    ``training_corpus`` and ``WorkloadStream`` equal to JAX's."""
    names, br = jwork.PAPER_DOMAINS, jwork.PAPER_BRANCHINGS
    jd = jwork.make_domains(512, names, br, seed=seed)
    pd = workloads.make_domains(512, names, br, seed=seed)
    assert list(jd) == list(pd)
    for n in names:
        assert (jd[n].vocab_lo, jd[n].vocab_hi, jd[n].branching) == \
            (pd[n].vocab_lo, pd[n].vocab_hi, pd[n].branching)
        assert np.array_equal(jd[n].next_tok, pd[n].next_tok)
        assert np.array_equal(jd[n].next_prob, pd[n].next_prob)
    for kw in (dict(mode="poisson"),
               dict(mode="bursty", long_frac=0.3, long_prompt_period=4,
                    deadline_slack=(1.0, 4.0), tight_frac=0.4,
                    tight_slack=(0.1, 0.3), priority_levels=3,
                    shared_prefix_frac=0.5, prefix_len=6),
               dict(mode="poisson", prompt_len=(5, 9),
                    long_prompt_frac=0.25,
                    schedule=[jwork.Phase("science", 3),
                              jwork.Phase("sharegpt", 4)])):
        pkw = dict(kw)
        if "schedule" in pkw:
            pkw["schedule"] = [workloads.Phase(p.domain, p.n_requests)
                               for p in kw["schedule"]]
        a = jwork.arrival_trace(jd, 12, seed=seed, **kw)
        b = workloads.arrival_trace(pd, 12, seed=seed, **pkw)
        assert [(e.t, e.domain, list(map(int, e.prompt)), e.max_new_tokens,
                 e.deadline, e.priority) for e in b] == \
            [(e.t, e.domain, list(map(int, e.prompt)), e.max_new_tokens,
              e.deadline, e.priority) for e in a]
    assert np.array_equal(
        workloads.training_corpus(pd["science"], 5, 11, seed),
        jwork.training_corpus(jd["science"], 5, 11, seed))
    sched = [("science", 3), ("evolcode", 2)]
    ja = jwork.WorkloadStream(jd, [jwork.Phase(*p) for p in sched], seed)
    pa = workloads.WorkloadStream(pd, [workloads.Phase(*p) for p in sched],
                                  seed)
    assert list(pa.batches(2)) == list(ja.batches(2))


def test_requests_from_trace(tiny):
    """Trace events become requests in trace order, SLO annotations and
    arrival offsets carried."""
    doms = workloads.make_domains(512, ["science"], seed=3)
    trace = workloads.arrival_trace(doms, 5, deadline_slack=(1.0, 2.0),
                                    priority_levels=2, seed=4)
    reqs = _port_system(tiny).requests_from_trace(trace)
    assert [(r.prompt, r.domain, r.max_new_tokens, r.arrives_at,
             r.deadline, r.priority) for r in reqs] == \
        [(e.prompt, e.domain, e.max_new_tokens, e.t, e.deadline, e.priority)
         for e in trace]


# ============================================================= refusals
@pytest.mark.parametrize("kw,item", [
    (dict(fleet=FleetConfig(trainer_endpoint="spawn")), "item 7"),
    (dict(commit="eager"), "item 5"),
    (dict(preempt="deadline"), "item 6"),
    (dict(shed="expired"), "item 6"),
    (dict(shed="queue", shed_queue_depth=9), "item 6"),
    (dict(shed_queue_depth=9), "item 6"),
    (dict(greedy=False, seed=5), "item 4"),
    (dict(prefill_chunk=8, commit="eager"), "item 5"),
], ids=["fleet", "commit", "preempt", "shed_expired", "shed_queue",
        "shed_queue_depth", "sampling_seed", "chunked_eager"])
def test_tide_unported_configs_raise(tiny, kw, item):
    """Each unported configuration raises naming its item; those of
    items 4-7 (sampled decoding, chunked refill prefill and its eager
    commit, preemption and load shedding, the fleet), once refused here,
    are served: the system's knobs reach the engine (the fleet's
    endpoint, the remote trainer), and a wave reaches its budgets."""
    if item == "item 7":
        from repro_torch.fleet.remote import RemoteTrainingService
        sys_ = _port_system(tiny, **kw)
        try:
            assert isinstance(sys_.service, RemoteTrainingService)
            assert sys_.service.endpoint == kw["fleet"].trainer_endpoint
            assert sys_.trainer is None and sys_.gate is sys_.service.gate
            done = sys_.run(iter(tiny["waves"][:1]), max_new_tokens=8)
            assert [len(r.generated) for r in done] == [8, 8]
            assert sys_.summary()["trainer_failures"] == 0
        finally:
            sys_.close()
        assert sys_.service._proc.poll() is not None
        return
    if item in ("item 4", "item 5", "item 6"):
        sys_ = _port_system(tiny, **kw)
        eng = sys_.engine
        assert eng.greedy is kw.get("greedy", True)
        assert eng.config.seed == kw.get("seed", 0)
        assert eng.prefill_chunk == kw.get("prefill_chunk", 0)
        assert eng.policy.commit.name == kw.get("commit", "cohort")
        pre = eng.policy.preemption
        assert pre.name == kw.get("preempt", "none")
        assert pre.shed.name == kw.get("shed", "none")
        assert eng.config.shed_queue_depth == kw.get("shed_queue_depth", 64)
        if pre.shed.name == "queue":
            assert pre.shed.depth == kw["shed_queue_depth"]
        done = sys_.run(iter(tiny["waves"][:1]), max_new_tokens=8)
        assert [len(r.generated) for r in done] == [8, 8]
        assert (eng.stats.prefill_chunks > 0) == bool(eng.prefill_chunk)
        return
    with pytest.raises(NotImplementedError, match=f"ROADMAP queue 1 {item}"):
        _port_system(tiny, **kw)


@pytest.mark.parametrize("kw", [dict(seed=5), dict(reseed_window=16)],
                         ids=["seed", "reseed_window"])
def test_tide_inert_knobs_are_accepted(tiny, kw):
    """Sync mode zeroes ``reseed_window`` before building the engine
    (JAX's ``core/tide.py:309-312``).  The system's ``seed`` orders the
    trainer's batches (and draws a default draft), and the engine gets
    it as its sampling seed, as JAX's does."""
    sys_ = _port_system(tiny, **kw)
    assert sys_.engine.config.reseed_window == 0
    assert sys_.engine.config.seed == sys_.tcfg.seed == kw.get("seed", 0)
    assert sys_.service.seed == sys_.tcfg.seed == kw.get("seed", 0)


def test_tide_without_device_needs_a_card(tiny, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tide.TideSystem(tiny["cfg"], tiny["tp"], tide.TideConfig(**_TCFG),
                        dparams=tiny["tdp"])
    # the default draft is drawn on the system's device
    sys_ = tide.TideSystem(tiny["cfg"], tiny["tp"],
                           tide.TideConfig(**_TCFG), device="cpu")
    assert sys_.engine.dparams["head"]["w"].device.type == "cpu"


# ========================================================= config mirror
def _fields(cls):
    return {f.name: f.default for f in dataclasses.fields(cls)}


def test_serving_config_fields_match_jax():
    assert _fields(policy.ServingConfig) == _fields(jpolicy.ServingConfig)


def test_tide_config_fields_match_jax():
    assert _fields(tide.TideConfig) == _fields(jtide.TideConfig)
    assert tide.TideConfig._SHARED_FIELDS == jtide.TideConfig._SHARED_FIELDS


def test_shared_fields_cover_every_serving_knob():
    """Every port ServingConfig knob (``completion_sink`` is a host
    callback) has a flat TideConfig mirror with an equal default."""
    knobs = set(_fields(policy.ServingConfig)) - {"completion_sink"}
    assert set(tide.TideConfig._SHARED_FIELDS) == knobs
    flat = _fields(tide.TideConfig)
    serving = _fields(policy.ServingConfig)
    for name in tide.TideConfig._SHARED_FIELDS:
        assert flat[name] == serving[name], name


PROBE = {"gamma": 5, "batch_size": 7, "max_len": 320, "greedy": False,
         "superstep_rounds": 3, "eos_id": 9, "ema": 0.5, "seed": 13,
         "admission": "deadline", "commit": "eager",
         "admission_lookahead": 17, "gate_arrivals": True,
         "idle_wait_s": 0.25, "prefill_chunk": 16, "page_size": 8,
         "num_pages": 40, "share_prefix": False,
         "spec_park_patience": 6, "spec_probe_interval": 4,
         "tree_width": 2, "reseed_window": 8, "trainer_threads": 2,
         "preempt": "deadline", "shed": "expired",
         "shed_queue_depth": 9}


@pytest.mark.parametrize("name", sorted(PROBE))
def test_flat_fields_mirror_into_serving_as_jax(name):
    """The flat field lands on ``serving``, an explicit ``serving=``
    populates the flat view, and ``dataclasses.replace`` overrides only
    what it changes: on both packages alike."""
    value = PROBE[name]
    out = []
    for tmod, pmod in ((jtide, jpolicy), (tide, policy)):
        tc = tmod.TideConfig(**{name: value})
        tc2 = tmod.TideConfig(serving=pmod.ServingConfig(**{name: value}))
        tc3 = dataclasses.replace(tc2, batch_size=11)
        out.append((getattr(tc.serving, name), getattr(tc2, name),
                    getattr(tc3.serving, name), tc3.serving.batch_size))
    assert out[1] == out[0]
    assert out[1][:2] == (value, value)
