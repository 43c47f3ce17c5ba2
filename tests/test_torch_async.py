"""The port's asynchronous adaptation loop and deploy-time re-seed against
the JAX package on the CPU (tide_tiny, fp32, fixed seeds; JAX is the
oracle).  Every wait and join here is bounded.

* ``core/hetero.py``: the Fig. 12 grid, ``best_split`` and
  ``plan_tpu_submesh`` equal JAX's; ``pick_training_device`` gives None
  below two cards and JAX's index rule above.
* ``SignalChannel(device="cpu")`` puts each batch's arrays on the device
  as tensors, with JAX's stats; the trainer takes them as they are.
* ``TrainingService``'s thread on both packages with stub trainers: start,
  running, close (idempotent, restartable), a trainer that raises, a
  wedged trainer abandoned by ``close(timeout)``, ``trainer_threads``'s
  ``thread_cap``, the fleet hooks; with the port's real trainer,
  ``device``/``publish_device="cpu"``.
* ``TideSystem(async_train=True)``, JAX's
  ``test_async_service_trains_and_streams_match`` on the port: per-request
  streams equal the port's sync streams and JAX's, the thread trains and
  deploys with monotonic versions, each deploy re-seeds, and ``close``
  joins the thread.
* The capture ring after a superstep equals JAX's (tokens and counts
  exactly, features within 2e-5), and a refill empties it.
* ``reseed_draft_rows_from_ring`` and its paged form equal JAX's on the
  same cache, ring and draft within 2e-5, in one pass (JAX's shapes)
  and in the engine's blocks of gamma + 1 columns, which on the CPU
  give the one-pass rows bit for bit.
* JAX's re-seed tests on the port (tests/test_service.py,
  tests/test_paged.py): the re-seed with the serving draft is bit for bit
  a no-op; with a new draft it gives the new draft's serving cache within
  2e-5 and moves; paged equals dense on the gathered view bit for bit; a
  mid-stream deploy gives one deploy and one re-seed with unchanged
  streams, dense, paged and at tree width 2.
* Two threads counting kernel launches lose no increment, and two
  threads asking for the kernel library build it once."""
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import repro.configs as C  # noqa: E402
from repro.checkpoint import ckpt as jckpt  # noqa: E402
from repro.core import eagle as jeagle  # noqa: E402
from repro.core import hetero as jhetero  # noqa: E402
from repro.core import speculative as jspec  # noqa: E402
from repro.core import tide as jtide  # noqa: E402
from repro.core import transport as jtransport  # noqa: E402
from repro.core.signals import SignalBatch as JaxSignalBatch  # noqa: E402
from repro.data import workloads as jwork  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serving.engine import ServingEngine as JaxEngine  # noqa: E402
from repro.serving.request import Request as JaxRequest  # noqa: E402
from repro.serving.scheduler import Scheduler as JaxScheduler  # noqa: E402
from repro.training import service as jservice  # noqa: E402
from repro.training.trainer import pretrain_target  # noqa: E402
from repro_torch.checkpoint import bridge, ckpt  # noqa: E402
from repro_torch.configs import get  # noqa: E402
from repro_torch.core import eagle, hetero, paging  # noqa: E402
from repro_torch.core import speculative as spec  # noqa: E402
from repro_torch.core import tide, transport  # noqa: E402
from repro_torch.core.signals import SignalBatch  # noqa: E402
from repro_torch.kernels import build as kbuild  # noqa: E402
from repro_torch.kernels import count  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from repro_torch.serving.policy import ServingConfig  # noqa: E402
from repro_torch.serving.request import Request  # noqa: E402
from repro_torch.serving.scheduler import Scheduler  # noqa: E402
from repro_torch.training import service  # noqa: E402
from repro_torch.training.draft_trainer import DraftTrainer  # noqa: E402

# tests/test_service.py's sync-mode configuration
_TCFG = dict(gamma=3, batch_size=2, max_len=96, adaptive_spec=False,
             selective_training=True, signal_window=8, n_threshold=4,
             train_epochs=1, train_min_steps=6, seed=0)
TOL = 2e-5              # fp32 rtol/atol of the port against JAX
JOIN_S = 60.0           # the longest any test waits on a thread


@pytest.fixture(scope="module")
def tiny():
    """tide_tiny pretrained in JAX (40 steps), JAX's initial draft (key 7)
    and a second draft (key 99, tests/test_service.py's draft B), all
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
    init = jax.jit(jeagle.draft_init, static_argnums=0)
    jdp, jdp_b = init(jdcfg, jax.random.key(7)), init(jdcfg,
                                                      jax.random.key(99))
    cfg = get("tide-tiny")
    dcfg = eagle.draft_config(cfg)
    tp = bridge.target_from_numpy(cfg, jckpt._flatten(jp), device="cpu")

    def draft(d):
        return bridge.draft_from_numpy(dcfg, jckpt._flatten(d), device="cpu")

    rng = np.random.default_rng(1)
    waves = [[("science", domains["science"].sample_prompt(rng))
              for _ in range(2)] for _ in range(4)]
    yield dict(jcfg=jcfg, jdcfg=jdcfg, jp=jp, jdp=jdp, jdp_b=jdp_b,
               cfg=cfg, dcfg=dcfg, tp=tp, tdp=draft(jdp), tdp_b=draft(jdp_b),
               domains=domains, waves=waves)
    torch.set_num_threads(threads)


def _join(svc):
    svc.close(timeout=JOIN_S)
    assert not svc.running


# =============================================================== hetero
def test_paper_grid_and_best_split_match_jax():
    assert hetero.paper_figure12_grid() == jhetero.paper_figure12_grid()
    for hi in hetero.PAPER_DEVICES:
        for lo in hetero.PAPER_DEVICES:
            for nh, nl, s in ((4, 1, 1.2), (2, 3, 1.1), (1, 1, 1.3)):
                assert hetero.best_split(
                    hetero.PAPER_DEVICES[hi], hetero.PAPER_DEVICES[lo],
                    nh, nl, s) == jhetero.best_split(
                    jhetero.PAPER_DEVICES[hi], jhetero.PAPER_DEVICES[lo],
                    nh, nl, s)
    assert not hasattr(hetero, "TPU_DEVICES")


@pytest.mark.parametrize("s", [1.1, 1.2, 1.3])
def test_plan_tpu_submesh_matches_jax(s):
    for n in range(1, 301):
        a, b = jhetero.plan_tpu_submesh(n, s), hetero.plan_tpu_submesh(n, s)
        assert (b.serve_chips, b.train_chips, b.s) == \
            (a.serve_chips, a.train_chips, a.s), n
        assert b.relative_throughput() == a.relative_throughput()


@pytest.mark.parametrize("n", [0, 1, 2, 8, 256])
def test_pick_training_device_follows_jax_rule(monkeypatch, n):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: n)
    got = transport.pick_training_device()
    if n < 2:
        assert got is None
        return
    plan = jhetero.plan_tpu_submesh(n, 1.2)
    assert got == torch.device("cuda", n - max(plan.train_chips, 1))


# ============================================================== channel
def _batch(cls, i, s=8, f=6):
    return cls(feats=np.full((s, f), i, np.float32),
               tokens=np.full((s,), i, np.int32))


def test_channel_device_places_tensors_with_jax_stats(tiny):
    """A channel with a device holds tensors there, counts bytes, drops
    the oldest and rejects after close as JAX's does with its device_put;
    the trainer stacks and takes the placed windows as they are."""
    recs = []
    for ch_mod, cls, dev in ((jtransport, JaxSignalBatch, jax.devices()[0]),
                             (transport, SignalBatch, "cpu")):
        ch = ch_mod.SignalChannel(capacity=4, device=dev)
        for i in range(6):
            ch.add(_batch(cls, i))
        st = dict(ch.stats())
        kept = ch.drain()
        ch.close()
        ch.add(_batch(cls, 9))
        recs.append((st, [int(b.tokens[0]) for b in kept],
                     ch.rejected_after_close, kept))
    (jst, jkept, jrej, _), (pst, pkept, prej, batches) = recs
    assert (pst, pkept, prej) == (jst, jkept, jrej)
    assert pkept == [2, 3, 4, 5] and pst["bytes"] == 6 * (8 * 6 * 4 + 8 * 4)
    assert all(isinstance(b.feats, torch.Tensor) and b.feats.device.type
               == "cpu" and b.feats.dtype == torch.float32 and
               b.tokens.dtype == torch.int32 for b in batches)
    tr = DraftTrainer(tiny["cfg"], tiny["dcfg"], tiny["tp"]["embed"],
                      device="cpu")
    feats, toks = tr._stack(batches)
    f, t = tr.device_arrays(feats, toks)
    f2, t2 = tr.device_arrays(*DraftTrainer._stack(
        [_batch(SignalBatch, i) for i in range(2, 6)]))
    assert torch.equal(f, f2) and torch.equal(t, t2)
    assert t.dtype == torch.int64 and f.dtype == tiny["dcfg"].act_dtype


# ======================================================= service thread
class _Stub:
    """A trainer whose cycle returns at once (or raises, or blocks on an
    event), with a fixed eval accuracy."""

    def __init__(self, eval_acc=0.9, raise_=False, block=None):
        self.eval_acc, self.raise_, self.block = eval_acc, raise_, block
        self.calls = 0
        self.device = torch.device("cpu")

    def train_cycle(self, dparams, batches, **kw):
        self.calls += 1
        if self.block is not None:
            self.block.wait(timeout=JOIN_S)
        if self.raise_:
            raise RuntimeError("trainer died")
        return {"dparams": dparams, "eval_acc": self.eval_acc,
                "train_acc": 0.5, "steps": 1, "seconds": 0.0}


def _svc(mod, ch_mod, gate_cls, trainer, **kw):
    ch = ch_mod.SignalChannel(capacity=8)
    svc = mod.TrainingService(trainer, gate_cls("draft0"), ch,
                              n_threshold=2, signal_window=1, poll_s=0.01,
                              **kw)
    return svc, ch


PACKAGES = {"jax": (jservice, jtransport, jckpt.DraftDeployGate,
                    JaxSignalBatch),
            "port": (service, transport, ckpt.DraftDeployGate, SignalBatch)}


def _until(pred, timeout=JOIN_S):
    t0 = time.perf_counter()
    while not pred():
        if time.perf_counter() - t0 > timeout:
            return False
        time.sleep(0.005)
    return True


def _thread_scenario(pkg):
    mod, ch_mod, gate_cls, bcls = PACKAGES[pkg]
    svc, ch = _svc(mod, ch_mod, gate_cls, _Stub())
    rec = [svc.running]
    svc.start()
    svc.start()                              # a second start is a no-op
    rec.append(svc.running)
    for i in range(2):
        ch.add(_batch(bcls, i))
    rec.append(_until(lambda: svc.poll() is not None))
    rec.append((svc.cycles, svc.poll().seq, svc.gate.version))
    thread = svc._thread
    svc.close(timeout=JOIN_S)
    rec.append((svc.running, thread.is_alive(), ch.closed, svc.failures))
    svc.close(timeout=JOIN_S)                # idempotent
    rec.append((svc.running, svc.failures))
    svc.start()                              # restart after close
    rec.append(svc.running)
    svc.close(timeout=JOIN_S)
    rec.append((svc.running, svc.failures, svc.stats()["thread_cap"]))
    return rec


def test_service_thread_start_close_restart_as_jax():
    want, got = _thread_scenario("jax"), _thread_scenario("port")
    assert got == want
    assert got == [False, True, True, (1, 1, 1), (False, False, True, 0),
                   (False, 0), True, (False, 0, None)]


def _dies_scenario(pkg):
    mod, ch_mod, gate_cls, bcls = PACKAGES[pkg]
    stub = _Stub(raise_=True)
    svc, ch = _svc(mod, ch_mod, gate_cls, stub)
    svc.start()
    for i in range(4):
        ch.add(_batch(bcls, i))
    ok = _until(lambda: not svc.running)
    rec = [ok, stub.calls, svc.failures, svc.last_error, svc.poll(),
           svc.cycles]
    svc.close(timeout=JOIN_S)
    return rec


def test_service_thread_stops_on_a_trainer_that_raises():
    want, got = _dies_scenario("jax"), _dies_scenario("port")
    assert got == want
    assert got == [True, 1, 1, "RuntimeError: trainer died", None, 0]


def _wedged_scenario(pkg):
    mod, ch_mod, gate_cls, bcls = PACKAGES[pkg]
    block = threading.Event()
    stub = _Stub(block=block)
    svc, ch = _svc(mod, ch_mod, gate_cls, stub)
    svc.start()
    thread = svc._thread
    for i in range(2):
        ch.add(_batch(bcls, i))
    entered = _until(lambda: stub.calls == 1)
    t0 = time.perf_counter()
    svc.close(timeout=0.5)
    waited = time.perf_counter() - t0
    rec = [entered, svc.running, svc.failures,
           "failed to stop within 0.5s" in (svc.last_error or ""),
           0.4 < waited < 5.0]
    block.set()
    thread.join(timeout=JOIN_S)
    rec.append(thread.is_alive())
    return rec


def test_service_close_abandons_a_wedged_trainer():
    want, got = _wedged_scenario("jax"), _wedged_scenario("port")
    assert got == want
    assert got == [True, False, 1, True, True, False]


def test_trainer_threads_deprioritizes_the_thread():
    """``trainer_threads > 0`` lowers the training thread's OS priority
    and reports it as ``thread_cap``: "thread_nice", or None where the
    OS refuses (as JAX)."""
    caps = []
    for pkg in ("jax", "port"):
        mod, ch_mod, gate_cls, _ = PACKAGES[pkg]
        svc, _ = _svc(mod, ch_mod, gate_cls, _Stub(), trainer_threads=1)
        svc.start()
        # the thread sets its cap first thing; None stays None where the
        # OS refuses
        _until(lambda: svc._thread_cap is not None, timeout=2.0)
        caps.append(svc.stats()["thread_cap"])
        assert svc.stats()["trainer_threads"] == 1
        _join(svc)
    assert caps[1] == caps[0] and caps[1] in ("thread_nice", None)


def _hooks_scenario(pkg):
    mod, ch_mod, gate_cls, bcls = PACKAGES[pkg]
    published, events = [], []
    svc, ch = _svc(mod, ch_mod, gate_cls, _Stub(eval_acc=0.4),
                   baseline_fn=lambda: 0.25,
                   on_publish=lambda v: published.append((v.seq, v.eval_acc)),
                   on_event=lambda e: events.append(
                       (e["baseline"], e["deployed"])))
    for i in range(2):
        ch.add(_batch(bcls, i))
    svc.drain()
    svc.start()
    for i in range(2):
        ch.add(_batch(bcls, i))
    _until(lambda: svc.cycles == 2)
    _join(svc)
    return published, events


def test_fleet_hooks_are_called_as_jax():
    """``baseline_fn`` stands in for a controller, ``on_publish`` sees each
    accepted deploy and ``on_event`` each cycle, on ``drain`` and on the
    thread alike."""
    want, got = _hooks_scenario("jax"), _hooks_scenario("port")
    assert got == want
    assert got == ([(1, 0.4), (2, 0.4)], [(0.25, True), (0.25, True)])


def test_service_trains_and_publishes_on_given_devices(tiny):
    """With the port's trainer, ``device``/``publish_device="cpu"``: the
    thread trains a cycle and publishes a draft on the publish device,
    which an engine serves."""
    tr = DraftTrainer(tiny["cfg"], tiny["dcfg"], tiny["tp"]["embed"],
                      device="cpu")
    ch = transport.SignalChannel(capacity=8, device="cpu")
    svc = service.TrainingService(
        tr, ckpt.DraftDeployGate(tiny["tdp"]), ch, n_threshold=24,
        signal_window=8, train_epochs=1, train_min_steps=2,
        device="cpu", publish_device="cpu", poll_s=0.01)
    assert svc.device == svc.publish_device == torch.device("cpu")
    rng = np.random.default_rng(0)
    f = tiny["cfg"].d_model * 3
    svc.start()
    for _ in range(3):
        ch.add(SignalBatch(
            feats=rng.standard_normal((8, f)).astype(np.float32),
            tokens=rng.integers(0, tiny["cfg"].vocab_size, 8).astype(
                np.int32)))
    assert _until(lambda: svc.cycles == 1)
    _join(svc)
    assert svc.failures == 0 and svc.events[0]["steps"] >= 2
    ver = svc.poll()
    if svc.events[0]["deployed"]:
        assert ver.seq == 1
        assert all(t.device.type == "cpu"
                   for t in bridge.flat(ver.dparams).values())
    else:
        assert ver is None


# ============================================================ async system
def _stream_reqs(t, cls):
    return [cls(prompt=list(p), domain=d, max_new_tokens=24)
            for wave in t["waves"] for d, p in wave]


def test_async_service_trains_and_streams_match(tiny):
    """JAX's test_async_service_trains_and_streams_match on the port:
    per-request streams equal the port's sync streams and JAX's (the
    completion order may differ: deploys change round counts), the thread
    trains (at least one cycle after a settling ``drain``), picked-up
    versions rise monotonically, each deploy is re-seeded, and ``close``
    joins the thread; a second ``close`` is a no-op."""
    t = tiny

    def key(done):
        return sorted((tuple(r.prompt), tuple(r.generated)) for r in done)

    js = jtide.TideSystem(t["jcfg"], t["jp"], jtide.TideConfig(**_TCFG),
                          dparams=t["jdp"])
    jdone = js.run_stream(iter(_stream_reqs(t, JaxRequest)))
    sync = tide.TideSystem(t["cfg"], t["tp"], tide.TideConfig(**_TCFG),
                           dparams=t["tdp"], device="cpu")
    sdone = sync.run_stream(iter(_stream_reqs(t, Request)))
    assert not sync.service.running
    asy = tide.TideSystem(
        t["cfg"], t["tp"], tide.TideConfig(**_TCFG, async_train=True,
                                           reseed_window=16),
        dparams=t["tdp"], device="cpu")
    try:
        assert asy.service.running
        assert asy.engine.reseed_window == 16
        assert asy.engine.deploy_source == asy.service.poll
        picked = []
        poll = asy.engine._poll_deploy

        def polled(source=None):
            ver = poll(source)
            if ver is not None:
                picked.append(ver.seq)
            return ver

        asy.engine._poll_deploy = polled
        adone = asy.run_stream(iter(_stream_reqs(t, Request)))
        asy.service.drain()          # settle what the thread left
        assert asy.service.cycles >= 1, "async service never trained"
        assert asy.gate.version >= 1
        assert key(adone) == key(sdone) == key(jdone)
        assert picked == sorted(set(picked))
        assert all(1 <= v <= asy.gate.version for v in picked)
        st = asy.summary()
        assert st["reseeds"] == st["deploys"] == len(picked)
        assert st["trainer_failures"] == 0
        versions = [d["version"] for d in asy.gate.deploy_log
                    if d["deployed"]]
        assert versions == list(range(1, asy.gate.version + 1))
    finally:
        thread = asy.service._thread
        asy.close()
    assert not asy.service.running
    assert thread is None or not thread.is_alive(), \
        "service thread still alive after close()"
    asy.close()                      # idempotent
    assert asy.service.failures == 0


def test_async_summary_and_reset(tiny):
    """Async mode's summary reads the engine's re-seed counter, sync mode
    zeroes ``reseed_window``, and ``reset_adaptation`` (under the train
    lock) restores the fresh state with the thread still running."""
    t = tiny
    asy = tide.TideSystem(
        t["cfg"], t["tp"], tide.TideConfig(**_TCFG, async_train=True,
                                           reseed_window=4,
                                           trainer_threads=1),
        dparams=t["tdp"], device="cpu")
    try:
        assert asy.engine.reseed_window == _TCFG["gamma"] + 2
        asy.engine.stats.reseeds = 3
        assert asy.summary()["reseeds"] == 3
        asy.reset_adaptation()
        assert asy.summary()["reseeds"] == 0 and asy.gate.version == 0
        assert asy.service.running and asy.service.poll() is None
        assert asy.service.stats()["trainer_threads"] == 1
    finally:
        asy.close()
    assert not asy.service.running


# ====================================================== ring and re-seed
def _reqs(t, budgets, seed, cls):
    rng = np.random.default_rng(seed)
    return [cls(prompt=t["domains"]["science"].sample_prompt(rng),
                max_new_tokens=m) for m in budgets]


def _port_drive(t, dp, window, supersteps=3, budget=64, **kw):
    """The port engine's prologue and ``supersteps`` supersteps on two
    requests, as tests/test_service.py drives JAX's.  Returns (engine,
    dcache, state)."""
    eng = ServingEngine(t["cfg"], t["tp"], t["dcfg"], dp, device="cpu",
                        deploy_source=lambda: None, config=ServingConfig(
                            batch_size=2, max_len=96, superstep_rounds=8,
                            reseed_window=window, **kw))
    reqs = _reqs(t, (budget, budget), 4, Request)
    sched = Scheduler(2, reqs)
    eng._assign_sids(sched.admit())
    cache, dcache, carry, first = eng._prologue(reqs)
    state = spec.init_superstep_state(
        carry, first, sids=torch.as_tensor(eng._slot_sids(reqs)),
        capture_window=eng.reseed_window)
    mx = torch.tensor([budget, budget], dtype=torch.int32)
    for _ in range(supersteps):
        out = eng._superstep(cache, dcache, state, mx,
                             eng.policy.speculation.dispatch_table())
        cache, dcache, state = out["cache"], out["dcache"], out["state"]
    return eng, dcache, state


def _jax_drive(t, window, supersteps=1, budget=64):
    eng = JaxEngine(t["jcfg"], t["jp"], t["jdcfg"], t["jdp"], gamma=3,
                    batch_size=2, max_len=96, superstep_rounds=8,
                    reseed_window=window, deploy_source=lambda: None)
    reqs = _reqs(t, (budget, budget), 4, JaxRequest)
    sched = JaxScheduler(2, reqs)
    eng._assign_sids(sched.admit())
    cache, dcache, carry, first = eng._prologue(reqs)
    state = jspec.init_superstep_state(
        carry, first, eng._base_key, sids=eng._slot_sids(reqs),
        capture_window=window)
    mx = jnp.asarray([budget, budget], jnp.int32)
    for _ in range(supersteps):
        out = eng._superstep_fn(eng.params, eng.dparams, cache, dcache,
                                state, mx)
        dcache, state = out["dcache"], out["state"]
        cache = out["cache"]
    return eng, dcache, state


@pytest.mark.parametrize("supersteps", [1, 3])
def test_capture_ring_matches_jax(tiny, supersteps):
    """After one superstep (the ring part filled) and after three (it
    wrapped): ring tokens and counts equal JAX's, features within 2e-5;
    the engine raises the window to gamma + 2 as JAX does."""
    _, jd, js = _jax_drive(tiny, 16, supersteps)
    eng, pd, ps = _port_drive(tiny, tiny["tdp"], 16, supersteps)
    assert eng.reseed_window == 16
    assert ps.cap_feats.shape == tuple(js.cap_feats.shape)
    assert np.array_equal(ps.cap_count.numpy(), np.asarray(js.cap_count))
    assert int(ps.cap_count.min()) > 0
    if supersteps == 3:
        assert int(ps.cap_count.min()) > 16          # the ring wrapped
    assert np.array_equal(ps.cap_toks.numpy(), np.asarray(js.cap_toks))
    np.testing.assert_allclose(ps.cap_feats.numpy(),
                               np.asarray(js.cap_feats), rtol=TOL, atol=TOL)
    assert np.array_equal(pd["lengths"].numpy(), np.asarray(jd["lengths"]))


def test_refill_empties_the_ring(tiny):
    eng, _, state = _port_drive(tiny, tiny["tdp"], 16, 1)
    assert ServingEngine(tiny["cfg"], tiny["tp"], tiny["dcfg"], tiny["tdp"],
                         device="cpu", reseed_window=2).reseed_window == 5
    feats, toks = state.cap_feats.clone(), state.cap_toks.clone()
    mask = torch.tensor([False, True])
    src = torch.tensor([0, 0], dtype=torch.int32)
    new = spec.refill_superstep_state(
        state, state.carry, torch.zeros(2, dtype=torch.int32),
        torch.tensor([5, 5], dtype=torch.int32), mask, src)
    assert new.cap_count.tolist() == [int(state.cap_count[0]), 0]
    assert torch.equal(new.cap_feats, feats) and torch.equal(new.cap_toks,
                                                             toks)


def _np_tree(d):
    """JAX arrays of their own (not aliasing the tensors, which the port's
    re-seed rewrites in place)."""
    return {k: jnp.asarray(v.numpy().copy()) for k, v in d.items()}


@pytest.mark.parametrize("block", [0, 4], ids=["one_pass", "blocks"])
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_reseed_matches_jax(tiny, paged, block):
    """The port's re-seed and JAX's on the same draft cache, ring and new
    draft (draft B): every cache leaf within 2e-5 (paged: every pool page
    but the trash page, which takes the invalid columns' writes), in one
    pass as JAX computes it and in the engine's blocks of gamma + 1
    columns (the window of 24 in six)."""
    kw = dict(page_size=8) if paged else {}
    _, dcache, state = _port_drive(tiny, tiny["tdp"], 24, **kw)
    jcache = _np_tree(dcache)
    before = {leaf: dcache[leaf].clone().numpy() for leaf in ("k", "v")}
    ring = [jnp.asarray(x.numpy().copy()) for x in
            (state.cap_feats, state.cap_toks, state.cap_count)]
    emb = tiny["jp"]["embed"]
    if paged:
        want = jeagle.reseed_draft_rows_from_ring_paged(
            tiny["jdcfg"], tiny["jdp_b"], emb, jcache, *ring, 96)
        got = eagle.reseed_draft_rows_from_ring_paged(
            tiny["dcfg"], tiny["tdp_b"], tiny["tp"]["embed"], dcache,
            state.cap_feats, state.cap_toks, state.cap_count, 96,
            block=block)
    else:
        want = jeagle.reseed_draft_rows_from_ring(
            tiny["jdcfg"], tiny["jdp_b"], emb, jcache, *ring)
        got = eagle.reseed_draft_rows_from_ring(
            tiny["dcfg"], tiny["tdp_b"], tiny["tp"]["embed"], dcache,
            state.cap_feats, state.cap_toks, state.cap_count, block=block)
    moved = False
    for leaf in ("k", "v"):
        g, w, b = got[leaf].numpy(), np.asarray(want[leaf]), before[leaf]
        if paged:
            g, w, b = g[:-1], w[:-1], b[:-1]
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)
        moved |= bool(np.abs(g - b).max() > 1e-2)
    assert moved, "the re-seed changed nothing"
    for leaf in ("lengths", "pad"):
        assert np.array_equal(got[leaf].numpy(), np.asarray(want[leaf]))


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_reseed_idempotent_same_draft(tiny, paged):
    """tests/test_service.py: re-seeding with the serving draft leaves the
    draft cache bit for bit as it was (the engine's re-seed recomputes
    what serving computed, in products of serving's shapes)."""
    kw = dict(page_size=8) if paged else {}
    eng, dcache, state = _port_drive(tiny, tiny["tdp"], 16, **kw)
    assert int(state.cap_count.min()) > 0
    keep = {k: v.clone() for k, v in dcache.items()}
    out = eng._reseed_fn(eng.dparams, dcache, state)
    for leaf in ("k", "v"):
        a, b = out[leaf], keep[leaf]
        if paged:
            a, b = a[:-1], b[:-1]
        assert torch.equal(a, b), leaf


def test_one_pass_reseed_is_bitwise_on_the_cpu(tiny):
    """On the CPU the one-pass re-seed (JAX's shape: M = B·W) gives the
    blocked re-seed's rows bit for bit: the products at M = B(gamma+1)
    and B·W agree row for row here (on the card, in bf16, they do not)."""
    t = tiny
    _, dc, st = _port_drive(t, t["tdp"], 24)
    keep = {k: v.clone() for k, v in dc.items()}
    ring = (st.cap_feats, st.cap_toks, st.cap_count)
    one = eagle.reseed_draft_rows_from_ring(
        t["dcfg"], t["tdp_b"], t["tp"]["embed"], dc, *ring)
    blk = eagle.reseed_draft_rows_from_ring(
        t["dcfg"], t["tdp_b"], t["tp"]["embed"], keep, *ring, block=4)
    for leaf in ("k", "v"):
        assert torch.equal(one[leaf], blk[leaf]), leaf


def test_reseed_matches_new_draft_serving(tiny):
    """tests/test_service.py: after deploying draft B onto lanes served so
    far by draft A, the re-seeded window equals, position for position
    within 2e-5, the cache of an engine that served with B from the
    start, and moved away from A's."""
    t = tiny
    eng_a, dc_a, st_a = _port_drive(t, t["tdp"], 24)
    _, dc_b, _ = _port_drive(t, t["tdp_b"], 24)
    k_a = dc_a["k"].clone()
    out = eng_a._reseed_fn(t["tdp_b"], dc_a, st_a)
    n = torch.clamp(st_a.cap_count, max=24)
    assert (n > 0).all(), "capture ring never filled"
    changed = False
    for lane in range(2):
        lo = int(out["lengths"][lane] - n[lane])
        hi = int(min(out["lengths"][lane], dc_b["lengths"][lane]))
        assert hi > lo, "no overlapping re-seeded region to compare"
        for leaf in ("k", "v"):
            np.testing.assert_allclose(out[leaf][lane, lo:hi].numpy(),
                                       dc_b[leaf][lane, lo:hi].numpy(),
                                       rtol=TOL, atol=1e-5)
        changed |= bool((out["k"][lane, lo:hi]
                         - k_a[lane, lo:hi]).abs().max() > 1e-2)
    assert changed, "re-seed was a no-op (drafts differ, K/V must too)"


def test_paged_reseed_equals_dense_on_gathered_view(tiny):
    """The paged re-seed's rows equal the dense re-seed's on the gathered
    view bit for bit (and so does every row below the lengths), and no
    page leaks once the lanes are freed."""
    t = tiny
    eng_d, dc_d, st_d = _port_drive(t, t["tdp"], 24)
    eng_p, dc_p, st_p = _port_drive(t, t["tdp"], 24, page_size=8)
    assert torch.equal(st_d.cap_count, st_p.cap_count)
    dense = eng_d._reseed_fn(t["tdp_b"], dc_d, st_d)
    paged = eng_p._reseed_fn(t["tdp_b"], dc_p, st_p)
    assert torch.equal(dense["lengths"], paged["lengths"])
    for leaf in ("k", "v"):
        view = paging.gather_view(paged[leaf], paged["tbl"])
        for lane in range(2):
            hi = int(dense["lengths"][lane])
            assert torch.equal(view[lane, :hi], dense[leaf][lane, :hi]), \
                (leaf, lane)
    for lane in range(2):
        eng_p.allocator.free_lane(lane)
    eng_p.release_prefix_cache()
    eng_p.allocator.assert_clean()


class _AfterN:
    """A deploy source that publishes draft B from its n-th poll on."""

    def __init__(self, n, draft):
        self.n, self.polls, self.draft = n, 0, draft

    def __call__(self):
        self.polls += 1
        return (service.DraftVersion(1, self.draft, 0.9)
                if self.polls >= self.n else None)


@pytest.mark.parametrize("kw", [{}, dict(page_size=8), dict(tree_width=2)],
                         ids=["dense", "paged", "tree2"])
def test_reseed_deploy_stream_invariant(tiny, kw):
    """tests/test_service.py and tests/test_paged.py: a mid-stream deploy
    with re-seed leaves greedy streams as they were without one (the
    target verifies every draft), dense, paged and at tree width 2,
    while the engine records one deploy and one re-seed."""
    t = tiny
    cfg = dict(batch_size=2, max_len=96, superstep_rounds=8, **kw)
    ref = ServingEngine(t["cfg"], t["tp"], t["dcfg"], t["tdp"], device="cpu",
                        config=ServingConfig(**cfg))
    r_ref = _reqs(t, (40, 40), 4, Request)
    ref.serve_stream(iter(r_ref))
    eng = ServingEngine(t["cfg"], t["tp"], t["dcfg"], t["tdp"], device="cpu",
                        deploy_source=_AfterN(3, t["tdp_b"]),
                        config=ServingConfig(reseed_window=24, **cfg))
    r_new = _reqs(t, (40, 40), 4, Request)
    eng.serve_stream(iter(r_new))
    assert eng.stats.deploys == 1 and eng.stats.reseeds == 1
    assert eng.dparams is t["tdp_b"]
    assert [r.generated for r in r_new] == [r.generated for r in r_ref]
    if "page_size" in kw:
        eng.release_prefix_cache()
        eng.allocator.assert_clean()


# ============================================================ two threads
def test_launch_counter_loses_no_increment_across_threads():
    """Two threads adding to one launch counter (the serving and the
    training thread both launch the prefill forward) end at the exact
    sum, with the interpreter switching threads as often as it can."""
    import sys

    def fn():
        pass

    fn.launches = 0
    per = 20000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=lambda: [count(fn) for _ in range(per)])
              for _ in range(2)]
        for th in ts:
            th.start()
        for th in ts:
            th.join(timeout=JOIN_S)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in ts)
    assert fn.launches == 2 * per


def test_library_builds_once_from_two_threads(monkeypatch, tmp_path):
    """Two threads making a first launch at once build and load the kernel
    library once."""
    builds = []

    def fake_build():
        builds.append(threading.get_ident())
        time.sleep(0.2)
        return tmp_path / "lib.so"

    class FakeLib:
        def __init__(self, path):
            for name in kbuild._SIGNATURES:
                setattr(self, name, type("Fn", (), {})())

    monkeypatch.setattr(kbuild, "_LIB", None)
    monkeypatch.setattr(kbuild, "build", fake_build)
    monkeypatch.setattr(kbuild.ctypes, "CDLL", FakeLib)
    libs = []
    ts = [threading.Thread(target=lambda: libs.append(kbuild.library()))
          for _ in range(2)]
    for th in ts:
        th.start()
    for th in ts:
        th.join(timeout=JOIN_S)
    assert len(builds) == 1 and len(libs) == 2 and libs[0] is libs[1]
