"""Overload (lane spill and restore, deadline preemption, load shedding)
of the port held to the JAX engine on the CPU.

The units first, with no model: the shed and preemption policies, the
config wiring, the spill store, the allocator's ``spill_lane`` and the
scheduler's ``queue_view``/``peek_next``/``evict``/``shed`` against
JAX's.  Then tide_tiny with random weights (JAX's ``T.init`` at key 0
and ``draft_init`` at key 7, as tests/test_overload.py), bridged as
numpy arrays, batch 2, max_len 96, ``superstep_rounds`` 4, under the
round clock (``eng._clock = lambda: float(eng.stats.steps)``), so that
arrivals, deadlines and stamps are rounds:

* JAX's traces (``_BURST``, the idle trace, the in-flight drop, the
  expired and queue-depth sheds): streams equal to the JAX engine's
  under the same config (greedy: or departing at a near-tie of the
  target's top-2 logits; sampled, seed 5: token for token), and the
  preemption, restore, shed and eviction counts and every request's
  admit, first-token and finish rounds equal to JAX's exactly.
* Each spill's slices against JAX's ``_spill_fn`` output for the same
  lane at the same boundary, on the lane's valid rows, within fp32
  2e-5 (integers exactly).
* Inside the port: preempt-on streams equal preempt-off streams exactly
  (greedy and sampled, dense and paged at 12 pages), the allocator clean
  after each serve; a spill is a copy (spill lane 0, refill lane 0,
  restore into lane 1: the rows as they were at the spill); the capture
  ring survives a spill; a lane mid-chunk-pipeline is never a victim;
  the traced serve's spans and notes are JAX's.
* One intended departure: a victim's lane is inert from its spill to
  its new owner's refill or commit.  The JAX engine leaves it active, so
  under chunked refill its tight requests' streams take the victims'
  tokens (ROADMAP, Reference state); the port's equal its unpreempted
  streams there too.

Fixed seeds, no hypothesis."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import repro.configs as C  # noqa: E402
from repro.checkpoint.ckpt import _flatten  # noqa: E402
from repro.core import eagle as jeagle  # noqa: E402
from repro.core import paging as jpaging  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.obs.recorder import NULL_RECORDER  # noqa: E402
from repro.obs.recorder import FlightRecorder as JaxRecorder  # noqa: E402
from repro.obs.trace import NULL_TRACER  # noqa: E402
from repro.obs.trace import Tracer as JaxTracer  # noqa: E402
from repro.serving import policy as jpolicy  # noqa: E402
from repro.serving.engine import ServingEngine as JaxEngine  # noqa: E402
from repro.serving.request import Request as JaxRequest  # noqa: E402
from repro.serving.scheduler import Scheduler as JaxScheduler  # noqa: E402
from repro_torch.checkpoint import bridge  # noqa: E402
from repro_torch.configs import get  # noqa: E402
from repro_torch.core import eagle, paging  # noqa: E402
from repro_torch.core import speculative as spec  # noqa: E402
from repro_torch.obs.recorder import FlightRecorder  # noqa: E402
from repro_torch.obs.trace import Tracer  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from repro_torch.serving import policy as ppolicy  # noqa: E402
from repro_torch.serving.policy import (  # noqa: E402
    DeadlinePreemption, ExpiredShed, PreemptionPolicy, QueueDepthShed,
    ServingConfig, ShedPolicy, WeightedEdfAdmission)
from repro_torch.serving.request import Request  # noqa: E402
from repro_torch.serving.scheduler import Scheduler  # noqa: E402
from test_torch_paging import _assert_streams_match  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)
_CONF = dict(batch_size=2, max_len=96, gamma=3, seed=5,
             superstep_rounds=4, idle_wait_s=0.0005)
_EDF = dict(admission="deadline", admission_lookahead=4, gate_arrivals=True)
# tests/test_overload.py's traces, rows of (arrives_at, deadline, budget):
# a loose pair resident from round 0, a tight burst at round 10 while the
# pair is mid-decode, one loose tail
_BURST = [(0.0, 1000.0, 60), (0.0, 1001.0, 60),
          (10.0, 40.0, 8), (10.0, 41.0, 8), (0.0, 1004.0, 10)]
_IDLE = [(0.0, 1000.0, 8), (0.0, 1001.0, 8), (0.0, 1002.0, 6)]
_INFLIGHT = [(0.0, 1000.0, 10), (0.0, 1001.0, 10),
             (2.0, 30.0, 8), (2.0, 31.0, 8)]
_EXPIRED = [(0.0, 1000.0, 30), (0.0, 1001.0, 30), (2.0, 4.0, 8),
            (0.0, 1002.0, 8)]
_QUEUE = ([(0.0, 1000.0, 24), (0.0, 1001.0, 24)]
          + [(4.0, 500.0 + i, 6) for i in range(6)])
# _INFLIGHT with budget-6 victims: both finish in the superstep in flight
# at their spill, so both spill entries are dropped, never restored
_INFLIGHT_DROP = [(0.0, 1000.0, 6), (0.0, 1001.0, 6),
                  (2.0, 30.0, 8), (2.0, 31.0, 8)]
# served with 30-token prompts under chunked refill (chunk 8): the tight
# pair's pipelines take the victims' lanes
_CHUNKED = [(0.0, 1000.0, 40), (0.0, 1001.0, 40), (6.0, 30.0, 6),
            (6.0, 31.0, 6), (0.0, 1004.0, 6)]


# ============================================== units (no model, no kernel)
def test_weighted_edf_ordering():
    pol = WeightedEdfAdmission(weight=10.0)
    a = Request(prompt=[1], deadline=20.0, priority=0)
    b = Request(prompt=[1], deadline=25.0, priority=1)
    c = Request(prompt=[1], deadline=None, priority=5)
    assert pol.select([a, b, c], 0.0) == 1
    assert pol.select([a, c], 0.0) == 0
    assert WeightedEdfAdmission(weight=0.0).select([a, b], 0.0) == 0


def _victim_cases(cls):
    cand = cls(prompt=[1], deadline=5.0)
    r1 = cls(prompt=[1], deadline=100.0)
    r2 = cls(prompt=[1], deadline=900.0)
    r3 = cls(prompt=[1], deadline=None)
    tight = cls(prompt=[1], deadline=4.0)
    capped = cls(prompt=[1], deadline=950.0)
    capped.evictions = 2
    once = cls(prompt=[1], deadline=950.0)
    once.evictions = 1
    return [(cand, [(0, r1), (1, r2), (2, r3)]), (cand, [(0, r1), (1, r2)]),
            (cls(prompt=[1]), [(0, r2)]), (cand, [(0, tight)]),
            (cand, [(0, capped)]), (cand, [(0, r1), (1, capped)]),
            (cand, [(0, once)])]


def test_preemption_policy_selects_loosest_victim_as_jax():
    """JAX's units (the loosest victim, no deadline never evicts, no
    looser resident, the margin, the eviction cap), each answer equal to
    JAX's policy on the same inputs."""
    pol = DeadlinePreemption()
    got = [pol.select_victim(c, rs, 0) for c, rs in _victim_cases(Request)]
    want = [jpolicy.DeadlinePreemption().select_victim(c, rs, 0)
            for c, rs in _victim_cases(JaxRequest)]
    assert got == want == [2, 1, None, None, None, 0, 0]
    cand, rs = _victim_cases(Request)[1]
    assert DeadlinePreemption(margin=1000.0).select_victim(cand, rs, 0) \
        is None
    assert PreemptionPolicy().select_victim(cand, rs, 0) is None
    assert DeadlinePreemption().enabled and not PreemptionPolicy().enabled


def test_shed_policy_units_as_jax():
    now = 50.0

    def picks(mod, cls):
        live = cls(prompt=[1], deadline=90.0)
        dead = cls(prompt=[1], deadline=10.0)
        none = cls(prompt=[1])
        q = [cls(prompt=[1], deadline=float(d)) for d in (5, 99, 40)]
        qs = [live, dead, none]
        idx = {id(r): i for i, r in enumerate(qs)}
        qidx = {id(r): i for i, r in enumerate(q)}
        return ([idx[id(r)] for r in mod.ExpiredShed().pick(qs, now)],
                mod.PreemptionPolicy().shed.pick([dead], now),
                [qidx[id(r)] for r in mod.QueueDepthShed(depth=2).pick(q,
                                                                      now)],
                mod.QueueDepthShed(depth=8).pick(q, now),
                mod.QueueDepthShed(depth=0).depth)

    assert picks(ppolicy, Request) == picks(jpolicy, JaxRequest) == \
        ([1], [], [1], [], 1)
    assert ShedPolicy.name == "none" and ExpiredShed.name == "expired" \
        and QueueDepthShed.name == "queue"


def test_config_make_policy_overload_wiring():
    cfg = ServingConfig(preempt="deadline", shed="queue",
                        shed_queue_depth=7)
    pol = cfg.make_policy()
    assert isinstance(pol.preemption, DeadlinePreemption)
    assert isinstance(pol.preemption.shed, QueueDepthShed)
    assert pol.preemption.shed.depth == 7
    base = ServingConfig().make_policy()
    assert type(base.preemption) is PreemptionPolicy
    assert not base.preemption.enabled
    rt = dataclasses.replace(cfg, preempt="none", shed="none")
    assert not rt.make_policy().preemption.enabled
    # the tables name JAX's policies, with JAX's defaults
    for table in ("PREEMPT_POLICIES", "SHED_POLICIES"):
        got, want = getattr(ppolicy, table), getattr(jpolicy, table)
        assert {k: v.__name__ for k, v in got.items()} == \
            {k: v.__name__ for k, v in want.items()}
    for preempt in ("none", "deadline"):
        for shed in ("none", "expired", "queue"):
            a = ServingConfig(preempt=preempt, shed=shed).make_policy()
            b = jpolicy.ServingConfig(preempt=preempt,
                                      shed=shed).make_policy()
            for x, y in ((a.preemption, b.preemption),
                         (a.preemption.shed, b.preemption.shed)):
                assert (x.name, getattr(x, "max_evictions", None),
                        getattr(x, "margin", None),
                        getattr(x, "depth", None)) == \
                    (y.name, getattr(y, "max_evictions", None),
                     getattr(y, "margin", None), getattr(y, "depth", None))


def test_spill_store_units():
    store = paging.SpillStore()
    assert not store and len(store) == 0
    r1, r2 = Request(prompt=[1]), Request(prompt=[2])
    store.put(paging.SpilledLane(r1, {"x": 1}, 3))
    store.put(paging.SpilledLane(r2, {"x": 2}, 0))
    with pytest.raises(AssertionError):
        store.put(paging.SpilledLane(r1, {}, 0))     # double spill
    assert [e.request for e in store.pending()] == [r1, r2]
    e = store.pop(r1.rid)
    assert e.pages == 3 and store.restores == 1
    store.drop(r2.rid)
    assert store.dropped == 1 and not store
    assert store.spills == 2


def test_allocator_spill_lane_accounting_as_jax():
    for mod in (paging, jpaging):
        a = mod.PageAllocator(16, 8, 4, 64)
        assert a.reserve(0, 20)                       # 3 pages
        assert a.lane_pages(0) == 3
        assert a.spill_lane(0) == 3
        assert a.spilled_pages == 3
        assert a.lane_pages(0) == 0 and a.pages_in_use == 0
        a.assert_clean()
        a.reset()
        assert a.spilled_pages == 0
    from repro_torch.obs.metrics import MetricsRegistry
    reg = MetricsRegistry()
    a = paging.PageAllocator(16, 8, 4, 64)
    a.register_metrics(reg)
    a.reserve(1, 9)
    a.spill_lane(1)
    assert reg.snapshot()["paging.spilled_pages"] == 2


def _sched_trace(cls, tracer):
    """An EDF scheduler with two residents (the tightest deadlines) and
    three queued requests, one of them without a deadline."""
    reqs = [cls(prompt=[1], max_new_tokens=4, deadline=d)
            for d in (50.0, 1.0, 3.0, 2.0, None)]
    sched_cls, mod = ((Scheduler, ppolicy) if cls is Request
                      else (JaxScheduler, jpolicy))
    sched = sched_cls(2, iter(reqs), policy=mod.DeadlineAdmission(
        lookahead=8), tracer=tracer)
    admitted = sched.admit()
    return reqs, sched, admitted


def test_scheduler_overload_methods_equal_jax():
    """``queue_view``, ``peek_next``, ``evict`` and ``shed`` on the same
    queue give JAX's answers, instants and slots."""
    out = []
    for cls, tr in ((Request, Tracer()), (JaxRequest, JaxTracer())):
        reqs, sched, admitted = _sched_trace(cls, tr)
        idx = {id(r): i for i, r in enumerate(reqs)}
        view = [idx[id(r)] for r in sched.queue_view()]
        head = idx[id(sched.peek_next())]
        assert head == idx[id(sched.peek_next())]      # peek never pops
        ev = sched.evict(0)
        with pytest.raises(AssertionError, match="empty slot"):
            sched.evict(0)
        dead = [r for r in sched.queue_view() if r.deadline == 3.0]
        assert len(dead) == 1
        for r in dead:
            r.finish(0.0)
        sched.shed(dead)
        sched.shed([])
        again = [idx[id(r)] for r in sched.queue_view()]
        slots = [None if r is None else idx[id(r)] for r in sched.slots]
        events = [(e[0], e[1], {k: v for k, v in e[5].items()
                                if k not in ("rid", "rids")})
                  for e in tr.events()]
        out.append(dict(admitted=[(s, idx[id(r)]) for s, r in admitted],
                        view=view, head=head, evicted=idx[id(ev)],
                        again=again, slots=slots,
                        completed=[idx[id(r)] for r in sched.completed],
                        events=events))
    assert out[0] == out[1]
    assert out[0]["admitted"] == [(0, 1), (1, 3)]
    assert out[0]["view"] == [0, 2, 4] and out[0]["head"] == 2
    assert out[0]["again"] == [0, 4] and out[0]["completed"] == [2]
    assert out[0]["slots"] == [None, 3] and out[0]["evicted"] == 1
    assert [e[1] for e in out[0]["events"]
            if e[1] in ("sched.evict", "sched.shed")] == \
        ["sched.evict", "sched.shed"]


# ============================================================ engine tests
@pytest.fixture(scope="module")
def model():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    jcfg = C.get("tide-tiny")
    jp = JT.init(jcfg, jax.random.key(0))
    jdcfg = jeagle.draft_config(jcfg)
    jdp = jeagle.draft_init(jdcfg, jax.random.key(7))
    cfg = get("tide-tiny")
    dcfg = eagle.draft_config(cfg)
    tp = bridge.target_from_numpy(cfg, _flatten(jp), device="cpu")
    tdp = bridge.draft_from_numpy(dcfg, _flatten(jdp), device="cpu")
    yield dict(jcfg=jcfg, jp=jp, jdcfg=jdcfg, jdp=jdp, cfg=cfg, dcfg=dcfg,
               tp=tp, tdp=tdp)
    torch.set_num_threads(threads)


_JAX_ENGINES = {}


def teardown_module():
    _JAX_ENGINES.clear()


def _jax_engine(m, **kw):
    key = tuple(sorted(kw.items()))
    eng = _JAX_ENGINES.get(key)
    if eng is None:
        eng = _JAX_ENGINES[key] = JaxEngine(
            m["jcfg"], m["jp"], m["jdcfg"], m["jdp"],
            config=jpolicy.ServingConfig(**dict(_CONF, **kw)))
    eng.reset_adaptation(m["jdp"])
    eng.deploy_source = None
    return eng


def _port_engine(m, **kw):
    return ServingEngine(m["cfg"], m["tp"], m["dcfg"], m["tdp"],
                         config=ServingConfig(**dict(_CONF, **kw)),
                         device="cpu")


def _trace(cls, spec, seed=3, plen=6, sids=True):
    """Gated requests from (arrives_at, deadline, budget) rows, sids set
    in creation order (sampled streams are then per-request; the engine
    opens a request's flight-recorder timeline only when it assigns the
    sid)."""
    rng = np.random.default_rng(seed)
    out = []
    for i, (a, d, b) in enumerate(spec):
        r = cls(prompt=[int(t) for t in rng.integers(1, 512, plen)],
                max_new_tokens=b, deadline=d)
        r.arrives_at = a
        r.sid = i if sids else None
        out.append(r)
    return out


def _serve(eng, cls, spec, **kw):
    """Serve ``spec`` under the round clock; the allocator must be
    clean afterwards.  Returns (requests, completed)."""
    eng._clock = lambda: float(eng.stats.steps)
    reqs = _trace(cls, spec, **kw)
    done = eng.serve_stream(list(reqs))
    if eng.allocator is not None:
        eng.release_prefix_cache()
        eng.allocator.assert_clean()
    return reqs, done


def _summary(eng, reqs):
    """What must equal JAX's exactly."""
    s = eng.stats
    return dict(preemptions=s.preemptions, restores=s.restores,
                shed=s.shed_requests, completed=s.completed,
                steps=s.steps, spilled=len(eng._spills),
                dropped=eng._spills.dropped,
                spilled_pages=(eng.allocator.spilled_pages
                               if eng.allocator is not None else 0),
                requests=[(r.evictions, r.shed, r.admit_round,
                           r.first_token_round, r.finish_round)
                          for r in reqs])


def _streams(reqs):
    return [list(r.generated) for r in reqs]


def _prompts(cls, spec):
    return [r.prompt for r in _trace(cls, spec)]


def _hits(reqs):
    return sum(r.finish_round is not None and r.finish_round <= r.deadline
               for r in reqs if r.deadline < 100)


def test_preempt_requires_superstep_mode(model):
    with pytest.raises(ValueError, match="superstep"):
        _port_engine(model, superstep_rounds=0, preempt="deadline")
    # shedding alone runs in the stepwise loop, as in JAX
    eng = _port_engine(model, superstep_rounds=0, shed="expired", **_EDF)
    reqs, _ = _serve(eng, Request, _EXPIRED)
    assert eng.stats.shed_requests == 1 and [r.sid for r in reqs
                                             if r.shed] == [2]


def test_preempt_on_idle_trace_changes_nothing(model):
    """A trace that never overloads: preempt-on gives preempt-off's
    streams, round stamps, dispatches and host syncs exactly."""
    base = _port_engine(model, **_EDF)
    a, _ = _serve(base, Request, _IDLE)
    eng = _port_engine(model, preempt="deadline", **_EDF)
    b, _ = _serve(eng, Request, _IDLE)
    assert eng.stats.preemptions == 0 and eng.stats.restores == 0
    assert _summary(eng, b) == _summary(base, a)
    assert _streams(b) == _streams(a)
    assert (eng.host_syncs, eng.stats.dispatches) == \
        (base.host_syncs, base.stats.dispatches)


@pytest.mark.parametrize("page_size", [0, 16], ids=["dense", "paged"])
def test_preempt_restore_equals_jax(model, page_size):
    """``_BURST``: the tight pair preempts both loose residents, which
    restore mid-stream.  Streams equal JAX's (near-tie rule) and the port's
    preempt-off serve's exactly; counts and round stamps equal JAX's
    exactly; every spill's slices equal JAX's within 2e-5 on the valid
    rows; the burst's two deadlines are hit."""
    m = model
    kw = dict(_EDF, page_size=page_size, num_pages=12 if page_size else 0)
    jeng = _jax_engine(m, preempt="deadline", **kw)
    jspills, jfn = [], jeng._spill_fn

    def jrec(cache, dcache, state, max_new, lane):
        out = jfn(cache, dcache, state, max_new, lane)
        jspills.append((int(lane), jax.tree.map(np.asarray, out)))
        return out
    jeng._spill_fn = jrec
    try:
        jreqs, _ = _serve(jeng, JaxRequest, _BURST)
    finally:
        jeng._spill_fn = jfn
    eng = _port_engine(m, preempt="deadline", **kw)
    pspills, pfn = [], eng._spill

    def prec(cache, dcache, state, max_new, lane):
        out = pfn(cache, dcache, state, max_new, lane)
        pspills.append((lane, out))
        return out
    eng._spill = prec
    reqs, _ = _serve(eng, Request, _BURST)
    _assert_streams_match(m, _prompts(Request, _BURST), _streams(reqs),
                          _streams(jreqs))
    assert _summary(eng, reqs) == _summary(jeng, jreqs)
    assert eng.stats.preemptions == 2 and eng.stats.restores == 2
    assert sum(r.evictions for r in reqs) == eng.stats.preemptions
    assert _hits(reqs) == 2
    if page_size:
        assert eng.allocator.spilled_pages > 0
    off = _port_engine(m, **kw)
    base, _ = _serve(off, Request, _BURST)
    assert _streams(reqs) == _streams(base)
    assert _hits(base) <= _hits(reqs)
    # the spills' slices against JAX's, lane by lane
    assert [lane for lane, _ in pspills] == [lane for lane, _ in jspills]
    for (_, got), (_, want) in zip(pspills, jspills):
        _assert_slices_close(got, want)


def _assert_slices_close(got, want):
    for k in ("clen", "cpad", "dlen", "dpad", "budget"):
        assert int(got[k]) == int(want[k]), k
    cpad, clen = int(got["cpad"]), int(got["clen"])
    dpad, dlen = int(got["dpad"]), int(got["dlen"])
    assert clen > cpad and dlen > dpad
    for (g, pos, leaf), t in got["cache"].items():
        w = want["cache"][g][pos][leaf]
        assert t.shape == w.shape, (g, pos, leaf)
        np.testing.assert_allclose(t[:, cpad:clen].double().numpy(),
                                   np.asarray(w[:, cpad:clen], np.float64),
                                   **TOL, err_msg=f"{g}/{pos}/{leaf}")
    for leaf in ("dk", "dv"):
        assert got[leaf].shape == want[leaf].shape
        np.testing.assert_allclose(got[leaf][dpad:dlen].double().numpy(),
                                   np.asarray(want[leaf][dpad:dlen],
                                              np.float64), **TOL)
    st, ws = got["state"], want["state"]
    assert set(st) == set(ws)
    for k, v in st.items():
        if v.dtype.is_floating_point:
            np.testing.assert_allclose(v.double().numpy(),
                                       np.asarray(ws[k], np.float64), **TOL)
        else:
            np.testing.assert_array_equal(v.numpy(), np.asarray(ws[k]))


@pytest.mark.parametrize("page_size", [0, 16], ids=["dense", "paged"])
def test_sampled_preempt_restore(model, page_size):
    """Seed 5: keys are ``fold_in(fold_in(base, sid), step_idx)``, and
    both travel with the spilled lane, so the preempted streams equal the
    port's preempt-off ones and JAX's preempted ones token for token."""
    m = model
    kw = dict(_EDF, greedy=False, page_size=page_size,
              num_pages=12 if page_size else 0)
    eng = _port_engine(m, preempt="deadline", **kw)
    reqs, _ = _serve(eng, Request, _BURST)
    assert eng.stats.preemptions >= 1 and eng.stats.restores >= 1
    base, _ = _serve(_port_engine(m, **kw), Request, _BURST)
    assert _streams(reqs) == _streams(base)
    if not page_size:
        jeng = _jax_engine(m, preempt="deadline", **kw)
        jreqs, _ = _serve(jeng, JaxRequest, _BURST)
        assert _streams(reqs) == _streams(jreqs)
        assert _summary(eng, reqs) == _summary(jeng, jreqs)


@pytest.mark.parametrize("trace", [_INFLIGHT, _INFLIGHT_DROP],
                         ids=["jax_trace", "dropped"])
def test_victim_finishing_in_flight_is_dropped(model, trace):
    """A victim whose last tokens were in flight at the spill finishes
    from that superstep's telemetry: its entry is dropped, never
    restored, and it completes once; as in JAX."""
    m = model
    jeng = _jax_engine(m, preempt="deadline", **_EDF)
    jreqs, _ = _serve(jeng, JaxRequest, trace)
    eng = _port_engine(m, preempt="deadline", **_EDF)
    reqs, done = _serve(eng, Request, trace)
    assert sorted(r.rid for r in done) == sorted(r.rid for r in reqs)
    assert len(done) == len(reqs) == eng.stats.completed
    assert all(len(r.generated) == r.max_new_tokens for r in reqs)
    assert _summary(eng, reqs) == _summary(jeng, jreqs)
    assert eng.stats.restores + eng._spills.dropped == \
        eng.stats.preemptions
    if trace is _INFLIGHT_DROP:
        assert eng._spills.dropped == eng.stats.preemptions == 2
    _assert_streams_match(m, _prompts(Request, trace), _streams(reqs),
                          _streams(jreqs))


def test_expired_shed_equals_jax(model):
    """The request whose deadline passes in the queue is shed (flag,
    counter, empty stream, finished, completed once); the survivors'
    streams equal the unshed serve's and JAX's."""
    m = model
    jeng = _jax_engine(m, shed="expired", **_EDF)
    jreqs, _ = _serve(jeng, JaxRequest, _EXPIRED)
    eng = _port_engine(m, shed="expired", **_EDF)
    reqs, done = _serve(eng, Request, _EXPIRED)
    assert eng.stats.shed_requests == 1
    shed = [r for r in reqs if r.shed]
    assert [r.sid for r in shed] == [2]
    assert shed[0].generated == [] and shed[0].finish_round is not None
    assert len(done) == len(reqs)
    assert _summary(eng, reqs) == _summary(jeng, jreqs)
    _assert_streams_match(m, _prompts(Request, _EXPIRED), _streams(reqs),
                          _streams(jreqs))
    base, _ = _serve(_port_engine(m, **_EDF), Request, _EXPIRED)
    for rb, ra in zip(reqs, base):
        if not rb.shed:
            assert rb.generated == ra.generated


def test_queue_depth_shed_equals_jax(model):
    m = model
    kw = dict(_EDF, admission_lookahead=8, shed="queue", shed_queue_depth=2)
    jeng = _jax_engine(m, **kw)
    jreqs, _ = _serve(jeng, JaxRequest, _QUEUE)
    eng = _port_engine(m, **kw)
    reqs, done = _serve(eng, Request, _QUEUE)
    assert eng.stats.shed_requests > 0 and len(done) == len(reqs)
    shed = sorted(r.deadline for r in reqs if r.shed)
    kept = sorted(r.deadline for r in reqs if not r.shed and r.sid >= 2)
    assert not kept or not shed or min(shed) >= max(kept)
    assert _summary(eng, reqs) == _summary(jeng, jreqs)
    _assert_streams_match(m, _prompts(Request, _QUEUE), _streams(reqs),
                          _streams(jreqs))


def test_overload_metrics_and_trace_equal_jax(model):
    """The burst, traced and recorded: JAX's spans and instants
    (``preempt.spill``, ``sched.evict``, ``preempt.restore``, ...) with
    their arguments in JAX's order, each request's timeline (its
    ``preempt`` and ``restore`` notes), and the ``serving.*`` and
    ``paging.*`` overload metrics (dense: a zero ``spilled_pages``)."""
    m = model
    jeng = _jax_engine(m, preempt="deadline", **_EDF)
    jeng.tracer, jeng.recorder = JaxTracer(), JaxRecorder()
    try:
        jreqs, _ = _serve(jeng, JaxRequest, _BURST, sids=False)
        want_tr, want_rec = jeng.tracer.events(), jeng.recorder.timelines()
    finally:
        jeng.tracer, jeng.recorder = NULL_TRACER, NULL_RECORDER
    eng = _port_engine(m, preempt="deadline", **_EDF)
    eng.tracer, eng.recorder = Tracer(), FlightRecorder()
    reqs, _ = _serve(eng, Request, _BURST, sids=False)

    def spans(events, rs):
        idx = {r.rid: i for i, r in enumerate(rs)}
        return [(e[0], e[1], {k: ([idx[x] for x in v] if k == "rids" else
                                  idx[v] if k == "rid" else v)
                              for k, v in e[5].items()}) for e in events]

    def timelines(tls):
        return [[{k: v for k, v in ev.items() if k != "t"}
                 for ev in tl["events"]] for tl in tls]

    got = spans(eng.tracer.events(), reqs)
    assert got == spans(want_tr, jreqs)
    names = [e[1] for e in got]
    for name in ("preempt.spill", "preempt.restore", "sched.evict"):
        assert name in names
    tls = timelines(eng.recorder.timelines())
    assert tls == timelines(want_rec)
    kinds = [ev["kind"] for tl in tls for ev in tl]
    assert kinds.count("preempt") == kinds.count("restore") == 2
    snap = eng.metrics.snapshot()
    assert snap["serving.preemptions"] == eng.stats.preemptions == 2
    assert snap["serving.restores"] == eng.stats.restores == 2
    assert snap["serving.shed_requests"] == 0
    assert snap["serving.spilled_requests"] == 0
    assert snap["paging.spilled_pages"] == 0


# ======================================================== inside the port
def _live_state(eng, prompts, budgets):
    """A dense or paged engine's live state after its prologue and one
    superstep on ``prompts`` (one a lane)."""
    reqs = [Request(prompt=list(p), max_new_tokens=b)
            for p, b in zip(prompts, budgets)]
    eng._assign_sids(list(enumerate(reqs)))
    cache, dcache, carry, first = eng._prologue(reqs)
    state = spec.init_superstep_state(
        carry, first, eng._base_key, eos_id=None,
        sids=torch.as_tensor(eng._slot_sids(reqs)),
        capture_window=eng.reseed_window)
    max_new = torch.as_tensor(budgets, dtype=torch.int32)
    out = eng._superstep(*eng._ship_tables(cache, dcache), state, max_new,
                         None)
    return out["cache"], out["dcache"], out["state"], max_new


def _lane_view(eng, cache, dcache, state, max_new, lane):
    """Every per-lane tensor of the live state, cloned, in ``_spill``'s
    layout but built apart from it (a paged lane's rows gathered through
    its host table row)."""
    def take(t):
        return t[lane].clone()
    if eng.paged:
        row = torch.as_tensor(eng.allocator.table[lane:lane + 1])

        def rows(t):
            return paging.gather_view(t, row)[0]
        tgt = {(g, p, leaf): torch.stack([rows(x) for x in t])
               for g, p, leaf, t in eng._cache_leaves(cache)}
        dk, dv = rows(dcache["k"]), rows(dcache["v"])
    else:
        tgt = {(g, p, leaf): t[:, lane].clone()
               for g, p, leaf, t in eng._cache_leaves(cache)}
        dk, dv = take(dcache["k"]), take(dcache["v"])
    st = {k: take(getattr(state.carry, k))
          for k in ("feats", "tokens", "advance")}
    names = ("active", "gen_count", "sid", "step_idx")
    if state.cap_feats is not None:
        names += ("cap_feats", "cap_toks", "cap_count")
    st.update({k: take(getattr(state, k)) for k in names})
    return {"cache": tgt, "clen": take(cache["lengths"]),
            "cpad": take(cache["pad"]), "dk": dk, "dv": dv,
            "dlen": take(dcache["lengths"]), "dpad": take(dcache["pad"]),
            "state": st, "budget": take(max_new)}


def _equal(a, b):
    if torch.is_tensor(a):
        return torch.equal(a, b)
    return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("page_size", [0, 8], ids=["dense", "paged"])
@pytest.mark.parametrize("window", [0, 8], ids=["no_ring", "ring"])
def test_spill_is_a_copy(model, page_size, window):
    """Spill lane 0, refill lane 0 with another prompt (in place), then
    restore into lane 1: lane 1 holds lane 0's rows as they were at the
    spill, bit for bit, and so does the snapshot; with ``reseed_window``
    the capture ring comes back with them."""
    m = model
    eng = _port_engine(m, page_size=page_size, reseed_window=window)
    rng = np.random.default_rng(11)
    prompts = [[int(t) for t in rng.integers(1, 512, n)] for n in (13, 6)]
    cache, dcache, state, max_new = _live_state(eng, prompts, [20, 20])
    if window:
        assert int(state.cap_count[0]) > 0
    before = _lane_view(eng, cache, dcache, state, max_new, 0)
    snap = eng._spill(cache, dcache, state, max_new, 0)
    assert _equal(snap, before)
    pages = eng.allocator.lane_pages(0) if page_size else 0
    new = Request(prompt=[int(t) for t in rng.integers(1, 512, 9)],
                  max_new_tokens=5)
    eng._assign_sids([(0, new)])
    if page_size:
        eng.allocator.spill_lane(0)
    args = eng._refill_arrays([(0, new)])
    cache, dcache, tbl_rows = eng._map_refill(cache, dcache, [(0, new)],
                                              *args[0].shape)
    cache, dcache, state, max_new, _ = eng._refill_superstep(
        cache, dcache, state, max_new, *args, tbl_rows=tbl_rows)
    assert not _equal(_lane_view(eng, cache, dcache, state, max_new, 0),
                      before)
    assert _equal(snap, before), "the refill changed the snapshot"
    if page_size:
        eng.allocator.free_lane(1)
        assert eng.allocator.reserve(1, pages * eng.page_size)
        cache, dcache = eng._ship_tables(cache, dcache)
    cache, dcache, state, max_new = eng._restore(cache, dcache, state,
                                                 max_new, 1, snap)
    after = _lane_view(eng, cache, dcache, state, max_new, 1)
    if page_size:
        # rows past the lanes' common reservation map the trash page
        n = pages * eng.page_size
        for d in (after, before):
            d["cache"] = {k: v[:, :n] for k, v in d["cache"].items()}
            d["dk"], d["dv"] = d["dk"][:n], d["dv"][:n]
    assert _equal(after, before)
    if window:
        assert torch.equal(state.cap_feats[1], before["state"]["cap_feats"])


def test_ring_and_spill_streams(model):
    """With the capture ring on, the burst's preempted streams equal the
    unpreempted ones, dense and paged."""
    m = model
    for page_size in (0, 16):
        kw = dict(_EDF, reseed_window=8, page_size=page_size,
                  num_pages=12 if page_size else 0)
        eng = _port_engine(m, preempt="deadline", **kw)
        reqs, _ = _serve(eng, Request, _BURST)
        assert eng.stats.preemptions >= 1
        base, _ = _serve(_port_engine(m, **kw), Request, _BURST)
        assert _streams(reqs) == _streams(base)


def test_pipeline_lane_is_never_a_victim(model):
    """With ``prefill_chunk``, a lane whose request sits in a chunk
    pipeline is never a preemption candidate, even with a first token
    stamped; and the chunked burst (long loose prompts, so the tight
    arrivals meet pipelines) serves the unpreempted streams."""
    m = model
    eng = _port_engine(m, preempt="deadline", prefill_chunk=8, **_EDF)
    a = Request(prompt=[1] * 20, max_new_tokens=8)
    b = Request(prompt=[2] * 5, max_new_tokens=8)
    a.first_token_t = b.first_token_t = 0.0
    a.sid, b.sid = 0, 1
    eng._pipelines = [eng._make_pipeline([(0, a)])]

    class _S:
        slots = [a, b]
    assert eng._victim_candidates(_S, set()) == [(1, b)]
    assert eng._victim_candidates(_S, {id(b)}) == []
    eng._pipelines = []

    seen = []
    pick = eng._victim_candidates

    def rec(sched, new_ids):
        out = pick(sched, new_ids)
        piped = {id(r) for pl in eng._pipelines for _, r in pl.admitted}
        assert not any(id(r) in piped for _, r in out)
        seen.append(len(out))
        return out
    eng._victim_candidates = rec
    reqs, _ = _serve(eng, Request, _CHUNKED, plen=30)
    assert eng.stats.preemptions >= 1 and seen
    base, _ = _serve(_port_engine(m, prefill_chunk=8, **_EDF), Request,
                     _CHUNKED, plen=30)
    assert _streams(reqs) == _streams(base)


def test_chunked_victim_lane_goes_inert(model):
    """A victim's lane is inert from its spill until its new owner's
    commit.  The JAX engine leaves it active: under chunked refill the
    lane goes on decoding the victim's stream while the new owner's
    pipeline prefills, and those tokens land in the new owner's stream
    (ROADMAP, Reference state).  The port's preempted chunked streams are
    its unpreempted ones; JAX's loose pair's are too, but its tight
    pair's are not, and each holds tokens of a victim's stream."""
    m = model
    eng = _port_engine(m, preempt="deadline", prefill_chunk=8, **_EDF)
    reqs, _ = _serve(eng, Request, _CHUNKED, plen=30)
    base, _ = _serve(_port_engine(m, prefill_chunk=8, **_EDF), Request,
                     _CHUNKED, plen=30)
    assert _streams(reqs) == _streams(base)
    jeng = _jax_engine(m, preempt="deadline", prefill_chunk=8, **_EDF)
    jreqs, _ = _serve(jeng, JaxRequest, _CHUNKED, plen=30)
    assert jeng.stats.preemptions == eng.stats.preemptions == 2
    want = _streams(base)
    got = _streams(jreqs)
    assert got[:2] == want[:2] and got[4] == want[4]
    for tight in got[2:4]:
        assert tight not in want[2:4]
        assert set(tight) <= set(want[0]) | set(want[1])


def test_engine_single_clock_domain(model):
    """Under an injected clock every stamp lives in its domain."""
    eng = _port_engine(model, gate_arrivals=True)
    tick = {"t": 1000.0}

    def fake():
        tick["t"] += 1.0
        return tick["t"]

    eng._clock = fake
    rng = np.random.default_rng(3)
    reqs = []
    for _ in range(3):
        r = Request(prompt=[int(t) for t in rng.integers(1, 512, 5)],
                    max_new_tokens=4)
        r.arrives_at = 0.0
        reqs.append(r)
    eng.serve_stream(list(reqs))
    for r in reqs:
        for stamp in (r.arrival_t, r.admit_t, r.first_token_t, r.finish_t):
            assert stamp is not None and 1000.0 < stamp < 2000.0
        assert r.ttft >= 0.0 and r.latency >= 0.0
    assert 0.0 < eng.stats.wall_s < 1000.0
