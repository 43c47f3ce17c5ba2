"""Chunked refill prefill of the port held to the JAX engine on the CPU.

tide_tiny with random weights (JAX's ``T.init`` at key 0 and
``draft_init`` at key 7, as tests/test_chunked_prefill.py), bridged as
numpy arrays; numpy-made requests go through both engines.

* Op level: one pipeline driven to its end (``_make_pipeline``, then
  ``_advance_pipeline`` until ``done``) at chunk 8 and 16 on ragged
  prompt widths: the staging target and draft caches on each lane's
  valid region, the last logits and the last capture within fp32
  rtol/atol 2e-5 of JAX's, the first token (greedy and sampled) equal.
  Inside the port the pipeline's staging also matches the one-shot
  prefill within that tolerance.
* Streams: greedy (dense cohort, dense eager, paged page 8 with prefix
  sharing, tree W 2) equal the JAX engine's, or depart only at a near-tie
  of the target's top-2 logits; sampled (seed 5) equal JAX's recorded
  stepwise engine off near-ties of its own draws (the rule of
  tests/test_torch_sampling.py).  The chunk counters equal JAX's for each
  serve: ``prefill_chunks``, ``prefill_lane_rounds``,
  ``prefill_row_tokens``, ``refills``, ``prefill_op_width`` max, the
  ``prefill_gap_tokens`` counts, ``prefix_hits`` and, for the commit
  policies, each request's first-token round less its admission round.
  Scheduling does not depend on the tokens (no EOS), so the counters
  must be equal even where a stream departs at a tie.  Traced and
  recorded, a chunked serve gives JAX's spans and request timelines.
* The port's own ladders, exactly (streams and SignalStore contents):
  chunked stepwise == superstep == stream == wave, paged == dense,
  cohort == eager.  Chunked against one-shot within the port: equal off
  near-ties (JAX's own chunked rungs are not bitwise either).
* JAX's cases: a zero budget admitted mid-chunk, EOS on the first token
  after a prefill, a deploy re-seed landing mid-prefill,
  ``refill_groups``' partition, the TTFT clock starting at admission.

Fixed seeds, no hypothesis."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import repro.configs as C  # noqa: E402
from repro.checkpoint.ckpt import _flatten  # noqa: E402
from repro.core import eagle as jeagle  # noqa: E402
from repro.core import speculative as jspec  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.obs.recorder import NULL_RECORDER  # noqa: E402
from repro.obs.recorder import FlightRecorder as JaxRecorder  # noqa: E402
from repro.obs.trace import NULL_TRACER  # noqa: E402
from repro.obs.trace import Tracer as JaxTracer  # noqa: E402
from repro.serving.engine import ServingEngine as JaxEngine  # noqa: E402
from repro.serving.policy import ServingConfig as JaxConfig  # noqa: E402
from repro.serving.request import Request as JaxRequest  # noqa: E402
from repro.serving.scheduler import Scheduler as JaxScheduler  # noqa: E402
from repro_torch.checkpoint import bridge  # noqa: E402
from repro_torch.configs import get  # noqa: E402
from repro_torch.core import eagle  # noqa: E402
from repro_torch.core import speculative as spec  # noqa: E402
from repro_torch.core.signals import SignalExtractor, SignalStore  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.obs.recorder import FlightRecorder  # noqa: E402
from repro_torch.obs.trace import Tracer  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from repro_torch.serving.policy import (CohortCommit, EagerCommit,  # noqa: E402
                                        ServingConfig)
from repro_torch.serving.request import Request  # noqa: E402
from repro_torch.serving.scheduler import Scheduler  # noqa: E402
from test_torch_paging import _assert_streams_match  # noqa: E402
from test_torch_sampling import (_assert_streams_match as  # noqa: E402
                                 _assert_sampled_match, _record)

TOL = dict(rtol=2e-5, atol=2e-5)
SEED = 5                       # the sampling tests' engine seed
BUDGETS = (5, 12, 7, 9, 11, 4, 8, 6)
LENS = (40, 9, 22, 13, 55, 8, 17, 30)   # < chunk, == chunk, multi-chunk
# requests 4-7 repeat prompts 0-3 (distinct width buckets, so every
# refill group has one row and its prefix keys match the prologue's)
SHARED_LENS = (40, 22, 30, 55)
SHARED_BUDGETS = (5, 12, 7, 9, 6, 8, 4, 10)
# tests/test_policy.py:205's scenario: two long-budget residents decode
# while a long and a short prompt are co-admitted mid-stream
POLICY_LENS = (6, 7, 5, 8, 72, 6, 9, 10)
POLICY_BUDGETS = (40, 40, 8, 8, 6, 6, 6, 6)


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


_CONF = dict(batch_size=4, max_len=96, gamma=3, seed=SEED)
_JAX_ENGINES = {}


def _jax_engine(m, **kw):
    """JAX engines shared across tests (their jit caches stay warm);
    ``reset_adaptation`` restores the post-construction state, the page
    registry included."""
    key = tuple(sorted(kw.items()))
    eng = _JAX_ENGINES.get(key)
    if eng is None:
        eng = _JAX_ENGINES[key] = JaxEngine(
            m["jcfg"], m["jp"], m["jdcfg"], m["jdp"],
            config=JaxConfig(**_CONF, **kw))
    eng.reset_adaptation(m["jdp"])
    eng.deploy_source = None
    return eng


def _port_engine(m, *, dparams=None, extractor=None, **kw):
    return ServingEngine(m["cfg"], m["tp"], m["dcfg"],
                         m["tdp"] if dparams is None else dparams,
                         config=ServingConfig(**_CONF, **kw), device="cpu",
                         extractor=extractor)


def _prompts(vocab, lens, seed=3):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(1, vocab, n)] for n in lens]


def _shared_prompts(vocab):
    base = _prompts(vocab, SHARED_LENS)
    return base + [list(p) for p in base]


def _requests(cls, prompts, budgets):
    return [cls(prompt=list(p), max_new_tokens=b)
            for p, b in zip(prompts, budgets)]


def _serve(eng, cls, prompts, budgets, wave=None):
    reqs = _requests(cls, prompts, budgets)
    if wave:
        for i in range(0, len(reqs), wave):
            eng.serve_wave(reqs[i:i + wave])
    else:
        eng.serve_stream(iter(reqs))
    assert all(r.finish_t is not None for r in reqs)
    return [list(r.generated) for r in reqs], reqs


def _counters(eng, reqs):
    s = eng.stats
    return dict(prefill_chunks=s.prefill_chunks,
                prefill_lane_rounds=s.prefill_lane_rounds,
                prefill_row_tokens=s.prefill_row_tokens,
                refills=s.refills,
                op_width_max=s.prefill_op_width.max,
                gap_n=s.prefill_gap_tokens.n,
                gap_total=s.prefill_gap_tokens.total,
                gap_max=s.prefill_gap_tokens.max,
                prefix_hits=s.prefix_hits,
                prefix_tokens_saved=s.prefix_tokens_saved,
                steps=s.steps, tokens_out=s.tokens_out,
                ttft_rounds=[r.first_token_round - r.admit_round
                             if r.first_token_round is not None else None
                             for r in reqs])


# ================================================================ op level
def _valid(x, pad, upto, seq_axis):
    """Per lane, the rows [pad, upto) of ``x`` along ``seq_axis`` (the
    lane axis just before it)."""
    a = np.asarray(x, np.float64)
    return [np.take(np.take(a, lane, axis=seq_axis - 1),
                    np.arange(int(pad[lane]), int(upto[lane])),
                    axis=seq_axis - 1)
            for lane in range(len(pad))]


def _assert_staging_close(got, want, pad, width, dlen):
    """Target K/V ((L, R, W, Hk, D) leaves) on [pad, width), draft K/V
    ((R, max_len, Hk, D)) on [pad, dlen)."""
    for leaf in ("k", "v"):
        for g, w in zip(_valid(got["cache"]["body"]["pos0"][leaf], pad,
                               [width] * len(pad), 2),
                        _valid(want["cache"]["body"]["pos0"][leaf], pad,
                               [width] * len(pad), 2)):
            np.testing.assert_allclose(g, w, **TOL, err_msg=f"target {leaf}")
        for g, w in zip(_valid(got["dcache"][leaf], pad, dlen, 1),
                        _valid(want["dcache"][leaf], pad, dlen, 1)):
            np.testing.assert_allclose(g, w, **TOL, err_msg=f"draft {leaf}")
    np.testing.assert_allclose(np.asarray(got["logits"], np.float64),
                               np.asarray(want["logits"], np.float64), **TOL)
    np.testing.assert_allclose(np.asarray(got["caps_last"], np.float64),
                               np.asarray(want["caps_last"], np.float64),
                               **TOL)


def _staging(pl):
    return dict(cache=pl.cache, dcache=pl.dcache, logits=pl.logits,
                caps_last=pl.caps_last)


@pytest.mark.parametrize("lens", [(40, 9, 22, 13), (55, 8, 17, 30)],
                         ids=["w40", "w56"])
@pytest.mark.parametrize("chunk", [8, 16])
def test_pipeline_staging_equals_jax(model, chunk, lens):
    """One pipeline to its end in both engines: the staging caches,
    logits and last capture within 2e-5, the lengths and both first
    tokens equal; the port's staging also within 2e-5 of its one-shot
    prefill and draft seed."""
    m = model
    prompts = _prompts(m["cfg"].vocab_size, lens)
    jreqs = _requests(JaxRequest, prompts, [8] * 4)
    preqs = _requests(Request, prompts, [8] * 4)
    for i, (a, b) in enumerate(zip(jreqs, preqs)):
        a.sid = b.sid = i
    jeng = _jax_engine(m, prefill_chunk=chunk)
    jpl = jeng._make_pipeline(list(enumerate(jreqs)))
    while not jpl.done:
        jeng._advance_pipeline(jpl)
    peng = _port_engine(m, prefill_chunk=chunk)
    ppl = peng._make_pipeline(list(enumerate(preqs)))
    n = 0
    while not ppl.done:
        peng._advance_pipeline(ppl)
        n += 1
    assert n == -(-ppl.width // chunk) and peng.stats.prefill_chunks == n
    assert ppl.width == jpl.width and ppl.first_width == jpl.first_width
    pad = ppl.pad.numpy()
    np.testing.assert_array_equal(pad, np.asarray(jpl.pad))
    dlen = ppl.dcache["lengths"].numpy()
    np.testing.assert_array_equal(dlen, np.asarray(jpl.dcache["lengths"]))
    np.testing.assert_array_equal(ppl.cache["lengths"].numpy(),
                                  np.asarray(jpl.cache["lengths"]))
    _assert_staging_close(_staging(ppl), _staging(jpl), pad, ppl.width, dlen)
    # first tokens: greedy argmax, and step 0 of each row's sampled stream
    np.testing.assert_array_equal(
        peng._pick(ppl.logits, ppl.sids).numpy(),
        np.asarray(jpl.logits.argmax(-1)))
    sampled = _port_engine(m, prefill_chunk=chunk, greedy=False)
    np.testing.assert_array_equal(
        sampled._pick(ppl.logits, ppl.sids).numpy(),
        np.asarray(jeng._pick_sampled_fn(jpl.logits, jpl.sids)))
    # inside the port: the one-shot prefill of the same padded batch
    pre = peng._prefill(ppl.toks, ppl.pad)
    rdc = eagle.seed_refill_cache(m["dcfg"], m["tdp"], m["tp"]["embed"],
                                  pre["captures"], ppl.toks, ppl.pad,
                                  peng.max_len)
    one = dict(cache=pre["cache"], dcache=rdc, logits=pre["logits"],
               caps_last=pre["captures"][:, -1])
    _assert_staging_close(_staging(ppl), one, pad, ppl.width, dlen)


def test_pad_target_cache(model):
    """The dense commit's pad equals JAX's ``pad_target_cache`` (on the
    valid rows; the left pad's rows are never read) and is zero past the
    staging width; paged (None) passes through; a staging cache wider
    than max_len raises."""
    m = model
    rng = np.random.default_rng(0)
    toks = rng.integers(1, m["cfg"].vocab_size, (2, 24)).astype(np.int32)
    pad = np.asarray([0, 5], np.int32)
    jpre = JT.prefill(m["jcfg"], m["jp"], jnp.asarray(toks), max_len=24,
                      pad=jnp.asarray(pad))
    want = jspec.pad_target_cache(jpre["cache"], JT.cache_abstract(
        m["jcfg"], 2, 96))
    ppre = T.prefill(m["cfg"], m["tp"], torch.as_tensor(toks), max_len=24,
                     pad=torch.as_tensor(pad))
    got = spec.pad_target_cache(ppre["cache"], 96)
    for leaf in ("k", "v"):
        g = got["body"]["pos0"][leaf].numpy()
        w = np.asarray(want["body"]["pos0"][leaf])
        assert g.shape == w.shape == (m["cfg"].num_layers, 2, 96,
                                      m["cfg"].num_kv_heads,
                                      m["cfg"].head_dim)
        for a, b in zip(_valid(g, pad, [24, 24], 2),
                        _valid(w, pad, [24, 24], 2)):
            np.testing.assert_allclose(a, b, **TOL)
        assert not g[:, :, 24:].any()
    assert spec.pad_target_cache(ppre["cache"], None) is ppre["cache"]
    with pytest.raises(ValueError, match="wider than max_len"):
        spec.pad_target_cache(ppre["cache"], 16)


def test_decode_step_linear_and_last_only(model):
    """``linear=`` reaches every product and ``last_only`` gives the
    last row of the full logits; the default keeps ``torch.matmul``."""
    m = model
    rng = np.random.default_rng(1)
    toks = torch.as_tensor(rng.integers(1, 512, (2, 16)), dtype=torch.int32)
    pre = T.prefill(m["cfg"], m["tp"], toks[:, :8], max_len=16)
    calls = []

    def counting(x, w):
        calls.append(x.shape[:-1])
        return x @ w

    full = T.decode_step(m["cfg"], m["tp"], dict(pre["cache"]), toks[:, 8:])
    last = T.decode_step(m["cfg"], m["tp"], dict(pre["cache"]), toks[:, 8:],
                         linear=counting, last_only=True)
    assert last["logits"].shape == (2, m["cfg"].vocab_size)
    np.testing.assert_allclose(last["logits"].numpy(),
                               full["logits"][:, -1].numpy(), **TOL)
    np.testing.assert_allclose(last["captures"].numpy(),
                               full["captures"].numpy(), **TOL)
    # q, k, v, o, gate, up, down per layer, and the head on one row
    assert len(calls) == 7 * m["cfg"].num_layers + 1
    assert calls[-1] == (2,)


# ================================================================= streams
def _greedy_case(m, kw, prompts, budgets):
    jeng = _jax_engine(m, **kw)
    want, jreqs = _serve(jeng, JaxRequest, prompts, budgets)
    jcount = _counters(jeng, jreqs)
    eng = _port_engine(m, **kw)
    got, preqs = _serve(eng, Request, prompts, budgets)
    _assert_streams_match(m, prompts, got, want)
    assert _counters(eng, preqs) == jcount
    return got, eng, jcount


@pytest.mark.parametrize("name,kw", [
    ("dense", dict(prefill_chunk=16)),
    ("tree2", dict(prefill_chunk=16, tree_width=2)),
])
def test_greedy_chunked_streams_equal_jax(model, name, kw):
    got, eng, count = _greedy_case(model, kw, _prompts(512, LENS), BUDGETS)
    assert [len(g) for g in got] == list(BUDGETS)
    assert count["op_width_max"] <= 16 and count["prefill_chunks"] > 8
    assert eng.stats.tokens_out == sum(BUDGETS)


def test_greedy_paged_chunked_streams_equal_jax(model):
    """Page 8, chunk 8, prompts 4-7 repeating 0-3: pipelines resume from
    shared prefix pages (the same hits as JAX), and no page leaks."""
    m = model
    prompts = _shared_prompts(512)
    got, eng, count = _greedy_case(m, dict(prefill_chunk=8, page_size=8),
                                   prompts, SHARED_BUDGETS)
    assert count["prefix_hits"] > 0 and count["prefix_tokens_saved"] > 0
    eng.release_prefix_cache()
    eng.allocator.assert_clean()
    dense = _port_engine(m, prefill_chunk=8)
    assert _serve(dense, Request, prompts, SHARED_BUDGETS)[0] == got
    # the resumed pipelines prefilled fewer row-tokens than dense did
    assert eng.stats.prefill_row_tokens < dense.stats.prefill_row_tokens


def test_commit_policies_equal_jax(model):
    """Cohort and eager commit on tests/test_policy.py:205's scenario:
    each equal to JAX (streams, counters, every request's TTFT rounds),
    equal streams across the policies, and eager's co-admitted short
    prompt emitting sooner."""
    m = model
    prompts = _prompts(512, POLICY_LENS)
    out = {}
    for commit in ("cohort", "eager"):
        got, eng, count = _greedy_case(
            m, dict(prefill_chunk=16, commit=commit), prompts,
            POLICY_BUDGETS)
        assert type(eng.policy.commit) is dict(
            cohort=CohortCommit, eager=EagerCommit)[commit]
        out[commit] = (got, count)
    assert out["eager"][0] == out["cohort"][0]
    assert out["eager"][1]["ttft_rounds"][5] < \
        out["cohort"][1]["ttft_rounds"][5]
    assert out["eager"][1]["steps"] >= out["cohort"][1]["steps"]


def test_sampled_chunked_streams_equal_jax(model):
    """Seed 5, chunk 16: the port's stepwise and superstep streams equal
    JAX's recorded stepwise engine off near-ties of its draws (the
    sampling tests' rule), the stepwise counters JAX's; the port's
    superstep == stepwise, paged == dense and tree-free W 1 == chain."""
    m = model
    prompts = _prompts(512, LENS)
    jeng = JaxEngine(m["jcfg"], m["jp"], m["jdcfg"], m["jdp"],
                     config=JaxConfig(**_CONF, prefill_chunk=16,
                                      greedy=False, superstep_rounds=0))
    log = _record(jeng)
    jreqs = _requests(JaxRequest, prompts, BUDGETS)
    jeng.serve_stream(iter(jreqs))
    js = dict(streams=[list(r.generated) for r in jreqs],
              sids=[r.sid for r in jreqs], log=log, width=0)
    pt = dict(m, prompts=prompts, budgets=list(BUDGETS))
    step = _port_engine(m, prefill_chunk=16, greedy=False,
                        superstep_rounds=0)
    got0, preqs = _serve(step, Request, prompts, BUDGETS)
    _assert_sampled_match(pt, js, got0)
    assert _counters(step, preqs) == _counters(jeng, jreqs)
    got8, _ = _serve(_port_engine(m, prefill_chunk=16, greedy=False),
                     Request, prompts, BUDGETS)
    assert got8 == got0
    peng = _port_engine(m, prefill_chunk=16, greedy=False, page_size=8)
    assert _serve(peng, Request, prompts, BUDGETS)[0] == got0
    peng.release_prefix_cache()
    peng.allocator.assert_clean()
    gott, _ = _serve(_port_engine(m, prefill_chunk=16, greedy=False,
                                  tree_width=1), Request, prompts, BUDGETS)
    assert gott == got0


def test_traced_chunked_serve_equals_jax(model):
    """Traced and recorded, a chunked serve emits JAX's spans, instants
    and counters ("prefill.chunk" with its width and fused commit,
    "prefill.commit", ...) with their arguments, in JAX's order, and each
    request's flight-recorder timeline (its "prefill_chunk" notes with
    position and width, first token, commits), times left out."""
    m = model
    prompts = _prompts(512, LENS)
    jeng = _jax_engine(m, prefill_chunk=16)
    jeng.tracer, jeng.recorder = JaxTracer(), JaxRecorder()
    try:
        jreqs = _serve(jeng, JaxRequest, prompts, BUDGETS)[1]
        want_tr, want_rec = jeng.tracer.events(), jeng.recorder.timelines()
    finally:
        jeng.tracer, jeng.recorder = NULL_TRACER, NULL_RECORDER
    eng = _port_engine(m, prefill_chunk=16)
    eng.tracer, eng.recorder = Tracer(), FlightRecorder()
    preqs = _serve(eng, Request, prompts, BUDGETS)[1]

    def spans(events, reqs):
        """(kind, name, args), request ids as indices (each package
        numbers its requests from its own counter)."""
        idx = {r.rid: i for i, r in enumerate(reqs)}
        return [(e[0], e[1], {k: [idx[r] for r in v] if k == "rids" else v
                              for k, v in e[5].items()}) for e in events]

    def timelines(tls):
        return [[{k: v for k, v in ev.items() if k != "t"}
                 for ev in tl["events"]] for tl in tls]

    got = spans(eng.tracer.events(), preqs)
    assert got == spans(want_tr, jreqs)
    assert ("X", "prefill.chunk", {"rows": 1, "width": 16,
                                   "fused_commit": True}) in got
    assert any(e[1] == "prefill.commit" for e in got)
    tls = timelines(eng.recorder.timelines())
    assert tls == timelines(want_rec)
    assert sum(ev["kind"] == "prefill_chunk" for tl in tls for ev in tl) \
        >= eng.stats.prefill_chunks


# ============================================================ port ladders
def _ladder(m, prompts, budgets, **kw):
    """(streams, SignalStore contents) of a chunked serve."""
    def run(rounds, wave=None, **extra):
        store = SignalStore()
        eng = _port_engine(m, superstep_rounds=rounds,
                           extractor=SignalExtractor(store, window=16),
                           **kw, **extra)
        got, _ = _serve(eng, Request, prompts, budgets, wave=wave)
        if eng.paged:
            eng.release_prefix_cache()
            eng.allocator.assert_clean()
        sig = [(b.tokens.tobytes(), b.feats.tobytes()) for b in store.drain()]
        return got, sig
    return run


@pytest.mark.parametrize("greedy", [True, False], ids=["greedy", "sampled"])
def test_port_chunked_ladder(model, greedy):
    """Exactly, streams and SignalStore contents: stepwise == superstep
    (K 8 and 3) == waves, paged == dense, eager == cohort, tree W 2
    stepwise == superstep; and chunked against one-shot within the port
    equal off near-ties."""
    m = model
    prompts = _prompts(512, LENS)
    run = _ladder(m, prompts, BUDGETS, prefill_chunk=16, greedy=greedy)
    ref = run(8)
    assert run(0) == ref, "chunked stepwise != superstep"
    assert run(3) == ref, "chunked K 3 != K 8"
    assert run(8, wave=4) == ref, "chunked waves != stream"
    assert run(8, page_size=8) == ref, "chunked paged != dense"
    assert run(8, commit="eager") == ref, "eager != cohort"
    assert run(0, tree_width=2) == run(8, tree_width=2), \
        "chunked tree W 2 stepwise != superstep"
    one = _ladder(m, prompts, BUDGETS, greedy=greedy)(8)[0]
    if greedy:
        _assert_streams_match(m, prompts, ref[0], one)
    else:
        # one-shot vs chunked differ only in the last ulps of the
        # staging rows: a sampled draw flips only at a near-tie, which
        # the JAX-recorded rule above covers; here at most one request
        assert sum(a != b for a, b in zip(ref[0], one)) <= 1


def test_chunked_wave_matches_stream_with_stats(model):
    """``serve_wave`` on a chunked engine runs the same pipelines: the
    same streams and serving stats as the stream of those requests."""
    m = model
    prompts = _prompts(512, LENS[:4])
    ew, es = _port_engine(m, prefill_chunk=16), _port_engine(
        m, prefill_chunk=16)
    gw, rw = _serve(ew, Request, prompts, BUDGETS[:4], wave=4)
    gs, rs = _serve(es, Request, prompts, BUDGETS[:4])
    assert gw == gs
    assert _counters(ew, rw) == _counters(es, rs)
    assert ew.stats.prefill_op_width.max <= 16 and ew.stats.prefill_chunks > 0


# ================================================================== cases
def test_zero_budget_admitted_mid_chunk(model):
    """A zero-budget request admitted while a long prompt is mid-chunk
    finishes with no tokens; every stream equals JAX's."""
    m = model
    lens, budgets = (55, 8, 8, 8, 9, 10), (12, 3, 4, 3, 0, 6)
    prompts = _prompts(512, lens)
    got, _, count = _greedy_case(m, dict(prefill_chunk=16), prompts,
                                 budgets)
    assert got[4] == [] and count["ttft_rounds"][4] is None


def test_eos_on_first_token_after_prefill(model):
    """EOS as the first token a pipeline commits: a one-token stream and
    a finished request; every stream is the EOS-free stream cut after its
    first EOS (greedy decoding is scheduling-invariant), superstep and
    stepwise alike."""
    m = model
    prompts = _prompts(512, LENS[:6])
    budgets = (6,) * 6
    probe, _ = _serve(_port_engine(m, prefill_chunk=16), Request, prompts,
                      budgets)
    eos = probe[4][0]      # request 4 is a refill: its first token
    #                        commits at a pipeline commit mid-stream
    for rounds in (8, 0):
        eng = _port_engine(m, prefill_chunk=16, eos_id=eos,
                           superstep_rounds=rounds)
        got, reqs = _serve(eng, Request, prompts, budgets)
        for g, p in zip(got, probe):
            cut = p.index(eos) + 1 if eos in p else len(p)
            assert g == p[:cut]
        assert got[4] == [eos] and all(r.done for r in reqs)
        assert eng.stats.tokens_out == sum(len(g) for g in got)


def test_deploy_reseed_lands_mid_prefill(model):
    """A deploy with the re-seed ring, picked up while the first
    long-prompt pipeline is still chunking, neither fails nor changes the
    greedy streams, and leaves the inert lanes' rows to their commit."""
    m = model

    class _Ver:
        def __init__(self, seq, dparams):
            self.seq, self.dparams, self.eval_acc = seq, dparams, 0.0

    new = bridge.draft_from_numpy(m["dcfg"], _flatten(jeagle.draft_init(
        m["jdcfg"], jax.random.key(99))), device="cpu")
    calls = {"n": 0}

    def source():
        calls["n"] += 1
        return _Ver(1, new) if calls["n"] >= 2 else None

    prompts = _prompts(512, LENS)
    ref, _ = _serve(_port_engine(m, prefill_chunk=16), Request, prompts,
                    BUDGETS)
    eng = _port_engine(m, prefill_chunk=16, reseed_window=12)
    eng.deploy_source = source
    got, _ = _serve(eng, Request, prompts, BUDGETS)
    assert got == ref
    assert eng.stats.deploys == 1 and eng.stats.reseeds == 1


def test_refill_groups_partition_equals_jax():
    lens = (3, 9, 40, 12, 33)
    pa = list(enumerate(Request(prompt=[1] * n, max_new_tokens=4)
                        for n in lens))
    ja = list(enumerate(JaxRequest(prompt=[1] * n, max_new_tokens=4)
                        for n in lens))
    for chunk in (16, 0):
        got = [[s for s, _ in g] for g in Scheduler.refill_groups(pa, chunk)]
        want = [[s for s, _ in g]
                for g in JaxScheduler.refill_groups(ja, chunk)]
        assert got == want
    assert [[s for s, _ in g]
            for g in Scheduler.refill_groups(pa, 16)] == [[0], [1, 3],
                                                         [2, 4]]
    assert Scheduler.refill_groups([], 16) == []
    # the commit policies delegate their grouping to the scheduler
    for pol in (CohortCommit(), EagerCommit()):
        assert pol.refill_groups(pa, 16) == Scheduler.refill_groups(pa, 16)


def test_ttft_clock_starts_at_admission(model):
    _, reqs = _serve(_port_engine(model, prefill_chunk=16), Request,
                     _prompts(512, LENS), BUDGETS)
    for r in reqs:
        assert r.admit_t is not None and r.admit_t >= r.arrival_t
        assert r.ttft is not None and 0.0 <= r.ttft <= r.latency


def test_prefill_chunk_must_be_a_multiple_of_8(model):
    with pytest.raises(ValueError, match="multiple of 8"):
        _port_engine(model, prefill_chunk=12)
