"""Multi-head latent attention and the dense prologue (deepseek-v3-671b)
against the JAX package on the CPU.

* The config (``CONFIG``, ``REDUCED``, the EAGLE-3 draft's) field for
  field, the parameter specs at full width, and the bridge round trip of
  JAX's ``REDUCED`` tree (the ``pre`` group and the 3-D MLA leaves).
* On JAX's ``REDUCED`` weights (key 0, fp32, no pretraining; 1 prologue
  layer of MLA + SwiGLU and 1 body layer of MLA + MoE, captures (1, 1, 0)
  across both groups): ``mla_prefill`` with and without a left pad and
  ``mla_decode`` at T 1, 4 and 8, outputs and latent caches, against
  JAX's module at rtol/atol 2e-5; the port's absorbed decode against its
  own expanded prefill; ``transformer.prefill``, ``decode_step`` and
  ``commit_cache`` (logits, both groups' caches, the captures, aux).
* Greedy engine streams, one-shot and chunked refill (chunk 8), against
  JAX's stepwise engines: equal, or a first departure at a near-tie of
  the target's top-2 logits; one sampled stream (seed 5) against JAX's
  recorded engine under the sampling tests' rule; the port's ladder
  stepwise == superstep == stream == wave, exactly.

A MoE layer's capacity comes from the token count of its call, so a
lane's tokens depend on what the other lane holds (ROADMAP, Reference
state).  A stream refills a freed lane at the next round when stepwise
and at the next superstep boundary otherwise, so at REDUCED's capacity
factor (1.25, where its routing drops) stepwise and superstep streams
differ, in JAX as in the port; each equals the other package's of the
same mode.  So the streams are held to JAX's stepwise engines by the
port's stepwise engine, the whole ladder is held at capacity factor 2.0
(nothing can drop), and at 1.25 the ladder rung that keeps every shape
(waves, stepwise == superstep).  The absorbed decode is held to the
expanded prefill at 2.0 too: a prefill of the whole sequence and a
decode of its last tokens see other capacities.
* The engine needs no MLA code of its own: a spill and restore returns a
  lane's ``ckv``/``kr`` rows bit for bit, deadline preemption leaves the
  streams as they were, and the chunked commit pads the latent leaves
  (``spec.pad_target_cache``).
* Refusals: paged KV and trees with JAX's messages, the training
  forward and both CLIs' training (ROADMAP queue 1 item 8); the serve
  CLI serves the arch with ``--pretrain-steps 0``.

Fixed seeds, no hypothesis; JAX engines are module-scoped and stepwise
(``superstep_rounds=0``)."""
import dataclasses
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import repro.configs as C  # noqa: E402
from repro.checkpoint.ckpt import _flatten  # noqa: E402
from repro.core import eagle as jeagle  # noqa: E402
from repro.models import mla as jmla  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.param import ParamSpec as JSpec  # noqa: E402
from repro.serving.engine import ServingEngine as JaxEngine  # noqa: E402
from repro.serving.policy import ServingConfig as JaxConfig  # noqa: E402
from repro.serving.request import Request as JaxRequest  # noqa: E402
from repro_torch.checkpoint import bridge  # noqa: E402
from repro_torch.configs import get, get_reduced  # noqa: E402
from repro_torch.core import eagle  # noqa: E402
from repro_torch.core import speculative as spec  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.models import mla  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.param import ParamSpec  # noqa: E402
from repro_torch.obs.cobatch import cobatch_diff  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from repro_torch.serving.policy import ServingConfig  # noqa: E402
from repro_torch.serving.request import Request  # noqa: E402
from test_torch_families import _spec_leaves, _unflat  # noqa: E402
import test_torch_overload as ovl  # noqa: E402
from test_torch_sampling import (_assert_streams_match as  # noqa: E402
                                 _assert_sampled_match, _record)

ARCH = "deepseek-v3-671b"
TOL = dict(rtol=2e-5, atol=2e-5)
NEAR_TIE = 1e-4          # top-2 logit gap below which a flip is a tie
SEED = 5                 # the sampling tests' engine seed
MAX_LEN = 64
BUDGETS = [12, 7, 12, 9, 5, 10]
_CONF = dict(batch_size=2, max_len=96, gamma=3, seed=SEED)
NO_DROP_CF = 2.0         # capacity >= tokens: no assignment drops
# JAX's functions compiled once (the config static): eager dispatch of
# their ops costs seconds a call on the CPU
_jprefill = jax.jit(JT.prefill, static_argnums=0,
                    static_argnames=("max_len",))
_jdecode = jax.jit(JT.decode_step, static_argnums=0)
_jmla_prefill = jax.jit(jmla.mla_prefill, static_argnums=0)
_jmla_decode = jax.jit(jmla.mla_decode, static_argnums=0)


@pytest.fixture(scope="module")
def m():
    """JAX's REDUCED target at key 0 and draft at key 7 (its init
    compiled: eager, it takes 16 s on the CPU), and the port's, bridged;
    the requests of the stream tests."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    jcfg, cfg = C.get_reduced(ARCH), get_reduced(ARCH)
    jp = jax.jit(JT.init, static_argnums=0)(jcfg, jax.random.key(0))
    flat = _flatten(jp)
    jdcfg = jeagle.draft_config(jcfg)
    jdp = jax.jit(jeagle.draft_init, static_argnums=0)(
        jdcfg, jax.random.key(7))
    dcfg = eagle.draft_config(cfg)
    rng = np.random.default_rng(6)
    prompts = [[int(t) for t in rng.integers(1, cfg.vocab_size, int(n))]
               for n in rng.integers(8, 25, size=len(BUDGETS))]
    yield dict(jcfg=jcfg, cfg=cfg, jp=jp, flat=flat, jdcfg=jdcfg, jdp=jdp,
               dcfg=dcfg, tp=bridge.target_from_numpy(cfg, flat, device="cpu"),
               tdp=bridge.draft_from_numpy(dcfg, _flatten(jdp), device="cpu"),
               prompts=prompts, budgets=list(BUDGETS))
    torch.set_num_threads(threads)


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _close(got, want):
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def _prompts(vocab, with_pad):
    rng = np.random.default_rng(4)
    lens = [12, 9, 5] if with_pad else [12, 12, 12]
    toks = np.zeros((3, 12), np.int32)
    pad = np.zeros((3,), np.int32)
    for i, n in enumerate(lens):
        pad[i] = 12 - n
        toks[i, pad[i]:] = rng.integers(0, vocab, size=n)
    return toks, pad


# ============================================================== configs
def test_config_matches_jax():
    """CONFIG, REDUCED and the draft's config field for field; REDUCED is
    JAX's 2-layer cut (a prologue layer and a MoE layer) and carries
    mtp_depth, which nothing reads."""
    for jc, tc in ((C.get(ARCH), get(ARCH)),
                   (C.get_reduced(ARCH), get_reduced(ARCH))):
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        assert dataclasses.asdict(eagle.draft_config(tc)) == \
            dataclasses.asdict(jeagle.draft_config(jc))
        assert tc.mtp_depth == 1
    red = get_reduced(ARCH)

    def groups(mod, cfg):
        return [(n, [dataclasses.asdict(b) for b in p], r)
                for n, p, r in mod.model_groups(cfg)]
    assert groups(T, red) == groups(JT, C.get_reduced(ARCH))
    assert [g[0] for g in T.model_groups(get(ARCH))] == ["pre", "body"]
    assert red.captures == (1, 1, 0)


def test_param_specs_match_jax():
    """At full width: every leaf's key, shape, axes and init (the pre
    group, the MLA mixer's 3-D leaves), the parameter counts, the
    draft's."""
    jc, tc = C.get(ARCH), get(ARCH)
    assert _spec_leaves(T.param_specs(tc), ParamSpec) == \
        _spec_leaves(JT.param_specs(jc), JSpec)
    assert tc.param_count() == jc.param_count()
    assert tc.active_param_count() == jc.active_param_count()
    assert eagle.draft_param_count(eagle.draft_config(tc)) == \
        jeagle.draft_param_count(jeagle.draft_config(jc))
    mix = T.param_specs(tc)["pre"]["pos0"]["mix"]
    assert mix["wkv_b"].shape == (3, 512, 128, 256)
    assert mix["wo"].shape == (3, 128, 128, 7168)


def test_bridge_round_trip(m):
    """JAX's REDUCED tree -> the port -> numpy gives the same keys and
    arrays, and back in JAX the same prefill logits."""
    back = bridge.tree_to_numpy(m["tp"])
    assert sorted(back) == sorted(m["flat"])
    for k, v in m["flat"].items():
        np.testing.assert_array_equal(back[k], v)
    assert back["pre/pos0/mix/wq_b"].shape == (1, 64, 4, 48)
    assert back["body/pos0/moe/shared/w_up"].shape[0] == 1
    toks = np.random.default_rng(2).integers(0, 512, (2, 7)).astype(np.int32)
    jp2 = jax.tree_util.tree_map(jnp.asarray, _unflat(back))
    a = _jprefill(m["jcfg"], m["jp"], jnp.asarray(toks))["logits"]
    b = _jprefill(m["jcfg"], jp2, jnp.asarray(toks))["logits"]
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ============================================================ the module
def _layer(m, group="pre"):
    jl = jax.tree_util.tree_map(lambda a: a[0], m["jp"][group]["pos0"]["mix"])
    return jl, T._slices(m["tp"][group], 1, 0)[0]["mix"]


def _x(m, b, s, seed):
    return np.random.default_rng(seed).standard_normal(
        (b, s, m["cfg"].d_model)).astype(np.float32)


@pytest.mark.parametrize("with_pad", [False, True], ids=["nopad", "pad"])
def test_mla_prefill_matches_jax(m, with_pad):
    """Out (the pad rows included: the mean of v) and the latents."""
    jl, tl = _layer(m)
    x = _x(m, 3, 12, 1)
    pad = np.array([0, 3, 7], np.int32) if with_pad else None
    pos = np.broadcast_to(np.arange(12), (3, 12))
    if with_pad:
        pos = np.maximum(pos - pad[:, None], 0)
    jo, (jc, jk) = _jmla_prefill(m["jcfg"], jl, jnp.asarray(x),
                                    jnp.asarray(pos),
                                    None if pad is None else jnp.asarray(pad))
    to, (tc, tk) = mla.mla_prefill(m["cfg"], tl, torch.tensor(x),
                                   torch.tensor(pos),
                                   None if pad is None else torch.tensor(pad))
    for got, want in ((to, jo), (tc, jc), (tk, jk)):
        _close(got, want)


@pytest.mark.parametrize("t", [1, 4, 8])
def test_mla_decode_matches_jax(m, t):
    """A T-token block after a padded 12-token prompt: out and both
    latent caches, the block's rows written in place."""
    jl, tl = _layer(m)
    x0, pad = _x(m, 3, 12, 1), np.array([0, 3, 7], np.int32)
    pos = np.maximum(np.arange(12)[None] - pad[:, None], 0)
    _, (c0, k0) = _jmla_prefill(m["jcfg"], jl, jnp.asarray(x0),
                                   jnp.asarray(pos), jnp.asarray(pad))
    ckv = np.zeros((3, 32, 64), np.float32)
    kr = np.zeros((3, 32, 16), np.float32)
    ckv[:, :12], kr[:, :12] = np.asarray(c0), np.asarray(k0)
    lengths = np.full((3,), 12, np.int32)
    x = _x(m, 3, t, 2)
    jo, (jc, jk) = _jmla_decode(m["jcfg"], jl, jnp.asarray(x),
                                   jnp.asarray(ckv), jnp.asarray(kr),
                                   jnp.asarray(lengths), jnp.asarray(pad))
    tc, tk = torch.tensor(ckv), torch.tensor(kr)
    to, (tc2, tk2) = mla.mla_decode(m["cfg"], tl, torch.tensor(x), tc, tk,
                                    torch.tensor(lengths), torch.tensor(pad))
    assert tc2 is tc and tk2 is tk
    for got, want in ((to, jo), (tc, jc), (tk, jk)):
        _close(got, want)


@pytest.mark.parametrize("t", [1, 4])
def test_absorbed_decode_matches_expanded(m, t):
    """The port's latent-space decode of a block gives the logits its
    expanded-form prefill gives the whole sequence (JAX's
    test_mla_absorbed_decode_matches_expanded, on both groups)."""
    cfg = dataclasses.replace(m["cfg"], capacity_factor=NO_DROP_CF)
    tp = m["tp"]
    toks = torch.tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 17 + t)), dtype=torch.int32)
    pre = T.prefill(cfg, tp, toks[:, :17], max_len=17 + t + 3)
    dec = T.decode_step(cfg, tp, pre["cache"], toks[:, 17:])
    for j in range(t):
        ref = T.prefill(cfg, tp, toks[:, :18 + j])
        _close(dec["logits"][:, j], ref["logits"])


def _cache_close(cfg, tc, jc, hi):
    for name, _, _ in T.model_groups(cfg):
        for leaf in ("ckv", "kr"):
            _close(tc[name]["pos0"][leaf][:, :, :hi],
                   np.asarray(jc[name]["pos0"][leaf])[:, :, :hi])


@pytest.mark.parametrize("with_pad", [False, True], ids=["nopad", "pad"])
def test_prefill_decode_commit_match_jax(m, with_pad):
    """``transformer.prefill`` (logits, captures across the groups, both
    groups' latent caches, aux), a 4-token ``decode_step`` (logits,
    captures, caches with the block) and ``commit_cache``."""
    cfg, jcfg = m["cfg"], m["jcfg"]
    toks, pad = _prompts(cfg.vocab_size, with_pad)
    jout = _jprefill(jcfg, m["jp"], jnp.asarray(toks), max_len=MAX_LEN,
                     pad=jnp.asarray(pad))
    tout = T.prefill(cfg, m["tp"], torch.tensor(toks), max_len=MAX_LEN,
                     pad=torch.tensor(pad))
    _close(tout["logits"], jout["logits"])
    _close(tout["captures"], jout["captures"])
    _close(tout["aux"], jout["aux"])
    assert float(tout["aux"]) > 0
    _cache_close(cfg, tout["cache"], jout["cache"], 12)
    assert tout["cache"]["pre"]["pos0"]["ckv"].shape == (1, 3, MAX_LEN, 64)
    block = np.random.default_rng(4).integers(
        0, cfg.vocab_size, (3, 4)).astype(np.int32)
    jd = _jdecode(jcfg, m["jp"], jout["cache"], jnp.asarray(block))
    td = T.decode_step(cfg, m["tp"], tout["cache"], torch.tensor(block))
    _close(td["logits"], jd["logits"])
    _close(td["captures"], jd["captures"])
    _cache_close(cfg, td["cache"], jd["cache"], 16)
    n = np.array([1, 4, 2], np.int32)
    jc = JT.commit_cache(jcfg, jd["cache"], jnp.asarray(n))
    tc = T.commit_cache(cfg, td["cache"], torch.tensor(n))
    np.testing.assert_array_equal(tc["lengths"].numpy(),
                                  np.asarray(jc["lengths"]))
    _cache_close(cfg, tc, jc, 16)


def test_cobatch_steps_compute_prefill(m):
    """``obs/cobatch.py``'s op sequence names the MLA layer's ops and
    computes ``transformer.prefill`` (``cobatch_diff`` checks the logits
    and raises otherwise)."""
    cfg = m["cfg"]
    toks, pad = _prompts(cfg.vocab_size, True)
    a = (torch.tensor(toks[2:]), torch.tensor(pad[2:]), 0)
    b = (torch.tensor(toks), torch.tensor(pad), 2)
    d = cobatch_diff(cfg, m["tp"], a, b)
    assert d["kv_rows_equal"] and d["argmax_equal"]
    from repro_torch.obs.cobatch import prefill_steps
    names = [s[0] for s in prefill_steps(cfg, m["tp"], None, None)]
    for op in ("pre.0.kv_norm", "pre.0.attention", "body.0.q_b",
               "body.0.moe"):
        assert op in names


def test_pad_target_cache_pads_latent_leaves():
    """A chunked refill's staging cache of latent leaves (repeats, R,
    width, dim) is padded on the width axis only."""
    leaf = torch.arange(2 * 3 * 5 * 4, dtype=torch.float32).reshape(
        2, 3, 5, 4)
    cache = {"lengths": torch.zeros(3), "pad": torch.zeros(3),
             "pre": {"pos0": {"ckv": leaf}}}
    out = spec.pad_target_cache(cache, 9)["pre"]["pos0"]["ckv"]
    assert out.shape == (2, 3, 9, 4)
    assert torch.equal(out[:, :, :5], leaf) and not out[:, :, 5:].any()


# ====================================================== engine streams
_JAX_ENGINES = {}


def _jax_serve(m, **kw):
    key = tuple(sorted(kw.items()))
    if key not in _JAX_ENGINES:
        eng = JaxEngine(m["jcfg"], m["jp"], m["jdcfg"], m["jdp"],
                        config=JaxConfig(**_CONF, superstep_rounds=0, **kw))
        log = _record(eng) if kw.get("greedy") is False else None
        reqs = [JaxRequest(prompt=list(p), max_new_tokens=b)
                for p, b in zip(m["prompts"], m["budgets"])]
        eng.serve_stream(iter(reqs))
        _JAX_ENGINES[key] = dict(streams=[list(r.generated) for r in reqs],
                                 sids=[r.sid for r in reqs], log=log,
                                 width=0)
    return _JAX_ENGINES[key]


def _port_serve(m, stream=True, cf=None, **kw):
    cfg = m["cfg"] if cf is None else dataclasses.replace(
        m["cfg"], capacity_factor=cf)
    eng = ServingEngine(cfg, m["tp"], m["dcfg"], m["tdp"], device="cpu",
                        config=ServingConfig(**dict(_CONF, **kw)))
    reqs = [Request(prompt=list(p), max_new_tokens=b)
            for p, b in zip(m["prompts"], m["budgets"])]
    if stream:
        eng.serve_stream(iter(reqs))
    else:
        for i in range(0, len(reqs), 2):
            eng.serve_wave(reqs[i:i + 2])
    assert all(len(r.generated) == b for r, b in zip(reqs, m["budgets"]))
    return [list(r.generated) for r in reqs], eng


def _assert_greedy_match(m, got, want):
    """Equal streams, or a first departure at a near-tie of the JAX
    target's greedy logits (a plain prefill of prompt + common prefix)."""
    ties = 0
    for prompt, g, w in zip(m["prompts"], got, want):
        assert len(g) == len(w)
        if g == w:
            continue
        i = next(j for j in range(len(g)) if g[j] != w[j])
        seq = jnp.asarray([list(prompt) + w[:i]], jnp.int32)
        lg = np.asarray(_jprefill(m["jcfg"], m["jp"], seq)["logits"][0])
        top = np.sort(lg)[-2:]
        assert top[1] - top[0] < NEAR_TIE, (
            f"stream departs at step {i} with top-2 gap {top[1] - top[0]}")
        ties += 1
    assert ties <= 1, f"{ties} near-tie flips: too many to be ties"


@pytest.mark.parametrize("chunk", [0, 8], ids=["one_shot", "chunk8"])
def test_greedy_streams_equal_jax(m, chunk):
    """The port's stepwise engine against JAX's, one-shot and chunked."""
    got, eng = _port_serve(m, prefill_chunk=chunk, superstep_rounds=0)
    _assert_greedy_match(m, got, _jax_serve(m, prefill_chunk=chunk)
                         ["streams"])
    assert eng.stats.spec_steps > 0
    if chunk:
        assert eng.stats.prefill_chunks > len(m["budgets"])


def test_sampled_stream_equals_jax(m):
    """Seed 5: the port's stepwise stream against JAX's recorded stepwise
    engine (the sampling tests' near-tie rule), and the port's waves
    stepwise == superstep."""
    js = _jax_serve(m, greedy=False)
    got, _ = _port_serve(m, greedy=False, superstep_rounds=0)
    _assert_sampled_match(dict(m), js, got)
    w0, _ = _port_serve(m, stream=False, greedy=False, superstep_rounds=0)
    w8, _ = _port_serve(m, stream=False, greedy=False, superstep_rounds=8)
    assert w8 == w0


@pytest.mark.parametrize("cf", [None, NO_DROP_CF], ids=["cf1.25", "cf2"])
def test_port_ladder(m, cf):
    """Inside the port, exactly: waves stepwise == superstep (every shape
    kept); at 2.0, where nothing drops, also stream stepwise ==
    superstep == waves."""
    w0, _ = _port_serve(m, stream=False, superstep_rounds=0, cf=cf)
    w8, _ = _port_serve(m, stream=False, superstep_rounds=8, cf=cf)
    assert w8 == w0
    if cf == NO_DROP_CF:
        s4, _ = _port_serve(m, superstep_rounds=4, cf=cf)
        s0, _ = _port_serve(m, superstep_rounds=0, cf=cf)
        assert s4 == s0 == w0


def test_spill_restore_round_trip(m):
    """Spill lane 0, refill it with another prompt, restore into lane 1:
    lane 1's ``ckv``/``kr`` rows of both groups, and the rest of its
    state, are lane 0's at the spill, bit for bit."""
    eng = ServingEngine(m["cfg"], m["tp"], m["dcfg"], m["tdp"], device="cpu",
                        config=ServingConfig(**dict(_CONF,
                                                    superstep_rounds=4)))
    rng = np.random.default_rng(11)
    prompts = [[int(t) for t in rng.integers(1, 512, n)] for n in (13, 6)]
    cache, dcache, state, max_new = ovl._live_state(eng, prompts, [20, 20])
    before = ovl._lane_view(eng, cache, dcache, state, max_new, 0)
    assert {k[2] for k in before["cache"]} == {"ckv", "kr"}
    assert {k[0] for k in before["cache"]} == {"pre", "body"}
    snap = eng._spill(cache, dcache, state, max_new, 0)
    assert ovl._equal(snap, before)
    new = Request(prompt=[int(t) for t in rng.integers(1, 512, 9)],
                  max_new_tokens=5)
    eng._assign_sids([(0, new)])
    args = eng._refill_arrays([(0, new)])
    cache, dcache, _ = eng._map_refill(cache, dcache, [(0, new)],
                                       *args[0].shape)
    cache, dcache, state, max_new, _ = eng._refill_superstep(
        cache, dcache, state, max_new, *args, tbl_rows=None)
    assert not ovl._equal(ovl._lane_view(eng, cache, dcache, state, max_new,
                                         0), before)
    cache, dcache, state, max_new = eng._restore(cache, dcache, state,
                                                 max_new, 1, snap)
    assert ovl._equal(ovl._lane_view(eng, cache, dcache, state, max_new, 1),
                      before)


def test_preemption_keeps_streams(m):
    """Deadline preemption on the overload tests' in-flight trace (two
    loose residents, a tight pair arriving at round 2): the victims'
    latent lanes are spilled and restored, and every stream equals the
    unpreempted serve's."""
    dm = dict(m)
    eng = ovl._port_engine(dm, preempt="deadline", **ovl._EDF)
    reqs, _ = ovl._serve(eng, Request, ovl._INFLIGHT)
    assert eng.stats.preemptions >= 1 and eng.stats.restores >= 1
    base, _ = ovl._serve(ovl._port_engine(dm, **ovl._EDF), Request,
                         ovl._INFLIGHT)
    assert [r.generated for r in reqs] == [r.generated for r in base]


# ============================================================ refusals
_PAGED = "paged KV cache supports attention mixers only; config has 'mla'"
_TREE = "tree speculation supports attention mixers only; config has 'mla'"


@pytest.mark.parametrize("kw,msg", [(dict(page_size=8), _PAGED),
                                    (dict(tree_width=2), _TREE)],
                         ids=["paged", "tree"])
def test_paged_and_tree_refused_as_jax(m, kw, msg):
    for cls, conf, args in (
            (JaxEngine, JaxConfig, (m["jcfg"], m["jp"], m["jdcfg"], m["jdp"])),
            (ServingEngine, ServingConfig,
             (m["cfg"], m["tp"], m["dcfg"], m["tdp"]))):
        extra = {} if cls is JaxEngine else {"device": "cpu"}
        with pytest.raises(ValueError, match=re.escape(msg)):
            cls(*args, config=conf(**_CONF, **kw), **extra)
    with pytest.raises(ValueError, match=re.escape(_PAGED)):
        T.init_cache(m["cfg"], 2, 32, device="cpu", page_size=8,
                     num_pages=8)


def test_training_refused(m):
    """``forward_train``, the train CLI and the serve CLI's target
    pretraining raise, naming ROADMAP queue 1 item 8, before any weight
    is made."""
    batch = {"tokens": torch.zeros((1, 8), dtype=torch.int32),
             "targets": torch.zeros((1, 8), dtype=torch.int32)}
    with pytest.raises(NotImplementedError, match="item 8"):
        T.forward_train(m["cfg"], m["tp"], batch)
    with pytest.raises(NotImplementedError, match="item 8"):
        train.main(["--arch", ARCH, "--steps", "1"], device="cpu")
    with pytest.raises(NotImplementedError, match="item 8"):
        serve.main(["--arch", ARCH, "--requests", "1"], device="cpu")


def test_serve_cli_serves_the_arch(m):
    """``launch.serve`` with ``--pretrain-steps 0`` serves REDUCED: 4
    requests, each to its budget."""
    sys_, done = serve.main(["--arch", ARCH, "--requests", "4",
                             "--pretrain-steps", "0", "--max-new-tokens",
                             "6", "--no-adaptive"], device="cpu")
    assert sys_.engine.cfg == get_reduced(ARCH)
    assert len(done) == 4 and all(len(r.generated) == 6 for r in done)
