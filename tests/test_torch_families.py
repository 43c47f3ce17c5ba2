"""The attention-mixer families beside glm4-9b against the JAX package on
the CPU: phi3-medium-14b (SwiGLU), starcoder2-7b and -15b (the GELU FFN,
whose up and down projections carry biases), granite-moe-3b-a800m and
gpt-oss-120b (the MoE FFN, ``repro_torch/models/moe.py``).

* Each config (``CONFIG``, ``REDUCED``, ``eagle.draft_config``) equals
  JAX's field for field, and its parameter specs JAX's.
* JAX's ``REDUCED`` weights (random GELU biases put in) cross the bridge
  both ways under their '/'-joined keys.
* On those weights (fp32): ``prefill`` (logits, captures, cache, aux),
  ``decode_step`` (chain T 4, tree W 4 gamma 3 = T 13) and
  ``forward_train`` (loss, ce, aux, and gradients on two families)
  against JAX's, at rtol/atol 2e-5; the MoE families at their capacity
  factor and at 0.5, where the routing drops assignments.
* Greedy engine streams of granite-moe and starcoder2-7b ``REDUCED``,
  dense and paged, against JAX's engine (a departure is accepted only at
  a near-tie of the target's top-2 logits, ROADMAP's North star), and
  the port's own ladder stepwise == superstep == stream on granite.
* The entry points: ``launch.serve`` and ``launch.train`` take every
  new ``--arch``.

Positions before a lane's left pad are compared too.  JAX's attention
gives such a row the mean of V over the prefill's keys (every key masked
at -1e30), and the port's prefill puts that value in
(``attention.pad_rows_mean_v``).  A MoE layer routes those rows and
counts them against its capacity, so they decide which of a lane's valid
assignments drop (``test_pad_rows_move_drops``).  So the padded MoE
cases run at the configs' 1.25 and at 0.5, each asserted to drop, and
at 2.0, where nothing can drop; the engine streams at 1.25 are asserted
to drop in a padded refill."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import repro.configs as C  # noqa: E402
from repro.checkpoint.ckpt import _flatten  # noqa: E402
from repro.core import eagle as jeagle  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.param import ParamSpec as JSpec  # noqa: E402
from repro.serving.engine import ServingEngine as JaxEngine  # noqa: E402
from repro.serving.policy import ServingConfig as JaxConfig  # noqa: E402
from repro.serving.request import Request as JaxRequest  # noqa: E402
from repro_torch.checkpoint import bridge  # noqa: E402
from repro_torch.configs import get, get_reduced  # noqa: E402
from repro_torch.core import eagle  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.config import FFN_MOE  # noqa: E402
from repro_torch.models.param import ParamSpec  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from repro_torch.serving.policy import ServingConfig  # noqa: E402
from repro_torch.serving.request import Request  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)
NEAR_TIE = 1e-4          # top-2 logit gap below which a flip is a tie
ARCHS = ["phi3-medium-14b", "starcoder2-7b", "starcoder2-15b",
         "granite-moe-3b-a800m", "gpt-oss-120b"]
MOE_ARCHS = ["granite-moe-3b-a800m", "gpt-oss-120b"]
# (arch, capacity factor, left pads): the dense families with pads; the
# MoE families at 2.0 (nothing drops) and at their own 1.25 and at 0.5
# (the routing drops assignments), with and without pads
CASES = ([(a, None, True) for a in ARCHS if a not in MOE_ARCHS]
         + [(a, cf, pad) for a in MOE_ARCHS
            for cf, pad in ((2.0, True), (None, False), (0.5, False),
                            (None, True), (0.5, True))])
NO_DROP_CF = 2.0
# forward_train runs no pad: the MoE cases without one, and 2.0
TRAIN_CASES = [c for c in CASES
               if not (c[0] in MOE_ARCHS and c[2] and c[1] != NO_DROP_CF)]
MAX_LEN = 64


@pytest.fixture(scope="module", autouse=True)
def _threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _cfgs(arch, cf=None):
    jcfg, cfg = C.get_reduced(arch), get_reduced(arch)
    if cf is not None:
        jcfg = dataclasses.replace(jcfg, capacity_factor=cf)
        cfg = dataclasses.replace(cfg, capacity_factor=cf)
    return jcfg, cfg


_MODELS = {}


def _model(arch, cf=None):
    """JAX's REDUCED target at key 0 (GELU biases drawn from a seed: JAX
    inits them to zero) and the port's, bridged."""
    if (arch, cf) not in _MODELS:
        jcfg, cfg = _cfgs(arch, cf)
        jp = JT.init(jcfg, jax.random.key(0))
        flat = _flatten(jp)
        rng = np.random.default_rng(1)
        for k in sorted(flat):
            if k.endswith(("/b_up", "/b_down")):
                flat[k] = (0.1 * rng.standard_normal(flat[k].shape)
                           ).astype(np.float32)
        jp = jax.tree_util.tree_map(jnp.asarray, _unflat(flat))
        tp = bridge.target_from_numpy(cfg, flat, device="cpu")
        _MODELS[(arch, cf)] = dict(jcfg=jcfg, cfg=cfg, jp=jp, tp=tp,
                                   flat=flat)
    return _MODELS[(arch, cf)]


def _unflat(flat):
    tree = {}
    for key, val in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = val
    return tree


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _rows_close(got, want, lo, hi, axis_s):
    """Compare lane b's positions [lo[b], hi[b]) along ``axis_s`` (the
    lane axis is the one before it)."""
    got, want = _np(got), _np(want)
    for b in range(len(lo)):
        sl = [slice(None)] * got.ndim
        sl[axis_s - 1], sl[axis_s] = b, slice(int(lo[b]), int(hi[b]))
        np.testing.assert_allclose(got[tuple(sl)], want[tuple(sl)], **TOL)


def _cache_close(cfg, tc, jc, lo, hi):
    for name, pattern, _ in T.model_groups(cfg):
        for pi in range(len(pattern)):
            for leaf in ("k", "v"):
                _rows_close(tc[name][f"pos{pi}"][leaf],
                            jc[name][f"pos{pi}"][leaf], lo, hi, axis_s=2)


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
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_jax(arch):
    for jc, tc in ((C.get(arch), get(arch)),
                   (C.get_reduced(arch), get_reduced(arch))):
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        assert dataclasses.asdict(eagle.draft_config(tc)) == \
            dataclasses.asdict(jeagle.draft_config(jc))


def _spec_leaves(specs, cls, prefix=""):
    if isinstance(specs, cls):
        return {prefix: (tuple(specs.shape), tuple(specs.axes), specs.init,
                         specs.scale)}
    out = {}
    for k, v in specs.items():
        out.update(_spec_leaves(v, cls, f"{prefix}/{k}" if prefix else k))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_jax(arch):
    """At full width: every leaf's key, shape, axes and init scheme, and
    the parameter counts (the draft's too)."""
    jc, tc = C.get(arch), get(arch)
    assert _spec_leaves(T.param_specs(tc), ParamSpec) == \
        _spec_leaves(JT.param_specs(jc), JSpec)
    assert tc.param_count() == jc.param_count()
    assert tc.active_param_count() == jc.active_param_count()
    assert eagle.draft_param_count(eagle.draft_config(tc)) == \
        jeagle.draft_param_count(jeagle.draft_config(jc))


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_round_trip(arch):
    """JAX's REDUCED tree -> the port -> numpy gives the same keys and
    arrays, the stacked MoE leaves and the GELU biases among them."""
    m = _model(arch)
    back = bridge.tree_to_numpy(m["tp"])
    assert sorted(back) == sorted(m["flat"])
    for k, v in m["flat"].items():
        np.testing.assert_array_equal(back[k], v)
    kinds = {b.ffn for b in m["cfg"].pattern}
    if FFN_MOE in kinds:
        for leaf in ("router", "w_gate", "w_up", "w_down"):
            key = f"body/pos0/moe/{leaf}"
            assert back[key].shape[0] == m["cfg"].num_pattern_repeats
    if "gelu" in kinds:
        assert np.abs(back["body/pos0/ffn/b_up"]).max() > 0
    # and back into JAX's model: the same prefill logits
    toks = np.random.default_rng(2).integers(
        0, m["cfg"].vocab_size, size=(2, 7)).astype(np.int32)
    jp2 = jax.tree_util.tree_map(jnp.asarray, _unflat(back))
    a = JT.prefill(m["jcfg"], m["jp"], jnp.asarray(toks))["logits"]
    b = JT.prefill(m["jcfg"], jp2, jnp.asarray(toks))["logits"]
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ============================================================ the model
def _case_id(c):
    return c[0] + ("" if c[1] is None else f"-cf{c[1]}") + \
        ("-pad" if c[2] else "")


def _record_drops(monkeypatch):
    """Wrap the port's ``moe.dispatch`` and ``T.prefill``: the returned
    list gets (in a left-padded prefill, any assignment dropped) for
    every dispatch."""
    seen, padded = [], [False]
    dispatch, prefill = moe.dispatch, T.prefill

    def rec_dispatch(*a, **kw):
        out = dispatch(*a, **kw)
        seen.append((padded[0], bool((~out["keep"]).any())))
        return out

    def rec_prefill(*a, **kw):
        pad = kw.get("pad")
        padded[0] = pad is not None and bool((pad > 0).any())
        try:
            return prefill(*a, **kw)
        finally:
            padded[0] = False

    monkeypatch.setattr(moe, "dispatch", rec_dispatch)
    monkeypatch.setattr(T, "prefill", rec_prefill)
    return seen


def _prefill_both(m, with_pad):
    toks, pad = _prompts(m["cfg"].vocab_size, with_pad)
    jout = JT.prefill(m["jcfg"], m["jp"], jnp.asarray(toks),
                      max_len=MAX_LEN, pad=jnp.asarray(pad))
    tout = T.prefill(m["cfg"], m["tp"], torch.tensor(toks), max_len=MAX_LEN,
                     pad=torch.tensor(pad))
    return toks, pad, jout, tout


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_prefill_matches_jax(case, monkeypatch):
    """Logits, captures, the cache and the load-balance loss, every row
    (the left pad's included), against JAX's."""
    m = _model(*case[:2])
    drops = _record_drops(monkeypatch)
    toks, pad, jout, tout = _prefill_both(m, case[2])
    s = toks.shape[1]
    np.testing.assert_allclose(_np(tout["logits"]), _np(jout["logits"]),
                               **TOL)
    _rows_close(tout["captures"], jout["captures"], [0] * 3, [s] * 3,
                axis_s=1)
    _cache_close(m["cfg"], tout["cache"], jout["cache"], [0] * 3, [s] * 3)
    np.testing.assert_allclose(float(tout["aux"]), float(jout["aux"]),
                               **TOL)
    if case[0] in MOE_ARCHS and (case[1] == 0.5 or case[2]):
        # 2.0 drops nothing; 1.25 with pads and 0.5 drop in this prefill
        assert any(d for _, d in drops) == (case[1] != NO_DROP_CF), drops
    if case[1] == NO_DROP_CF:
        assert moe._capacity(m["cfg"], toks.size) >= toks.size


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_pad_rows_move_drops(pkg):
    """What a lane's left pad holds reaches its valid rows through a MoE
    layer's capacity, in JAX as in the port: at granite-moe's 1.25 the
    prefill drops assignments, and other tokens at the pad positions
    move another lane's last-position logits; at 2.0 nothing drops and
    they move nothing.  (Why the port's pad rows must be JAX's.)"""
    toks, pad = _prompts(512, True)
    other = toks.copy()
    for b, p in enumerate(pad):
        other[b, :p] = 1 + (np.arange(p) * 37 + 11 * b) % 500
    moved = {}
    for cf in (None, NO_DROP_CF):
        m = _model("granite-moe-3b-a800m", cf)
        if pkg == "jax":
            a, b_ = (np.asarray(JT.prefill(m["jcfg"], m["jp"], jnp.asarray(t),
                                           pad=jnp.asarray(pad))["logits"])
                     for t in (toks, other))
        else:
            a, b_ = (_np(T.prefill(m["cfg"], m["tp"], torch.tensor(t),
                                   pad=torch.tensor(pad))["logits"])
                     for t in (toks, other))
        moved[cf] = float(np.abs(a - b_).max())
    assert moved[None] > 1e-3, moved
    assert moved[NO_DROP_CF] < 2e-5, moved


@pytest.mark.parametrize("kind", ["chain4", "tree13"])
@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_decode_step_matches_jax(case, kind):
    """A verify block after the prefill: chain T 4, or a flattened draft
    tree W 4 gamma 3 (T 13) under the tree mask: logits, captures and
    the cache's rows, the block's included."""
    m = _model(*case[:2])
    toks, pad, jout, tout = _prefill_both(m, case[2])
    s = toks.shape[1]
    tree = (4, 3) if kind == "tree13" else None
    t = 13 if tree else 4
    block = np.random.default_rng(t).integers(
        0, m["cfg"].vocab_size, size=(3, t)).astype(np.int32)
    jd = JT.decode_step(m["jcfg"], m["jp"], jout["cache"],
                        jnp.asarray(block), tree=tree)
    td = T.decode_step(m["cfg"], m["tp"], tout["cache"], torch.tensor(block),
                       tree=tree)
    np.testing.assert_allclose(_np(td["logits"]), _np(jd["logits"]), **TOL)
    np.testing.assert_allclose(_np(td["captures"]), _np(jd["captures"]),
                               **TOL)
    _cache_close(m["cfg"], td["cache"], jd["cache"], [0] * 3, [s + t] * 3)


def _train_batch(vocab, seed=2):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, size=(2, 16)).astype(np.int32)
    tgts = rng.integers(0, vocab, size=(2, 16)).astype(np.int32)
    tgts[0, :3] = -1
    return toks, tgts


@pytest.mark.parametrize("case", TRAIN_CASES, ids=_case_id)
def test_forward_train_matches_jax(case):
    m = _model(*case[:2])
    toks, tgts = _train_batch(m["cfg"].vocab_size)
    jl, jmet = JT.forward_train(m["jcfg"], m["jp"],
                                {"tokens": jnp.asarray(toks),
                                 "targets": jnp.asarray(tgts)})
    with torch.no_grad():
        tl, tmet = T.forward_train(m["cfg"], m["tp"],
                                   {"tokens": torch.tensor(toks),
                                    "targets": torch.tensor(tgts)})
    for got, want in ((tl, jl), (tmet["ce"], jmet["ce"]),
                      (tmet["aux"], jmet["aux"])):
        np.testing.assert_allclose(float(got), float(want), **TOL)
    moe_layers = sum(b.ffn == FFN_MOE for b in m["cfg"].layer_kinds)
    assert (float(tmet["aux"]) > 0) == (moe_layers > 0)


@pytest.mark.parametrize("case", [("starcoder2-7b", None, False),
                                  ("granite-moe-3b-a800m", 0.5, False)],
                         ids=_case_id)
def test_forward_train_gradients_match_jax(case):
    """Every leaf's gradient of the loss (ce + aux) against JAX's, the
    GELU biases and the router included."""
    m = _model(*case[:2])
    toks, tgts = _train_batch(m["cfg"].vocab_size, seed=3)

    def jloss(p):
        return JT.forward_train(m["jcfg"], p, {
            "tokens": jnp.asarray(toks), "targets": jnp.asarray(tgts)})[0]

    jg = _flatten(jax.grad(jloss)(m["jp"]))
    leaves = {k: torch.tensor(v, requires_grad=True)
              for k, v in m["flat"].items()}
    from repro_torch.models.param import unflatten
    loss, _ = T.forward_train(m["cfg"], unflatten(leaves),
                              {"tokens": torch.tensor(toks),
                               "targets": torch.tensor(tgts)})
    grads = torch.autograd.grad(loss, list(leaves.values()))
    for k, g in zip(leaves, grads):
        np.testing.assert_allclose(g.numpy(), jg[k], err_msg=k, **TOL)


# ================================================= engine streams
def _draft(arch):
    m = _model(arch)
    key = ("draft", arch)
    if key not in _MODELS:
        jdcfg = jeagle.draft_config(m["jcfg"])
        jdp = jeagle.draft_init(jdcfg, jax.random.key(7))
        dcfg = eagle.draft_config(m["cfg"])
        _MODELS[key] = dict(jdcfg=jdcfg, jdp=jdp, dcfg=dcfg,
                            tdp=bridge.draft_from_numpy(dcfg, _flatten(jdp),
                                                        device="cpu"))
    return m, _MODELS[key]


def _requests(vocab):
    rng = np.random.default_rng(6)
    prompts = [[int(t) for t in rng.integers(1, vocab, int(n))]
               for n in rng.integers(8, 25, size=6)]
    return prompts, [12, 7, 12, 9, 5, 12]


def _serve_port(arch, paged=False, rounds=4, stream=True):
    m, d = _draft(arch)
    prompts, budgets = _requests(m["cfg"].vocab_size)
    conf = dict(batch_size=2, max_len=96, gamma=3, superstep_rounds=rounds)
    if paged:
        conf.update(page_size=8)
    eng = ServingEngine(m["cfg"], m["tp"], d["dcfg"], d["tdp"], device="cpu",
                        config=ServingConfig(**conf))
    reqs = [Request(prompt=list(p), max_new_tokens=b)
            for p, b in zip(prompts, budgets)]
    if stream:
        eng.serve_stream(iter(reqs))
    else:
        for i in range(0, len(reqs), 2):
            eng.serve_wave(reqs[i:i + 2])
    assert all(len(r.generated) == b for r, b in zip(reqs, budgets))
    if eng.allocator is not None:
        eng.release_prefix_cache()
        eng.allocator.assert_clean()
    return [list(r.generated) for r in reqs], eng


def _serve_jax(arch, paged=False):
    m, d = _draft(arch)
    prompts, budgets = _requests(m["cfg"].vocab_size)
    conf = dict(batch_size=2, max_len=96, gamma=3, superstep_rounds=0)
    if paged:
        conf.update(page_size=8)
    eng = JaxEngine(m["jcfg"], m["jp"], d["jdcfg"], d["jdp"],
                    config=JaxConfig(**conf))
    reqs = [JaxRequest(prompt=list(p), max_new_tokens=b)
            for p, b in zip(prompts, budgets)]
    eng.serve_stream(iter(reqs))
    return [list(r.generated) for r in reqs]


def _assert_streams_match(arch, got, want):
    """Equal streams, or a first departure at a near-tie of the JAX
    target's greedy logits (a plain prefill of prompt + common prefix)."""
    m = _model(arch)
    prompts, _ = _requests(m["cfg"].vocab_size)
    ties = 0
    for prompt, g, w in zip(prompts, got, want):
        assert len(g) == len(w)
        if g == w:
            continue
        i = next(j for j in range(len(g)) if g[j] != w[j])
        seq = jnp.asarray([list(prompt) + w[:i]], jnp.int32)
        logits = np.asarray(JT.prefill(m["jcfg"], m["jp"], seq)["logits"][0])
        top = np.sort(logits)[-2:]
        assert top[1] - top[0] < NEAR_TIE, (
            f"stream departs at step {i} with top-2 gap {top[1] - top[0]}")
        ties += 1
    assert ties <= 1, f"{ties} near-tie flips: too many to be ties"


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "starcoder2-7b"])
def test_greedy_streams_equal_jax(arch, paged, monkeypatch):
    """At the configs' own capacity factor; granite's serve drops
    assignments in a left-padded refill."""
    want = _serve_jax(arch, paged)
    drops = _record_drops(monkeypatch)
    got, eng = _serve_port(arch, paged)
    _assert_streams_match(arch, got, want)
    assert eng.stats.spec_steps > 0
    if arch in MOE_ARCHS:
        assert any(p and d for p, d in drops), drops


def test_granite_port_ladder():
    """Inside the port: stepwise == superstep (waves), stream == wave, and
    paged == dense, on granite-moe (every shape kept: the same refill
    batches and verify blocks, so the same capacities)."""
    w0, _ = _serve_port("granite-moe-3b-a800m", rounds=0, stream=False)
    w8, _ = _serve_port("granite-moe-3b-a800m", rounds=8, stream=False)
    s4, _ = _serve_port("granite-moe-3b-a800m", rounds=4)
    s0, _ = _serve_port("granite-moe-3b-a800m", rounds=0)
    p4, _ = _serve_port("granite-moe-3b-a800m", paged=True, rounds=4)
    assert w8 == w0
    assert s4 == s0 == p4
    assert s4 == w0


# ======================================================== entry points
@pytest.mark.parametrize("arch", ARCHS)
def test_launch_serve_and_train_take_the_arch(arch):
    """``launch.serve`` serves the arch's REDUCED (the CLI's own choice for
    any --arch but tide-tiny) and ``launch.train`` trains it, with no
    refusal."""
    sys_, done = serve.main(["--arch", arch, "--requests", "4",
                             "--pretrain-steps", "2", "--max-new-tokens",
                             "6", "--no-adaptive"], device="cpu")
    assert sys_.engine.cfg == get_reduced(arch)
    assert len(done) == 4 and all(len(r.generated) == 6 for r in done)
    log = train.main(["--arch", arch, "--steps", "2", "--batch", "2",
                      "--seq", "16"], device="cpu")
    assert len(log) == 2 and all(np.isfinite(e["loss"]) for e in log)


@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "jamba-1.5-large-398b",
                                  "rwkv6-3b", "llama-3.2-vision-11b",
                                  "whisper-base"])
def test_unported_families_are_refused(arch):
    """The zoo's other families raise, naming ROADMAP queue 1 item 8,
    from the registry and from both CLIs."""
    assert arch in C._ALIASES
    with pytest.raises(NotImplementedError, match="item 8"):
        get(arch)
    with pytest.raises(NotImplementedError, match="item 8"):
        serve.main(["--arch", arch, "--requests", "1"], device="cpu")
    with pytest.raises(NotImplementedError, match="item 8"):
        train.main(["--arch", arch, "--steps", "1"], device="cpu")
