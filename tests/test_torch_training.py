"""The port's draft training against the JAX package on the CPU (tide_tiny,
fixed seeds; JAX is the oracle).

* Optimizers: ``adamw``, ``adafactor``, ``clip_by_global_norm`` and
  ``global_norm`` against JAX's on the same params, grads and steps; the
  optimizer state crosses to numpy under JAX's keys.
* The plain backward of the prefill attention, ``flash_attention_bwd_ref``,
  against ``torch.autograd`` through ``attend`` and against ``jax.vjp`` of
  the JAX jnp attention, at S that are not a multiple of the kernel's
  32-key tile and at GQA groups G > 1; ``FlashAttentionFn`` on the CPU;
  the refusals of a gradient the backward kernel cannot give.
* ``eagle.draft_train_loss``: the value, the accuracy and every
  parameter's gradient against ``jax.value_and_grad`` of JAX's, with and
  without the TTT term and a mask, on bridged draft weights.
* ``DraftTrainer.train_cycle`` from identical signals and init: the same
  batch order, per-step losses, step count and accuracies as JAX's
  trainer, and the trained draft's weights.
* The replay: a tide_tiny target pretrained as in tests/test_torch_tree.py
  serves 8 requests through the port's engine, its draft trains on the
  engine's own signals, and the same requests served again give the same
  streams with a higher mean accepted length.

Tolerances are stated where they are used; fp32 throughout (tide_tiny)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import repro.configs as C  # noqa: E402
from repro.checkpoint.ckpt import _flatten  # noqa: E402
from repro.core import eagle as jeagle  # noqa: E402
from repro.core.signals import SignalBatch as JaxSignalBatch  # noqa: E402
from repro.data.workloads import make_domains, training_corpus  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro.training.draft_trainer import DraftTrainer as JaxTrainer  # noqa: E402
from repro.training.trainer import pretrain_target  # noqa: E402
from repro_torch.checkpoint import bridge  # noqa: E402
from repro_torch.configs import get  # noqa: E402
from repro_torch.core import eagle  # noqa: E402
from repro_torch.core.signals import (SignalBatch, SignalExtractor,  # noqa: E402
                                      SignalStore)
from repro_torch.kernels.flash_attn import ops  # noqa: E402
from repro_torch.kernels.flash_attn.ref import (  # noqa: E402
    flash_attention_bwd_ref, flash_attention_lse_ref, flash_attention_ref)
from repro_torch.models.attention import attend  # noqa: E402
from repro_torch.models.param import unflatten  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from repro_torch.serving.request import Request  # noqa: E402
from repro_torch.training import optimizer as topt  # noqa: E402
from repro_torch.training.draft_trainer import DraftTrainer  # noqa: E402

OPT_TOL = dict(rtol=2e-5, atol=2e-7)     # fp32, one update


def _np(x):
    return x.detach().float().numpy()


def _leaves(seed):
    """A flat dict of fp32 leaves of the shapes optimizers meet: matrices,
    a stacked 3-d leaf and vectors; keys in sorted order."""
    rng = np.random.default_rng(seed)
    shapes = {"attn/wq": (8, 2, 4), "fc": (6, 5), "norm/scale": (5,),
              "w": (3, 7)}
    return {k: rng.normal(size=s).astype(np.float32)
            for k, s in sorted(shapes.items())}


def _jtree(flat):
    return jax.tree.map(jnp.asarray, unflatten(dict(flat)))


def _tflat(flat):
    return {k: torch.tensor(v) for k, v in flat.items()}


def _run_opt(jo, to, steps, grad_scale):
    """Run a JAX and a port optimizer ``steps`` steps on the same params
    and grads.  Returns (JAX params, JAX state, port params, port
    state)."""
    p = _leaves(0)
    jp, tp = _jtree(p), _tflat(p)
    js, ts = jo.init(jp), to.init(tp)
    for step in range(steps):
        g = {k: v * grad_scale for k, v in _leaves(10 + step).items()}
        jp, js = jo.update(jp, _jtree(g), js, jnp.int32(step))
        tp, ts = to.update(tp, _tflat(g), ts, step)
    return jp, js, tp, ts


# ============================================================ optimizers
@pytest.mark.parametrize("wd,clip,scale", [(0.0, 1.0, 1.0), (0.01, 1.0, 0.01),
                                           (0.1, 0.0, 3.0)])
def test_adamw_matches_jax(wd, clip, scale):
    """Three AdamW steps (clip active at scale 1 and 3 with clip 1, off at
    clip 0): params and both moments at fp32 rtol 2e-5."""
    jp, js, tp, ts = _run_opt(jopt.adamw(lr=1e-2, weight_decay=wd,
                                         grad_clip=clip),
                              topt.adamw(lr=1e-2, weight_decay=wd,
                                         grad_clip=clip), 3, scale)
    for k, v in _flatten(jp).items():
        np.testing.assert_allclose(_np(tp[k]), v, **OPT_TOL, err_msg=k)
    want = _flatten(js)
    got = bridge.tree_to_numpy(ts)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **OPT_TOL, err_msg=k)


@pytest.mark.parametrize("wd", [0.0, 0.05])
def test_adafactor_matches_jax(wd):
    """Three Adafactor steps (factored moments of the 2-d and 3-d leaves,
    the plain one of the vector): params and state at fp32 rtol 2e-5."""
    jp, js, tp, ts = _run_opt(jopt.adafactor(lr=1e-2, weight_decay=wd),
                              topt.adafactor(lr=1e-2, weight_decay=wd),
                              3, 1.0)
    for k, v in _flatten(jp).items():
        np.testing.assert_allclose(_np(tp[k]), v, **OPT_TOL, err_msg=k)
    want = _flatten(js)
    got = bridge.tree_to_numpy(ts)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **OPT_TOL, err_msg=k)


@pytest.mark.parametrize("max_norm", [0.5, 1e3, 0.0])
def test_clip_by_global_norm_matches_jax(max_norm):
    g = _leaves(3)
    want = _flatten(jopt.clip_by_global_norm(_jtree(g), max_norm))
    got = topt.clip_by_global_norm(_tflat(g), max_norm)
    for k in want:
        np.testing.assert_allclose(_np(got[k]), want[k], **OPT_TOL)
    np.testing.assert_allclose(float(topt.global_norm(_tflat(g))),
                               float(jopt.global_norm(_jtree(g))), rtol=2e-6)


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_opt_state_crosses_from_numpy(kind):
    """JAX's state, flattened to numpy, becomes a port state that
    continues the run exactly as the port's own would."""
    jo, to = getattr(jopt, kind)(lr=1e-2), getattr(topt, kind)(lr=1e-2)
    jp, js, tp, ts = _run_opt(jo, to, 2, 1.0)
    load = getattr(bridge, f"{kind}_state_from_numpy")
    ts2 = load(_flatten(js), device="cpu")
    assert bridge.tree_to_numpy(ts2).keys() == bridge.tree_to_numpy(ts).keys()
    g = _tflat(_leaves(50))
    a, _ = to.update({k: v.clone() for k, v in tp.items()}, g, ts, 2)
    b, _ = to.update({k: v.clone() for k, v in tp.items()}, g, ts2, 2)
    for k in a:
        np.testing.assert_allclose(_np(a[k]), _np(b[k]), **OPT_TOL)


def test_adamw_leaves_grads_and_keeps_dtype():
    """The in-place update leaves the caller's grads as they were and
    keeps a bf16 leaf bf16 (one cast per step)."""
    p = {"a": torch.randn(4, 3, dtype=torch.bfloat16), "b": torch.randn(3)}
    g = {"a": torch.randn(4, 3, dtype=torch.bfloat16), "b": torch.randn(3)}
    g0 = {k: v.clone() for k, v in g.items()}
    opt = topt.adamw(lr=1e-2, grad_clip=0.0)
    p, _ = opt.update(p, g, opt.init(p), 0)
    assert p["a"].dtype == torch.bfloat16
    assert all(torch.equal(g[k], g0[k]) for k in g)


# ======================================================= plain backward
BWD_SHAPES = [(2, 33, 8, 2, 32), (1, 1, 4, 4, 64), (2, 70, 4, 1, 64),
              (1, 96, 16, 1, 128)]


def _bwd_inputs(b, s, hq, hk, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=sh) for sh in
            ((b, s, hq, d), (b, s, hk, d), (b, s, hk, d), (b, s, hq, d))]


@pytest.mark.parametrize("b,s,hq,hk,d", BWD_SHAPES)
def test_flash_bwd_ref_vs_autograd_attend(b, s, hq, hk, d):
    """The plain backward against torch.autograd through ``attend``
    (float64).  Tolerance 1e-5: the LSE the backward reads is stored in
    float32, as the kernel stores it (relative error ~6e-8 in P)."""
    q, k, v, do = [torch.tensor(x, requires_grad=i < 3) for i, x in
                   enumerate(_bwd_inputs(b, s, hq, hk, d, 1))]
    o = flash_attention_ref(q, k, v)
    want = torch.autograd.grad(o, (q, k, v), do)
    lse = flash_attention_lse_ref(q.detach(), k.detach())
    got = flash_attention_bwd_ref(q.detach(), k.detach(), v.detach(),
                                  o.detach(), do, lse)
    for name, x, y in zip("qkv", got, want):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=f"d{name}")


@pytest.mark.parametrize("b,s,hq,hk,d", BWD_SHAPES)
def test_flash_bwd_ref_vs_jax_vjp(b, s, hq, hk, d):
    """The plain backward against ``jax.vjp`` of the JAX jnp attention
    (``models/attention.attend``, causal mask), fp32 in JAX: rtol/atol
    2e-5 after scaling by the gradient's largest element (at least 1)."""
    q, k, v, do = [x.astype(np.float32) for x in _bwd_inputs(b, s, hq, hk,
                                                              d, 2)]
    msk = jnp.tril(jnp.ones((s, s), bool))[None, None, None]
    o, vjp = jax.vjp(lambda a, b_, c: jattn.attend(a, b_, c, msk),
                     *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(do))
    tq, tk, tv = map(torch.tensor, (q, k, v))
    lse = flash_attention_lse_ref(tq, tk)
    got = flash_attention_bwd_ref(tq, tk, tv, torch.tensor(np.asarray(o)),
                                  torch.tensor(do), lse)
    for name, x, y in zip("qkv", got, want):
        y = np.asarray(y)
        scale = max(np.abs(y).max(), 1.0)   # dq is 0 at S = 1
        np.testing.assert_allclose(x.numpy() / scale, y / scale, rtol=2e-5,
                                   atol=2e-5, err_msg=f"d{name}")


def test_lse_ref_is_row_logsumexp():
    q, k, _, _ = [torch.tensor(x) for x in _bwd_inputs(2, 40, 4, 2, 32, 3)]
    lse = flash_attention_lse_ref(q, k)
    scores = torch.einsum("bthd,bshd->bhts", q,
                          k.repeat_interleave(2, dim=2)) / np.sqrt(32)
    mask = torch.ones(40, 40, dtype=torch.bool).tril()
    want = torch.logsumexp(scores.masked_fill(~mask, float("-inf")), -1)
    np.testing.assert_allclose(lse.numpy(), want.transpose(1, 2).numpy(),
                               rtol=1e-6, atol=1e-6)
    out, lse2 = ops.flash_attention(q.float(), k.float(), k.float(),
                                    return_lse=True)
    assert torch.equal(out, ops.flash_attention(q.float(), k.float(),
                                                k.float()))
    np.testing.assert_allclose(lse2.numpy(), lse.numpy(), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("b,s,hq,hk,d", BWD_SHAPES[:3])
def test_flash_attention_fn_on_cpu(b, s, hq, hk, d):
    """``attention_train`` with a gradient goes through FlashAttentionFn
    (one forward, one backward call of the wrappers; the CPU runs their
    plain versions and counts no launch): output and gradients equal to
    autograd through ``attend`` at fp32 rtol/atol 2e-5."""
    q, k, v, do = [torch.tensor(x, dtype=torch.float32,
                                requires_grad=i < 3)
                   for i, x in enumerate(_bwd_inputs(b, s, hq, hk, d, 4))]
    mask = torch.ones(s, s, dtype=torch.bool).tril()[None, None, None]
    n0 = (ops.flash_attention.launches, ops.flash_attention_bwd.launches)
    out = ops.attention_train(q, k, v)
    assert out.grad_fn is not None and "FlashAttentionFn" in \
        type(out.grad_fn).__name__
    got = torch.autograd.grad(out, (q, k, v), do)
    assert n0 == (ops.flash_attention.launches,
                  ops.flash_attention_bwd.launches), "CPU call counted"
    ref = attend(q, k, v, mask)
    want = torch.autograd.grad(ref, (q, k, v), do)
    np.testing.assert_allclose(_np(out), _np(ref), rtol=2e-5, atol=2e-5)
    for x, y in zip(got, want):
        np.testing.assert_allclose(_np(x), _np(y), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("kind", ["pad", "window", "softcap", "noncausal",
                                  "head_dim"])
def test_attention_gradient_refused(kind):
    """A gradient the backward kernel cannot give raises
    NotImplementedError, on the CPU as on the card: nothing falls back to
    the plain attention.  Without a gradient the same call runs."""
    d = 48 if kind == "head_dim" else 32
    q, k, v = [torch.randn(1, 8, 2, d, requires_grad=True) for _ in range(3)]
    kw = {"pad": dict(pad=torch.tensor([2])), "window": dict(window=4),
          "softcap": dict(softcap=30.0), "noncausal": dict(causal=False),
          "head_dim": {}}[kind]
    with pytest.raises(NotImplementedError):
        ops.attention_train(q, k, v, **kw)
    with torch.no_grad():
        ops.attention_train(q, k, v, **kw)
    if kind == "head_dim":
        with pytest.raises(NotImplementedError):
            ops.flash_attention_bwd(q.detach(), k.detach(), v.detach(),
                                    q.detach(), q.detach(),
                                    torch.zeros(1, 8, 2))


# ============================================================ the loss
@pytest.fixture(scope="module")
def tiny():
    """tide_tiny at init (JAX) with its draft, bridged into the port, and
    random signals (features of the captures' scale, tokens in the
    vocab)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    jcfg = C.get("tide-tiny")
    jdcfg = jeagle.draft_config(jcfg)
    jp = jax.jit(JT.init, static_argnums=0)(jcfg, jax.random.key(0))
    jdp = jax.jit(jeagle.draft_init, static_argnums=0)(jdcfg,
                                                       jax.random.key(7))
    cfg = get("tide-tiny")
    dcfg = eagle.draft_config(cfg)
    tp = bridge.target_from_numpy(cfg, _flatten(jp), device="cpu")
    rng = np.random.default_rng(0)
    b, s = 3, 21
    feats = rng.normal(size=(b, s, 3 * cfg.d_model)).astype(np.float32)
    toks = rng.integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32)
    mask = rng.random((b, s)) < 0.7
    yield dict(jcfg=jcfg, jdcfg=jdcfg, jp=jp, jdp=jdp, cfg=cfg, dcfg=dcfg,
               tp=tp, feats=feats, toks=toks, mask=mask)
    torch.set_num_threads(threads)


def _port_loss(tiny, ttt, mask):
    params = {k: torch.tensor(v, requires_grad=True)
              for k, v in _flatten(tiny["jdp"]).items()}
    loss, m = eagle.draft_train_loss(
        tiny["dcfg"], unflatten(params), tiny["tp"]["embed"],
        torch.tensor(tiny["feats"]), torch.tensor(tiny["toks"]), ttt=ttt,
        mask=None if mask is None else torch.tensor(mask))
    grads = torch.autograd.grad(loss, list(params.values()))
    return (float(loss.detach()), float(m["accuracy"]),
            dict(zip(params, grads)))


@pytest.mark.parametrize("ttt", [True, False], ids=["ttt", "no_ttt"])
@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
def test_draft_train_loss_matches_jax(tiny, ttt, masked):
    """Loss, accuracy and the gradient of every draft leaf against
    ``jax.value_and_grad`` of JAX's ``draft_train_loss``: loss at rtol
    2e-5, accuracy exactly, each gradient at rtol/atol 2e-4 of its
    largest element (fp32 through two layers and a 512-way softmax; the
    port's attention runs in float64 on the CPU, JAX's in fp32)."""
    mask = tiny["mask"] if masked else None

    def jloss(dp):
        return jeagle.draft_train_loss(
            tiny["jdcfg"], dp, tiny["jp"]["embed"], jnp.asarray(tiny["feats"]),
            jnp.asarray(tiny["toks"]), ttt=ttt,
            mask=None if mask is None else jnp.asarray(mask))

    (jl, jm), jg = jax.value_and_grad(jloss, has_aux=True)(tiny["jdp"])
    loss, acc, grads = _port_loss(tiny, ttt, mask)
    np.testing.assert_allclose(loss, float(jl), rtol=2e-5)
    assert acc == pytest.approx(float(jm["accuracy"]), abs=1e-7)
    want = _flatten(jg)
    assert set(grads) == set(want)
    for k, w in want.items():
        scale = max(np.abs(w).max(), 1e-12)
        np.testing.assert_allclose(_np(grads[k]) / scale, w / scale,
                                   rtol=2e-4, atol=2e-4, err_msg=k)


# ========================================================= the trainer
@pytest.fixture(scope="module")
def pretrained():
    """tide_tiny pretrained in JAX (40 steps, as tests/test_torch_tree.py),
    a freshly initialised draft, and 16 signal windows: the target's
    captures of 16 corpus sequences with the tokens that followed them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    jcfg = C.get("tide-tiny")
    jdcfg = jeagle.draft_config(jcfg)
    jp = jax.jit(JT.init, static_argnums=0)(jcfg, jax.random.key(0))
    domains = make_domains(jcfg.vocab_size, ["science"], branchings=[2],
                           seed=3)
    corpus = training_corpus(domains["science"], 64, 40, 1)
    jp, _ = pretrain_target(jcfg, jp, corpus, steps=40, lr=3e-3)
    sub = jnp.asarray(corpus[:16])
    caps = np.asarray(jax.jit(lambda p, x: JT.prefill(jcfg, p, x)["captures"])(
        jp, sub))
    toks = np.asarray(sub)
    windows = [(caps[i, :-1], toks[i, 1:]) for i in range(16)]
    jdp = jax.jit(jeagle.draft_init, static_argnums=0)(jdcfg,
                                                       jax.random.key(7))
    cfg = get("tide-tiny")
    dcfg = eagle.draft_config(cfg)
    tp = bridge.target_from_numpy(cfg, _flatten(jp), device="cpu")
    tdp = bridge.draft_from_numpy(dcfg, _flatten(jdp), device="cpu")
    rng = np.random.default_rng(0)
    prompts = [domains["science"].sample_prompt(rng) for _ in range(8)]
    yield dict(jcfg=jcfg, jdcfg=jdcfg, jp=jp, jdp=jdp, cfg=cfg, dcfg=dcfg,
               tp=tp, tdp=tdp, windows=windows, prompts=prompts)
    torch.set_num_threads(threads)


CYCLE_STEPS = 20


@pytest.fixture(scope="module")
def cycles(pretrained):
    """One 20-step cycle of each trainer on the same windows and init."""
    pt = pretrained
    jt = JaxTrainer(pt["jcfg"], pt["jdcfg"], pt["jp"]["embed"])
    jres = jt.train_cycle(pt["jdp"], [JaxSignalBatch(f, t)
                                      for f, t in pt["windows"]],
                          epochs=1, min_steps=CYCLE_STEPS, seed=3)
    tt = DraftTrainer(pt["cfg"], pt["dcfg"], pt["tp"]["embed"], device="cpu")
    before = bridge.to_numpy(pt["tdp"])
    tres = tt.train_cycle(pt["tdp"], [SignalBatch(f, t)
                                      for f, t in pt["windows"]],
                          epochs=1, min_steps=CYCLE_STEPS, seed=3)
    return dict(jt=jt, jres=jres, tt=tt, tres=tres, before=before)


def test_train_cycle_batch_order_and_steps(cycles):
    """The port draws JAX's batches: the order of
    ``np.random.default_rng(seed).permutation`` over the 15 train windows
    (16 split 9:1), 8 a step, one step an epoch, 20 epochs; one host
    sync a step and one for the eval accuracy."""
    tres, jres, tt = cycles["tres"], cycles["jres"], cycles["tt"]
    assert tres["steps"] == jres["steps"] == CYCLE_STEPS
    rng = np.random.default_rng(3)
    want = [rng.permutation(15)[:8].tolist() for _ in range(CYCLE_STEPS)]
    assert [e["batch"] for e in tt.log] == want
    assert tt.host_syncs == CYCLE_STEPS + 1


def test_train_cycle_losses_track_jax(cycles):
    """Per-step loss of the first 20 steps at rtol 1e-4 (fp32; the
    optimizer's normalised steps carry the gradients' last-ulp
    differences forward), accuracies within 1e-6 (counts over 8 x 62
    labels), and the loss falls."""
    jlog = [e["loss"] for e in cycles["jt"].log]
    tlog = [e["loss"] for e in cycles["tt"].log]
    np.testing.assert_allclose(tlog, jlog, rtol=1e-4)
    assert tlog[-1] < tlog[0]
    for key in ("train_acc", "eval_acc"):
        assert cycles["tres"][key] == pytest.approx(cycles["jres"][key],
                                                    abs=1e-6)


def test_train_cycle_returns_servable_draft(cycles, pretrained):
    """The trained draft is a ParamTree of frozen leaves with the JAX
    trainer's weights (rtol/atol 1e-3 of each leaf's largest element
    after 20 AdamW steps), and the served draft it was trained from is
    unchanged."""
    tres, jres = cycles["tres"], cycles["jres"]
    assert isinstance(tres["dparams"], type(pretrained["tdp"]))
    assert not any(p.requires_grad for p in tres["dparams"].parameters())
    got = bridge.to_numpy(tres["dparams"])
    want = _flatten(jres["dparams"])
    assert set(got) == set(want)
    for k in want:
        scale = max(np.abs(want[k]).max(), 1e-12)
        np.testing.assert_allclose(got[k] / scale, want[k] / scale,
                                   rtol=1e-3, atol=1e-3, err_msg=k)
    after = bridge.to_numpy(pretrained["tdp"])
    assert all(np.array_equal(after[k], cycles["before"][k]) for k in after)


def test_make_arrays_matches_jax(pretrained):
    """``_stack`` truncates every window to the shortest and the split is
    9:1, as JAX's."""
    ws = [SignalBatch(f[:n], t[:n]) for (f, t), n in
          zip(pretrained["windows"], [63, 40, 55, 63, 20, 63, 63, 63, 63, 63,
                                      63, 63])]
    jws = [JaxSignalBatch(b.feats, b.tokens) for b in ws]
    pt = pretrained
    got = DraftTrainer(pt["cfg"], pt["dcfg"], pt["tp"]["embed"],
                       device="cpu").make_arrays(ws)
    want = JaxTrainer(pt["jcfg"], pt["jdcfg"],
                      pt["jp"]["embed"]).make_arrays(jws)
    for a, b in zip(got, want):
        for x, y in zip(a, b):
            assert np.array_equal(x, y)
    assert got[0][0].shape == (11, 20, 384)


def test_trainer_needs_a_card_or_cpu(pretrained, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        DraftTrainer(pretrained["cfg"], pretrained["dcfg"],
                     pretrained["tp"]["embed"])


# ============================================================ the replay
def _serve(pt, dparams, store=None):
    eng = ServingEngine(pt["cfg"], pt["tp"], pt["dcfg"], dparams,
                        batch_size=4, max_len=128, gamma=3,
                        superstep_rounds=8, device="cpu",
                        extractor=SignalExtractor(store or SignalStore(),
                                                  window=16))
    reqs = [Request(prompt=list(p), max_new_tokens=33)
            for p in pt["prompts"]]
    eng.serve_stream(iter(reqs))
    assert all(r.finish_t is not None for r in reqs)
    return [list(r.generated) for r in reqs], eng.stats.accept_len


def test_replay_after_training_on_own_signals(pretrained):
    """Serve 8 requests, train the draft on the engine's own signals
    (200 steps), serve the same requests again with the trained draft:
    the streams are equal (greedy: the target decides every token) and
    the mean accepted length rises."""
    pt = pretrained
    store = SignalStore()
    before, acc0 = _serve(pt, pt["tdp"], store)
    batches = store.drain()
    assert batches and all(len(b.tokens) == 16 for b in batches)
    trainer = DraftTrainer(pt["cfg"], pt["dcfg"], pt["tp"]["embed"],
                           device="cpu")
    res = trainer.train_cycle(pt["tdp"], batches, min_steps=200)
    losses = [e["loss"] for e in trainer.log]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    after, acc1 = _serve(pt, res["dparams"])
    assert after == before
    assert acc1 > acc0, (acc0, acc1)
