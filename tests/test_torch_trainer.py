"""The port's target trainer against the JAX package on the CPU (tide_tiny,
fp32, JAX-initialised weights bridged with ``checkpoint/bridge.py``, fixed
seeds; JAX is the oracle).

* ``transformer.forward_train``: loss and metrics (ce, aux, accuracy)
  at rtol/atol 2e-5, with and without masked targets, and every leaf's
  gradient against ``jax.grad`` within 1e-5 of the leaf's largest
  gradient; ``remat=True`` gives the gradients of ``remat=False``
  exactly; a non-attention block is refused, naming ROADMAP item 8.
* ``trainer.make_train_step``: three steps of adamw and adafactor at
  ``n_micro`` 1 and 2 (fp32 accumulation), each from JAX's params and
  state: metrics (loss, ce, accuracy, aux, grad_norm) and params at
  2e-5 (AdamW's elements with |g| within 100 eps at 2 lr; the test
  says why), optimizer state at OPT_TOL; ``_split_microbatches``
  refuses an indivisible batch.
* ``trainer.pretrain_target``: ten chained steps from the same weights
  and corpus give JAX's losses (rtol 1e-4) and weights (each leaf
  within relative L2 1e-3: chained AdamW steps carry an eps-level
  element's difference into every later gradient, so elementwise they
  are held only step by step, above).
* The optimizers' in-place updates equal the functional formulas, bit
  for bit, in bf16, and leave the gradients untouched."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import repro.configs as C  # noqa: E402
from repro.checkpoint.ckpt import _flatten  # noqa: E402
from repro.data.workloads import make_domains, training_corpus  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro.training import trainer as jtrainer  # noqa: E402
from repro_torch.checkpoint import bridge  # noqa: E402
from repro_torch.configs import get  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.config import FFN_SWIGLU, MAMBA, BlockDef  # noqa: E402
from repro_torch.models.param import unflatten  # noqa: E402
from repro_torch.training import optimizer as topt  # noqa: E402
from repro_torch.training import trainer  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)        # fp32 losses, metrics, params
OPT_TOL = dict(rtol=2e-5, atol=2e-7)    # optimizer state, one update
GRAD_TOL = 1e-5                         # of each leaf's largest gradient


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads, as the other port test files take: the suite
    runs in several worker processes, and torch's default of one thread
    a core makes its small ops wait on each other's spinning threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def model():
    """tide_tiny, JAX's weights (seed 0) and their flat numpy form."""
    cfg_j, cfg = C.get("tide-tiny"), get("tide-tiny")
    jp = JT.init(cfg_j, jax.random.key(0))
    flat = {k: np.asarray(v) for k, v in _flatten(jp).items()}
    return cfg_j, cfg, jp, flat


def _leaves(flat, grad=True):
    return {k: torch.tensor(v).requires_grad_(grad) for k, v in flat.items()}


def _batch(cfg, b=4, s=16, seed=0, masked=False):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    tgts = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    if masked:
        tgts[0, :5] = -1
        tgts[-1, -3:] = -1
    return toks, tgts


def _close_grads(got, want):
    for k, w in want.items():
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(got[k] - w).max())
        assert err <= GRAD_TOL * scale, f"{k}: {err} vs scale {scale}"


# ======================================================== forward_train
@pytest.mark.parametrize("masked", [False, True])
def test_forward_train_matches_jax(model, masked):
    cfg_j, cfg, jp, flat = model
    toks, tgts = _batch(cfg, masked=masked)

    def jloss(p):
        return JT.forward_train(cfg_j, p, {"tokens": jnp.asarray(toks),
                                           "targets": jnp.asarray(tgts)},
                                remat=False)
    (jl, jm), jg = jax.value_and_grad(jloss, has_aux=True)(jp)
    tp = _leaves(flat)
    loss, m = T.forward_train(cfg, unflatten(tp),
                              {"tokens": torch.tensor(toks),
                               "targets": torch.tensor(tgts)}, remat=False)
    grads = torch.autograd.grad(loss, list(tp.values()))
    np.testing.assert_allclose(float(loss.detach()), float(jl), **TOL)
    assert set(m) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), **TOL,
                                   err_msg=k)
    _close_grads({k: g.numpy() for k, g in zip(tp, grads)},
                 {k: np.asarray(v) for k, v in _flatten(jg).items()})


def test_remat_gives_the_same_gradients(model):
    _, cfg, _, flat = model
    toks, tgts = _batch(cfg, seed=1, masked=True)
    batch = {"tokens": torch.tensor(toks), "targets": torch.tensor(tgts)}
    out = []
    for remat in (False, True):
        tp = _leaves(flat)
        loss, _ = T.forward_train(cfg, unflatten(tp), batch, remat=remat)
        out.append((loss, torch.autograd.grad(loss, list(tp.values()))))
    (l0, g0), (l1, g1) = out
    assert torch.equal(l0, l1)
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)


def test_forward_train_on_a_param_tree(model):
    """A ``ParamTree`` (frozen leaves) runs the same forward as its flat
    leaves, with no gradient."""
    _, cfg, _, flat = model
    toks, tgts = _batch(cfg, seed=2)
    batch = {"tokens": torch.tensor(toks), "targets": torch.tensor(tgts)}
    tree = bridge.target_from_numpy(cfg, flat, device="cpu")
    with torch.no_grad():
        a, _ = T.forward_train(cfg, tree, batch, remat=False)
        b, _ = T.forward_train(cfg, unflatten(_leaves(flat, grad=False)),
                               batch, remat=False)
    assert torch.equal(a, b)


def test_non_attention_block_is_refused(model):
    _, cfg, _, flat = model
    bad = dataclasses.replace(cfg, pattern=(BlockDef(MAMBA, FFN_SWIGLU),))
    toks, tgts = _batch(cfg)
    with pytest.raises(NotImplementedError, match="item 8"):
        T.forward_train(bad, unflatten(_leaves(flat)),
                        {"tokens": torch.tensor(toks),
                         "targets": torch.tensor(tgts)})


# ======================================================= make_train_step
def test_split_microbatches_refuses_an_indivisible_batch():
    batch = {"tokens": torch.zeros((6, 4)), "targets": torch.zeros((6, 4))}
    with pytest.raises(ValueError, match="microbatches"):
        trainer._split_microbatches(batch, 4)
    out = trainer._split_microbatches(batch, 3)
    assert out["tokens"].shape == (3, 2, 4)


def _port_state(kind, js):
    flat = {k: np.asarray(v) for k, v in _flatten(js).items()}
    return getattr(bridge, f"{kind}_state_from_numpy")(flat, device="cpu")


@pytest.mark.parametrize("n_micro", [1, 2])
@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_train_step_matches_jax(model, kind, n_micro):
    """Three steps, each from JAX's params and optimizer state of the
    step before: the metrics at 2e-5, the params at 2e-5 and the state
    at OPT_TOL.  AdamW's first step moves an element by lr·g/(|g| + eps):
    where |g| is within 100 eps (1e-6), an fp32 rounding of g moves the
    result by up to lr, so there the param is held only within 2 lr (an
    Adam step moves it by at most about lr either way).  Chained steps
    would carry such an element's difference into every gradient after
    it."""
    cfg_j, cfg, jp, flat = model
    jo = getattr(jopt, kind)(lr=1e-2)
    to = getattr(topt, kind)(lr=1e-2)
    jstep = jax.jit(jtrainer.make_train_step(cfg_j, jo, n_micro=n_micro,
                                             remat=False))
    tstep = trainer.make_train_step(cfg, to, n_micro=n_micro, remat=False)
    js = jo.init(jp)
    for step in range(3):
        toks, tgts = _batch(cfg, seed=10 + step, masked=step == 1)
        tp = _leaves({k: np.asarray(v) for k, v in _flatten(jp).items()})
        tp, ts, tm = tstep(tp, _port_state(kind, js),
                           {"tokens": torch.tensor(toks),
                            "targets": torch.tensor(tgts)}, step)
        jp, js, jm = jstep(jp, js, {"tokens": jnp.asarray(toks),
                                    "targets": jnp.asarray(tgts)},
                           jnp.int32(step))
        assert set(tm) == set(jm)
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), **TOL,
                                       err_msg=f"step {step} {k}")
        want_state = {k: np.asarray(v) for k, v in _flatten(js).items()}
        got_state = bridge.tree_to_numpy(ts)
        assert set(got_state) == set(want_state)
        for k, v in want_state.items():
            np.testing.assert_allclose(got_state[k], v, **OPT_TOL,
                                       err_msg=f"step {step} {k}")
        for k, v in _flatten(jp).items():
            got, want = tp[k].detach().numpy(), np.asarray(v)
            loose = np.zeros(want.shape, bool)
            if kind == "adamw":
                t = step + 1
                vh = want_state[f"v/{k}"] / (1 - 0.999 ** t)
                loose = np.sqrt(vh) < 100 * 1e-8
            np.testing.assert_allclose(got[~loose], want[~loose], **TOL,
                                       err_msg=f"step {step} {k}")
            assert np.all(np.abs(got[loose] - want[loose]) <= 2 * 1e-2), k


# ======================================================= pretrain_target
def test_pretrain_target_matches_jax(model):
    cfg_j, cfg, jp, flat = model
    dom = make_domains(cfg.vocab_size, ["science", "code"],
                       branchings=[2, 3], seed=3)
    corpus = np.concatenate([training_corpus(dom["science"], 16, 24, 1),
                             training_corpus(dom["code"], 16, 24, 2)])
    jp2, jl = jtrainer.pretrain_target(cfg_j, jp, corpus, steps=10,
                                       batch_size=4, lr=3e-3, seed=5)
    tree = bridge.target_from_numpy(cfg, flat, device="cpu")
    out, tl = trainer.pretrain_target(cfg, tree, corpus, steps=10,
                                      batch_size=4, lr=3e-3, seed=5)
    assert out is tree                   # trained in place
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tl[-1] < tl[0]
    got = bridge.tree_to_numpy(out)
    for k, v in _flatten(jp2).items():
        v = np.asarray(v)
        rel = float(np.linalg.norm(got[k] - v) / np.linalg.norm(v))
        assert rel <= 1e-3, f"{k}: relative L2 {rel}"


# ============================================ optimizer updates in place
def _functional(kind, p, g, st, step, kw):
    """The update as the functional formula (JAX's operation order),
    out of place; returns the new bf16 leaf."""
    p32, g32 = p.float(), g.float()
    t = np.float32(step) + np.float32(1.0)
    if kind == "adamw":
        m = st["m"] * kw["b1"] + g32 * (1 - kw["b1"])
        v = st["v"] * kw["b2"] + g32.square() * (1 - kw["b2"])
        c1 = float(np.float32(1.0) - np.float32(kw["b1"]) ** t)
        c2 = float(np.float32(1.0) - np.float32(kw["b2"]) ** t)
        upd = (m / c1) / ((v / c2).sqrt() + kw["eps"]) + p32 * kw["wd"]
        return (p32 - upd * kw["lr"]).to(p.dtype)
    beta2 = float(np.float32(1.0) - t ** np.float32(-0.8))
    g2 = g32.square() + 1e-30
    vr = st["vr"] * beta2 + g2.mean(dim=-1) * (1 - beta2)
    vc = st["vc"] * beta2 + g2.mean(dim=-2) * (1 - beta2)
    row_mean = torch.clamp(vr.mean(dim=-1, keepdim=True), min=1e-30)
    u = (g32 * torch.rsqrt(vr / row_mean + 1e-30)[..., None]
         * torch.rsqrt(vc + 1e-30)[..., None, :])
    rms = torch.sqrt(torch.mean(torch.square(u)) + 1e-12)
    u = u / torch.clamp(rms / 1.0, min=1.0)
    step_ = kw["lr"] * u + kw["wd"] * kw["lr"] * p32
    return (p32 - step_).to(p.dtype)


@pytest.mark.parametrize("kind,wd", [("adamw", 0.0), ("adamw", 0.01),
                                     ("adafactor", 0.0),
                                     ("adafactor", 0.05)])
def test_in_place_update_is_the_functional_one_in_bf16(kind, wd):
    gen = torch.Generator().manual_seed(3)
    p = (torch.randn((3, 5, 7), generator=gen)).to(torch.bfloat16)
    g = (torch.randn((3, 5, 7), generator=gen) * 3).to(torch.bfloat16)
    kw = dict(lr=1e-2, b1=0.9, b2=0.999, eps=1e-8, wd=wd)
    opt = (topt.adamw(lr=1e-2, weight_decay=wd, grad_clip=0.0)
           if kind == "adamw" else topt.adafactor(lr=1e-2, weight_decay=wd))
    params, grads = {"w": p.clone()}, {"w": g.clone()}
    state = opt.init(params)
    st0 = {k: v.clone() for k, v in (state["w"] if kind == "adafactor"
                                     else {"m": state["m"]["w"],
                                           "v": state["v"]["w"]}).items()}
    want = _functional(kind, p, g, st0, 0, kw)
    opt.update(params, grads, state, 0)
    assert torch.equal(params["w"], want)
    assert torch.equal(grads["w"], g), "the update wrote into the gradient"
