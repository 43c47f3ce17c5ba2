"""The port's model, draft and speculative core against the JAX package on
tide_tiny (fp32, CPU), with the same weights bridged in as numpy arrays.

Tolerance: fp32 rtol/atol 2e-5 (tests/test_kernels.py:18).  Token
decisions (argmax, acceptance counts) are compared exactly.  Positions
before a lane's left pad are not compared: the JAX reference averages
their attention over no key and the port defines them as zeros; they
only ever reach masked cache positions."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import repro.configs as C  # noqa: E402
from repro.checkpoint.ckpt import _flatten  # noqa: E402
from repro.core import eagle as jeagle  # noqa: E402
from repro.core import speculative as jspec  # noqa: E402
from repro.core.adaptive import LatencyProfile, accept_threshold_table  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.checkpoint import bridge  # noqa: E402
from repro_torch.configs import get  # noqa: E402
from repro_torch.core import eagle, speculative as spec  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)
MAX_LEN = 64
GAMMA = 3


@pytest.fixture(scope="module")
def models():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    jcfg = C.get("tide-tiny")
    jdcfg = jeagle.draft_config(jcfg)
    jp = JT.init(jcfg, jax.random.key(0))
    jdp = jeagle.draft_init(jdcfg, jax.random.key(7))
    cfg = get("tide-tiny")
    dcfg = eagle.draft_config(cfg)
    tp = bridge.target_from_numpy(cfg, _flatten(jp), device="cpu")
    tdp = bridge.draft_from_numpy(dcfg, _flatten(jdp), device="cpu")
    yield dict(jcfg=jcfg, jdcfg=jdcfg, jp=jp, jdp=jdp, cfg=cfg, dcfg=dcfg,
               tp=tp, tdp=tdp)
    torch.set_num_threads(threads)


def _prompts(with_pad: bool):
    rng = np.random.default_rng(4)
    lens = [12, 9, 5] if with_pad else [12, 12, 12]
    plen = max(lens)
    toks = np.zeros((3, plen), np.int32)
    pad = np.zeros((3,), np.int32)
    for i, n in enumerate(lens):
        pad[i] = plen - n
        toks[i, pad[i]:] = rng.integers(0, 512, size=n)
    return toks, pad


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _close_rows(got, want, lo, hi, axis_b=0, axis_s=1):
    """Compare per-lane position ranges [lo[b], hi[b]) along ``axis_s``."""
    got, want = _np(got), _np(want)
    for b in range(len(lo)):
        g = np.take(np.take(got, b, axis=axis_b), np.arange(lo[b], hi[b]),
                    axis=axis_s - 1)
        w = np.take(np.take(want, b, axis=axis_b), np.arange(lo[b], hi[b]),
                    axis=axis_s - 1)
        np.testing.assert_allclose(g, w, **TOL)


def _prefill_both(m, with_pad):
    toks, pad = _prompts(with_pad)
    jpad = jnp.asarray(pad) if with_pad else None
    tpad = torch.tensor(pad) if with_pad else None
    jout = JT.prefill(m["jcfg"], m["jp"], jnp.asarray(toks), max_len=MAX_LEN,
                      pad=jpad)
    tout = T.prefill(m["cfg"], m["tp"], torch.tensor(toks), max_len=MAX_LEN,
                     pad=tpad)
    return toks, pad, jout, tout


def _cache_close(jc, tc, lo, hi):
    for leaf in ("k", "v"):
        _close_rows(tc["body"]["pos0"][leaf], jc["body"]["pos0"][leaf], lo,
                    hi, axis_b=1, axis_s=2)
    np.testing.assert_array_equal(tc["lengths"].numpy(),
                                  np.asarray(jc["lengths"]))
    np.testing.assert_array_equal(tc["pad"].numpy(), np.asarray(jc["pad"]))


@pytest.mark.parametrize("with_pad", [False, True])
def test_prefill_logits_captures_cache(models, with_pad):
    toks, pad, jout, tout = _prefill_both(models, with_pad)
    s = toks.shape[1]
    np.testing.assert_allclose(_np(tout["logits"]), _np(jout["logits"]),
                               **TOL)
    _close_rows(tout["captures"], jout["captures"], pad, [s] * 3)
    _cache_close(jout["cache"], tout["cache"], pad, [s] * 3)
    assert tout["cache"]["body"]["pos0"]["k"].shape == \
        jout["cache"]["body"]["pos0"]["k"].shape


@pytest.mark.parametrize("with_pad", [False, True])
@pytest.mark.parametrize("t", [1, 4])
def test_decode_step_and_commit(models, with_pad, t):
    toks, pad, jout, tout = _prefill_both(models, with_pad)
    s = toks.shape[1]
    block = np.random.default_rng(t).integers(0, 512, size=(3, t)
                                              ).astype(np.int32)
    jd = JT.decode_step(models["jcfg"], models["jp"], jout["cache"],
                        jnp.asarray(block))
    td = T.decode_step(models["cfg"], models["tp"], tout["cache"],
                       torch.tensor(block))
    np.testing.assert_allclose(_np(td["logits"]), _np(jd["logits"]), **TOL)
    np.testing.assert_allclose(_np(td["captures"]), _np(jd["captures"]),
                               **TOL)
    _cache_close(jd["cache"], td["cache"], pad, [s + t] * 3)
    n_acc = np.array([1, t, 0], np.int32)
    jc = JT.commit_cache(models["jcfg"], jd["cache"], jnp.asarray(n_acc))
    tc = T.commit_cache(models["cfg"], td["cache"], torch.tensor(n_acc))
    np.testing.assert_array_equal(tc["lengths"].numpy(),
                                  np.asarray(jc["lengths"]))


def _seeded(m, with_pad):
    toks, pad, jout, tout = _prefill_both(m, with_pad)
    jdc = jeagle.seed_prompt_pairs(
        m["jdcfg"], m["jdp"], m["jp"]["embed"],
        jeagle.init_draft_cache(m["jdcfg"], 3, MAX_LEN), jout["captures"],
        jnp.asarray(toks), jnp.asarray(pad))
    tdc = eagle.seed_prompt_pairs(
        m["dcfg"], m["tdp"], m["tp"]["embed"],
        eagle.init_draft_cache(m["dcfg"], 3, MAX_LEN, device="cpu"),
        tout["captures"], torch.tensor(toks), torch.tensor(pad))
    return toks, pad, jout, tout, jdc, tdc


def _dcache_close(jdc, tdc, lo, hi):
    for leaf in ("k", "v"):
        _close_rows(tdc[leaf], jdc[leaf], lo, hi)
    for leaf in ("lengths", "pad"):
        np.testing.assert_array_equal(tdc[leaf].numpy(), np.asarray(jdc[leaf]))


@pytest.mark.parametrize("with_pad", [False, True])
def test_seed_extend_propose(models, with_pad):
    m = models
    toks, pad, jout, tout, jdc, tdc = _seeded(m, with_pad)
    s = toks.shape[1]
    _dcache_close(jdc, tdc, pad, [s - 1] * 3)
    # extend with 4 pairs of which `advance` are valid
    rng = np.random.default_rng(9)
    feats = rng.normal(size=(3, 4, 3 * m["cfg"].d_model)).astype(np.float32)
    nxt = rng.integers(0, 512, size=(3, 4)).astype(np.int32)
    adv = np.array([1, 4, 2], np.int32)
    jl, jh, jdc = jeagle.draft_extend(m["jdcfg"], m["jdp"], m["jp"]["embed"],
                                      jdc, jnp.asarray(feats),
                                      jnp.asarray(nxt), jnp.asarray(adv))
    tl, th, tdc = eagle.draft_extend(m["dcfg"], m["tdp"], m["tp"]["embed"],
                                     tdc, torch.tensor(feats),
                                     torch.tensor(nxt), torch.tensor(adv))
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    np.testing.assert_allclose(_np(th), _np(jh), **TOL)
    _dcache_close(jdc, tdc, pad, [s - 1 + int(a) for a in adv])
    last = adv - 1
    jt, jlg, jdc = jeagle.draft_propose(
        m["jdcfg"], m["jdp"], m["jp"]["embed"], jdc,
        jh[np.arange(3), last], jl[np.arange(3), last], GAMMA)
    tt, tlg, tdc = eagle.draft_propose(
        m["dcfg"], m["tdp"], m["tp"]["embed"], tdc,
        th[np.arange(3), last], tl[np.arange(3), last], GAMMA)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(_np(tlg), _np(jlg), **TOL)
    _dcache_close(jdc, tdc, pad, [s - 1 + int(a) + GAMMA for a in adv])


def test_verify_greedy_exact_with_ties():
    rng = np.random.default_rng(0)
    logits = rng.integers(0, 4, size=(64, GAMMA + 1, 16)).astype(np.float32)
    drafts = rng.integers(0, 16, size=(64, GAMMA)).astype(np.int32)
    # make some drafts match the (first-index) argmax to get n_acc > 0
    am = logits.argmax(-1)
    drafts[::2] = am[::2, :GAMMA]
    drafts[1::4, 1] = (am[1::4, 1] + 1) % 16
    jn, jb = jspec.verify_greedy(jnp.asarray(logits), jnp.asarray(drafts))
    tn, tb = spec.verify_greedy(torch.tensor(logits), torch.tensor(drafts))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    assert np.asarray(jn).max() == GAMMA


def _spec_setup(m, with_pad):
    toks, pad, jout, tout, jdc, tdc = _seeded(m, with_pad)
    jfirst = jout["logits"].argmax(-1).astype(jnp.int32)
    tfirst = tout["logits"].argmax(-1).to(torch.int32)
    np.testing.assert_array_equal(tfirst.numpy(), np.asarray(jfirst))
    jcarry = jspec.init_carry(m["jcfg"], m["jdcfg"], jout, jfirst, GAMMA)
    tcarry = spec.init_carry(m["cfg"], m["dcfg"], tout, tfirst, GAMMA)
    return toks, pad, jout, tout, jdc, tdc, jcarry, tcarry, jfirst, tfirst


@pytest.mark.parametrize("with_pad", [False, True])
def test_spec_decode_step(models, with_pad):
    m = models
    toks, pad, jout, tout, jdc, tdc, jcarry, tcarry, _, _ = \
        _spec_setup(m, with_pad)
    jc, tc = jout["cache"], tout["cache"]
    for _ in range(3):
        jo = jspec.spec_decode_step(m["jcfg"], m["jdcfg"], m["jp"], m["jdp"],
                                    jc, jdc, jcarry, gamma=GAMMA)
        to = spec.spec_decode_step(m["cfg"], m["dcfg"], m["tp"], m["tdp"],
                                   tc, tdc, tcarry, gamma=GAMMA)
        for k in ("tokens", "n_commit", "n_acc", "block", "accept_mask"):
            np.testing.assert_array_equal(to[k].numpy(), np.asarray(jo[k]))
        np.testing.assert_allclose(_np(to["target_logits"]),
                                   _np(jo["target_logits"]), **TOL)
        np.testing.assert_allclose(_np(to["captures"]), _np(jo["captures"]),
                                   **TOL)
        jc, jdc, jcarry = jo["cache"], jo["dcache"], jo["carry"]
        tc, tdc, tcarry = to["cache"], to["dcache"], to["carry"]
        np.testing.assert_array_equal(tc["lengths"].numpy(),
                                      np.asarray(jc["lengths"]))
        np.testing.assert_array_equal(tdc["lengths"].numpy(),
                                      np.asarray(jdc["lengths"]))
    po = spec.plain_step_from_carry(m["cfg"], m["tp"], tc, tcarry,
                                    gamma=GAMMA)
    pj = jspec.plain_step_from_carry(m["jcfg"], m["jp"], jc, jcarry,
                                     gamma=GAMMA)
    np.testing.assert_array_equal(po["tokens"].numpy(), np.asarray(pj["tokens"]))
    np.testing.assert_allclose(_np(po["captures"]), _np(pj["captures"]),
                               **TOL)


# threshold ~2.0 at every batch size; started at EMA 3.0 with a random
# draft (E[l] ~ 1), the gate falls back to plain decoding mid-superstep
_FLAT = LatencyProfile([1, 2, 4, 8], [1.0, 1.0, 1.0, 1.0], d0_ms=0.33)


@pytest.mark.parametrize("table", [False, True])
def test_decode_superstep(models, table):
    m = models
    toks, pad, jout, tout, jdc, tdc, jcarry, tcarry, jfirst, tfirst = \
        _spec_setup(m, True)
    max_new = np.array([20, 7, 30], np.int32)
    ema0 = 3.0 if table else 1.0
    jst = jspec.init_superstep_state(jcarry, jfirst, jax.random.key(0),
                                     accept_ema=ema0)
    tst = spec.init_superstep_state(tcarry, tfirst, accept_ema=ema0)
    tab = accept_threshold_table(_FLAT, GAMMA, 3) if table else None
    jo = jspec.decode_superstep(
        m["jcfg"], m["jdcfg"], m["jp"], m["jdp"], jout["cache"], jdc, jst,
        jnp.asarray(max_new), None if tab is None else jnp.asarray(tab),
        rounds=8, gamma=GAMMA)
    to = spec.decode_superstep(
        m["cfg"], m["dcfg"], m["tp"], m["tdp"], tout["cache"], tdc, tst,
        torch.tensor(max_new), None if tab is None else torch.tensor(tab),
        rounds=8, gamma=GAMMA)
    jr, tr = jo["rounds"], to["rounds"]
    for k in ("tokens", "n_commit", "n_eff", "active_after", "use_spec",
              "n_sig", "valid", "sig_tokens", "sig_counts"):
        np.testing.assert_array_equal(tr[k].numpy(), np.asarray(jr[k]),
                                      err_msg=k)
    for k in ("ell", "alpha", "ema", "sig_feats"):
        np.testing.assert_allclose(_np(tr[k]), _np(jr[k]), **TOL,
                                   err_msg=k)
    use = np.asarray(jr["use_spec"])
    if table:
        assert use.any() and not use.all(), "no mid-superstep fallback"
    assert to["host_syncs"] == 8
    np.testing.assert_array_equal(to["state"].gen_count.numpy(),
                                  np.asarray(jo["state"].gen_count))
    np.testing.assert_array_equal(to["state"].active.numpy(),
                                  np.asarray(jo["state"].active))


def test_decode_superstep_skipped_round_signals(models):
    """Budgets so small that every lane is done within the first rounds:
    the later rounds are skipped.  The signal buffers, packed rounds and
    the skipped rounds' zero slots alike, equal JAX's: tokens and counts
    exactly, feats at TOL."""
    m = models
    toks, pad, jout, tout, jdc, tdc, jcarry, tcarry, jfirst, tfirst = \
        _spec_setup(m, True)
    max_new = np.array([2, 1, 3], np.int32)
    jst = jspec.init_superstep_state(jcarry, jfirst, jax.random.key(0))
    tst = spec.init_superstep_state(tcarry, tfirst)
    jo = jspec.decode_superstep(
        m["jcfg"], m["jdcfg"], m["jp"], m["jdp"], jout["cache"], jdc, jst,
        jnp.asarray(max_new), None, rounds=8, gamma=GAMMA)
    to = spec.decode_superstep(
        m["cfg"], m["dcfg"], m["tp"], m["tdp"], tout["cache"], tdc, tst,
        torch.tensor(max_new), None, rounds=8, gamma=GAMMA)
    jr, tr = jo["rounds"], to["rounds"]
    valid = tr["valid"].numpy()
    assert valid[0] and not valid[-1], valid
    f = tcarry.feats.shape[-1]
    assert tuple(tr["sig_feats"].shape) == (8, 3, GAMMA + 1, f)
    assert tuple(tr["sig_tokens"].shape) == (8, 3, GAMMA + 1)
    assert tuple(tr["sig_counts"].shape) == (8, 3)
    for k in ("sig_tokens", "sig_counts", "n_eff"):
        np.testing.assert_array_equal(tr[k].numpy(), np.asarray(jr[k]),
                                      err_msg=k)
    np.testing.assert_allclose(_np(tr["sig_feats"]), _np(jr["sig_feats"]),
                               **TOL)
    skipped = ~valid
    assert not tr["sig_feats"][skipped].any()
    assert not tr["sig_tokens"][skipped].any()
    assert not tr["sig_counts"][skipped].any()
    assert tr["sig_counts"][valid].any()
