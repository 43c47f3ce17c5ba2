"""Sampled decoding of the port against JAX's on the CPU (tide_tiny, fp32,
fixed seeds; JAX is the oracle).

* ``core/prng.py`` reproduces ``jax.random``: keys, ``fold_in`` and
  ``split`` bit for bit (seeds 0, 11, 2**31 - 1; data incl. the engine's
  ``INERT_SID`` and a negative int32), bits and ``uniform`` bit for bit
  at shapes (3,), (4, 3) and (512,), ``gumbel`` within 2e-6, and
  ``categorical`` JAX's index.  The sampling wrappers (``kernels/
  sample``) take their plain versions on the CPU and count no launch.
* ``verify_sample`` and ``verify_tree_sample`` (W 1, 2, 3; per-lane
  ``keys=`` and batch-global ``key=``) on logits made with numpy give
  JAX's ``n_acc``, ``sel`` and ``bonus``; tree W 1 is the chain bit for
  bit.  The committed first token follows its exact law within
  tests/test_speculative.py:88's bound: the target's softmax for the
  chain, a biased law for the reference's trees (see
  ``test_tree_sample_distribution``).
* Sampled ``draft_propose``, ``draft_propose_tree`` and
  ``plain_decode_step`` on bridged weights give JAX's tokens.
* Engine streams on tide_tiny pretrained in JAX (40 steps, as
  tests/test_torch_tide.py): dense and paged chains and the width-2 tree
  equal JAX's stepwise engines; within the port superstep == stepwise ==
  wave == stream and paged == dense exactly.

The near-tie rule.  A sampled stream of the port equals JAX's, or its
first differing token comes from a decision whose margin, recomputed
here from JAX's own logits and keys for that round, lies within the
tolerance: for a categorical draw the gap between the top two of
``logits + gumbel`` (a greedy sibling pick: of the logits), for an
acceptance test ``|u - min(1, p/q)|``.  The margins are those of every
decision of that lane's round up to the differing position
(``_round_margins``).  Tolerances: 1e-5 where both sides see the same
logits (the frameworks' softmax, log and gumbel differ in the last
ulps); 1e-4 for engine streams, whose forward passes differ by ~1e-5 on
tide_tiny (the greedy stream tests' ``NEAR_TIE``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import repro.configs as C  # noqa: E402
from repro.checkpoint.ckpt import _flatten  # noqa: E402
from repro.core import eagle as jeagle  # noqa: E402
from repro.core import speculative as jspec  # noqa: E402
from repro.data.workloads import make_domains, training_corpus  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serving.engine import ServingEngine as JaxEngine  # noqa: E402
from repro.serving.policy import ServingConfig as JaxConfig  # noqa: E402
from repro.serving.request import Request as JaxRequest  # noqa: E402
from repro.training.trainer import pretrain_target  # noqa: E402
from repro_torch.checkpoint import bridge  # noqa: E402
from repro_torch.configs import get  # noqa: E402
from repro_torch.core import eagle, prng  # noqa: E402
from repro_torch.core import speculative as spec  # noqa: E402
from repro_torch.kernels.sample import ops as sample  # noqa: E402
from repro_torch.kernels.sample.ref import (  # noqa: E402
    categorical_rows_ref, threefry2x32_ref, tree_first_token_law)
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serving.engine import INERT_SID, ServingEngine  # noqa: E402
from repro_torch.serving.policy import ServingConfig  # noqa: E402
from repro_torch.serving.request import Request  # noqa: E402

VERIFY_TIE = 1e-5
STREAM_TIE = 1e-4
GAMMA = 3


def _kd(k) -> torch.Tensor:
    """A JAX key (array) as the port's int64 words."""
    return torch.tensor(np.asarray(jax.random.key_data(k)).astype(np.int64))


# ================================================================ prng
@pytest.mark.parametrize("seed", [0, 11, 2 ** 31 - 1])
def test_prng_keys_fold_in_split_equal_jax(seed):
    jk = jax.random.key(seed)
    k = prng.key(seed)
    assert torch.equal(k, _kd(jk)) and torch.equal(prng.key_data(k), k)
    for d in (0, 1, 5, INERT_SID, np.int32(-3)):
        assert torch.equal(prng.fold_in(k, int(d)),
                           _kd(jax.random.fold_in(jk, d))), d
    for n in (2, 3, 7):
        assert torch.equal(prng.split(k, n), _kd(jax.random.split(jk, n)))
    # batched over keys, and the engine's two-level lane keys
    jks = jax.random.split(jk, 5)
    sids = np.array([0, 3, INERT_SID, 1, 2], np.int32)
    steps = np.array([0, 1, 7, 2, 40], np.int32)
    want = jax.vmap(lambda s, c: jax.random.fold_in(
        jax.random.fold_in(jk, s), c))(sids, steps)
    base = k[None].expand(5, 2)
    got = prng.fold_in(prng.fold_in(base, torch.tensor(sids)),
                       torch.tensor(steps))
    assert torch.equal(got, _kd(want))
    assert torch.equal(prng.fold_in(_kd(jks), torch.tensor(sids)),
                       _kd(jax.vmap(jax.random.fold_in)(jks, sids)))


@pytest.mark.parametrize("shape", [(3,), (4, 3), (512,)])
def test_prng_bits_uniform_equal_jax(shape):
    jk = jax.random.fold_in(jax.random.fold_in(jax.random.key(11), 5), 3)
    k = _kd(jk)
    bits = np.asarray(jax.random.bits(jk, shape)).astype(np.int64)
    assert np.array_equal(prng.random_bits(k, shape).numpy(), bits)
    u = np.asarray(jax.random.uniform(jk, shape))
    got = prng.uniform(k, shape).numpy()
    assert np.array_equal(got.view(np.int32), u.view(np.int32))
    g = np.asarray(jax.random.gumbel(jk, shape))
    np.testing.assert_allclose(prng.gumbel(k, shape).numpy(), g, rtol=0,
                               atol=2e-6)
    # per-key rows (vmap) and a second range of minval
    jks = jax.random.split(jk, 3)
    want = jax.vmap(lambda kk: jax.random.uniform(kk, shape))(jks)
    assert np.array_equal(prng.uniform(_kd(jks), shape).numpy(),
                          np.asarray(want))
    want = jax.random.uniform(jk, shape, minval=0.25, maxval=0.75)
    assert np.array_equal(prng.uniform(k, shape, 0.25, 0.75).numpy(),
                          np.asarray(want))


def test_prng_categorical_picks_jax_index():
    rng = np.random.default_rng(0)
    jk = jax.random.key(11)
    for v in (8, 512):
        lg = rng.normal(size=(16, v)).astype(np.float32) * 3
        want = np.asarray(jax.random.categorical(jk, lg))
        got = prng.categorical(_kd(jk), torch.tensor(lg)).numpy()
        assert np.array_equal(got, want), v
        jks = jax.random.split(jk, 16)
        want = np.asarray(jax.vmap(jax.random.categorical)(jks, lg))
        got = sample.categorical_rows(_kd(jks), torch.tensor(lg)).numpy()
        assert np.array_equal(got, want), v
        got = sample.categorical(_kd(jk), torch.tensor(lg)).numpy()
        assert np.array_equal(got, np.asarray(
            jax.random.categorical(jk, lg))), v


def test_sample_wrappers_take_plain_versions_on_cpu():
    """The sampling wrappers on CPU tensors: the plain versions (JAX's
    words and draws), no launch counted; the jax.random helpers over
    them equal ``core/prng`` and JAX."""
    jk = jax.random.key(4)
    jks = jax.random.split(jk, 6)
    keys = _kd(jks)
    n0 = (sample.threefry2x32.launches, sample.categorical_rows.launches)
    ctr = prng.counters(5)[None].expand(6, 5, 2)
    assert torch.equal(sample.threefry2x32(keys, ctr),
                       threefry2x32_ref(keys, ctr))
    lg = torch.randn((6, 40), generator=torch.Generator().manual_seed(0))
    assert torch.equal(sample.categorical_rows(keys, lg),
                       categorical_rows_ref(keys, lg))
    assert torch.equal(sample.fold_in_each(keys, 3)[:, 2],
                       _kd(jax.vmap(lambda k: jax.random.fold_in(k, 2))(jks)))
    assert torch.equal(sample.split(_kd(jk), 4), _kd(jax.random.split(jk, 4)))
    assert torch.equal(sample.fold_in(keys, torch.arange(6)),
                       _kd(jax.vmap(jax.random.fold_in)(jks, np.arange(6))))
    got = sample.uniform(_kd(jk)[None].expand(6, 2), 3, row_stride=3)
    assert np.array_equal(got.numpy(),
                          np.asarray(jax.random.uniform(jk, (6, 3))))
    assert (sample.threefry2x32.launches,
            sample.categorical_rows.launches) == n0


# ================================================= verify, numpy logits
def _verify_case(b, w, v=64, seed=0):
    """Target logits (B, W·γ + 1, V); draft logits (B, W, γ, V) near the
    target's at each node's parent slot; draft tokens drawn from the
    draft below the roots, and distinct roots among the target's four
    likeliest tokens in random order (so that siblings also win)."""
    rng = np.random.default_rng(seed)
    tl = (rng.normal(size=(b, w * GAMMA + 1, v)) * 2).astype(np.float32)
    dl = np.empty((b, w, GAMMA, v), np.float32)
    toks = np.empty((b, w, GAMMA), np.int32)
    for lane in range(b):
        for r in range(w):
            for j in range(GAMMA):
                parent = 0 if j == 0 else 1 + r * GAMMA + j - 1
                dl[lane, r, j] = tl[lane, parent] + rng.normal(size=v) * 0.7
                p = _softmax(dl[lane, r, j].astype(np.float64))
                toks[lane, r, j] = rng.choice(v, p=p)
        top = np.argsort(-tl[lane, 0])[:4]
        toks[lane, :, 0] = rng.permutation(top)[:w]
    return tl, dl, toks


def _softmax(x):
    e = np.exp(x - x.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


def _gap(z):
    top = np.sort(np.asarray(z, np.float64))[-2:]
    return float(top[1] - top[0])


def _accept_margins(tl, dl, toks, u, g_res):
    """One lane's acceptance walk as ``verify_tree_sample`` makes it (W 1
    is ``verify_sample``), from its inputs: tl (W·γ + 1, V) target
    logits, dl (W, γ, V) draft logits, toks (W, γ), u (W, γ) the
    acceptance uniforms, g_res (V,) the residual draw's gumbel noise.
    Returns the margins of every test it makes and of the bonus draw."""
    w, g = toks.shape
    q = _softmax(dl.astype(np.float64))
    p_cur = _softmax(tl[0].astype(np.float64))
    margins, found, sel = [], False, 0
    for r in range(w):
        x = toks[r, 0]
        p_test = p_cur if r == 0 else p_cur / max(p_cur.sum(), 1e-20)
        ratio = min(1.0, p_test[x] / max(q[r, 0, x], 1e-20))
        margins.append(abs(u[r, 0] - ratio))
        if u[r, 0] < ratio:
            found, sel = True, r
            break
        p_cur = np.maximum(p_cur - q[r, 0], 0.0)
    n_acc = int(found)
    if found:
        for j in range(1, g):
            p = _softmax(tl[1 + sel * g + j - 1].astype(np.float64))
            x = toks[sel, j]
            ratio = min(1.0, p[x] / max(q[sel, j, x], 1e-20))
            margins.append(abs(u[sel, j] - ratio))
            if not u[sel, j] < ratio:
                break
            n_acc += 1
    p_rej = _softmax(tl[0 if n_acc == 0 else 1 + sel * g + n_acc - 1]
                     .astype(np.float64))
    if n_acc == 0:
        dist = p_cur
    elif n_acc < g:
        dist = np.maximum(p_rej - q[sel, n_acc], 0.0)
    else:
        dist = p_rej
    dist = dist / max(dist.sum(), 1e-20)
    margins.append(_gap(np.log(dist + 1e-20) + g_res))
    return margins


def _verify_noise(jk_ver, b, w, v, per_lane):
    """The acceptance uniforms (B, W, γ) and residual gumbel noise (B, V)
    ``verify_tree_sample`` draws from ``k_ver`` (per-lane keys or one
    key)."""
    if per_lane:
        k_acc = jax.vmap(lambda k: jax.random.fold_in(k, 0))(jk_ver)
        k_res = jax.vmap(lambda k: jax.random.fold_in(k, 1))(jk_ver)
        u = np.stack([np.asarray(jax.vmap(
            lambda k, r=r: jax.random.uniform(
                k if r == 0 else jax.random.fold_in(k, r), (GAMMA,)))(k_acc))
            for r in range(w)], axis=1)
        g = np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (v,)))(k_res))
        return u, g
    k_acc, k_res = jax.random.split(jk_ver)
    u = np.stack([np.asarray(jax.random.uniform(
        k_acc if r == 0 else jax.random.fold_in(k_acc, r), (b, GAMMA)))
        for r in range(w)], axis=1)
    return u, np.asarray(jax.random.gumbel(k_res, (b, v)))


def _assert_lanes_equal(got, want, margins_of, tie):
    """Lane b's outputs equal JAX's, or lane b's walk has a decision
    within ``tie`` of flipping (a near-tie)."""
    ties = 0
    for lane in range(len(want[0])):
        if all(int(g[lane]) == int(x[lane]) for g, x in zip(got, want)):
            continue
        m = min(margins_of(lane))
        assert m < tie, f"lane {lane} departs from JAX with margin {m}"
        ties += 1
    assert ties <= 1, f"{ties} near-tie departures: too many to be ties"


@pytest.mark.parametrize("keyed", ["keys", "key"])
@pytest.mark.parametrize("w", [1, 2, 3])
def test_verify_tree_sample_equal_jax(w, keyed):
    b = 16
    tl, dl, toks = _verify_case(b, w, seed=w)
    per_lane = keyed == "keys"
    jk = (jax.random.split(jax.random.key(5), b) if per_lane
          else jax.random.key(9))
    args = tuple(map(jnp.asarray, (tl, dl, toks)))
    if per_lane:
        want = jax.jit(lambda a, c, d, k: jspec.verify_tree_sample(
            None, a, c, d, keys=k))(*args, jk)
        got = spec.verify_tree_sample(None, *map(torch.tensor, (tl, dl, toks)),
                                      keys=_kd(jk))
    else:
        want = jax.jit(jspec.verify_tree_sample)(jk, *args)
        got = spec.verify_tree_sample(_kd(jk),
                                      *map(torch.tensor, (tl, dl, toks)))
    want = [np.asarray(x) for x in want]
    got = [x.numpy() for x in got]
    assert all(x.dtype == np.int32 for x in got)
    u, g = _verify_noise(jk, b, w, tl.shape[-1], per_lane)
    _assert_lanes_equal(got, want, lambda i: _accept_margins(
        tl[i], dl[i], toks[i], u[i], g[i]), VERIFY_TIE)
    assert len(set(want[0].tolist())) > 1 and (want[0] < GAMMA).any(), \
        "no mix of acceptance lengths and residual draws"
    if w > 1:
        assert (want[1] > 0).any(), "no branch other than 0 won"
    if w == 1:      # the chain verifier, op for op
        chain = jax.jit(lambda a, c, d, k: jspec.verify_sample(
            None if per_lane else k, a, c, d,
            keys=k if per_lane else None))(
            args[0], args[1][:, 0], args[2][:, 0], jk)
        np.testing.assert_array_equal(want[0], np.asarray(chain[0]))
        np.testing.assert_array_equal(want[2], np.asarray(chain[1]))


@pytest.mark.parametrize("keyed", ["keys", "key"])
def test_verify_sample_equal_jax_and_tree_width1_is_chain(keyed):
    """The port's chain verifier against JAX's, and its width-1 tree the
    chain bit for bit (tests/test_tree.py:160 asks it of JAX)."""
    b = 16
    tl, dl, toks = _verify_case(b, 1, seed=7)
    per_lane = keyed == "keys"
    jk = (jax.random.split(jax.random.key(2), b) if per_lane
          else jax.random.key(3))
    key, keys = (None, _kd(jk)) if per_lane else (_kd(jk), None)
    ttl, tdl, ttok = map(torch.tensor, (tl, dl, toks))
    n, bonus = spec.verify_sample(key, ttl, tdl[:, 0], ttok[:, 0],
                                  keys=keys)
    nt, sel, bt = spec.verify_tree_sample(key, ttl, tdl, ttok, keys=keys)
    assert torch.equal(n, nt) and torch.equal(bonus, bt)
    assert not sel.any()
    want = jax.jit(lambda a, c, d, k: jspec.verify_sample(
        None if per_lane else k, a, c, d, keys=k if per_lane else None))(
        jnp.asarray(tl), jnp.asarray(dl[:, 0]), jnp.asarray(toks[:, 0]), jk)
    u, g = _verify_noise(jk, b, 1, tl.shape[-1], per_lane)
    _assert_lanes_equal([n.numpy(), bonus.numpy()],
                        [np.asarray(x) for x in want],
                        lambda i: _accept_margins(tl[i], dl[i], toks[i],
                                                  u[i], g[i]), VERIFY_TIE)


# ================================================= distribution
T_LOGITS = np.array([0.5, 2.0, -1.0, 0.0, 1.0, -2.0, 0.3, 0.7], np.float32)
D_LOGITS = np.array([2.0, -1.0, 0.5, 1.5, -0.5, 0.0, 1.0, -2.0], np.float32)
N_LANES = 4000


def _tree_draft(w, draw_keys):
    """The engine's draft tree over the fixed draft logits for N lanes:
    branch 0 sampled (step j with ``fold_in(key, j)``), branches r >= 1
    greedy over the sibling-masked logits (``draft_propose_tree``)."""
    v = D_LOGITS.shape[0]
    sk = sample.fold_in_each(draw_keys, GAMMA)
    d = torch.tensor(D_LOGITS).expand(N_LANES, v)
    toks = [torch.stack([sample.categorical_rows(sk[:, j], d)
                         for j in range(GAMMA)], dim=1)]
    logits = [d[:, None].expand(N_LANES, GAMMA, v)]
    masked = d.clone()
    for _ in range(1, w):
        masked = masked.scatter(1, toks[-1][:, :1].long(), -1e30)
        root = masked.argmax(-1).to(torch.int32)
        rest = torch.full((N_LANES, GAMMA - 1), int(D_LOGITS.argmax()),
                          dtype=torch.int32)
        toks.append(torch.cat([root[:, None], rest], dim=1))
        logits.append(torch.cat([masked[:, None],
                                 d[:, None].expand(N_LANES, GAMMA - 1, v)],
                                dim=1))
    return torch.stack(toks, dim=1), torch.stack(logits, dim=1)


@pytest.mark.parametrize("w", [1, 2, 3])
def test_tree_sample_distribution(w):
    """tests/test_speculative.py:88 for the chain (W 1) and trees of W 2
    and 3, through the port's sampling kernels' plain versions.

    Every lane's committed first token is JAX's (the same verify on the
    same draft tree and keys), and the histogram of the 4000 lanes lies
    within the JAX test's bound, 0.035, of the exact law of that first
    token (``tree_first_token_law``).  For the chain that law is the
    target's softmax.  For the trees it is not, in JAX as in the port:
    the reference drafts the siblings greedily and subtracts each
    rejected sibling's density from the unnormalised residual, so its
    committed tokens are not target samples; at these logits the law
    departs from the softmax by 0.0350 (W 2) and 0.1205 (W 3), which the
    test also holds (a property of the reference algorithm, carried over
    exactly)."""
    v = T_LOGITS.shape[0]
    jkeys = jax.random.split(jax.random.key(0), N_LANES)
    keys = _kd(jkeys)
    kk = sample.fold_in_each(keys, 2)
    toks, dlog = _tree_draft(w, kk[:, 0])
    tl = torch.tensor(T_LOGITS).expand(N_LANES, w * GAMMA + 1, v)
    n, sel, bonus = spec.verify_tree_sample(None, tl, dlog, toks,
                                            keys=kk[:, 1])
    lanes = torch.arange(N_LANES)
    first = torch.where(n > 0, toks[lanes, sel.long(), 0], bonus).numpy()
    jn, jsel, jbonus = jax.jit(lambda a, c, d, k: jspec.verify_tree_sample(
        None, a, c, d, keys=k))(jnp.asarray(tl.numpy()),
                                jnp.asarray(dlog.numpy()),
                                jnp.asarray(toks.numpy()),
                                jax.random.wrap_key_data(jnp.asarray(
                                    kk[:, 1].numpy().astype(np.uint32))))
    jfirst = np.where(np.asarray(jn) > 0,
                      toks.numpy()[np.arange(N_LANES), np.asarray(jsel), 0],
                      np.asarray(jbonus))
    assert np.array_equal(first, jfirst)
    emp = np.bincount(first, minlength=v) / N_LANES
    law = tree_first_token_law(torch.tensor(T_LOGITS), torch.tensor(D_LOGITS),
                               w).numpy()
    assert float(np.abs(emp - law).max()) < 0.035, (emp, law)
    bias = float(np.abs(law - _softmax(T_LOGITS.astype(np.float64))).max())
    assert bias == pytest.approx({1: 0.0, 2: 0.0350, 3: 0.1205}[w],
                                 abs=1e-4), bias


# ====================================== drafting, plain decode (bridged)
@pytest.fixture(scope="module")
def models():
    """tide_tiny and its draft as JAX initialises them, bridged."""
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
    tdp = bridge.draft_from_numpy(dcfg, _flatten(jdp), device="cpu")
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab_size, size=(3, 12)).astype(np.int32)
    yield dict(jcfg=jcfg, jdcfg=jdcfg, jp=jp, jdp=jdp, cfg=cfg, dcfg=dcfg,
               tp=tp, tdp=tdp, toks=toks)
    torch.set_num_threads(threads)


def _post_extend(m):
    """Both frameworks' (h_last, first_logits, draft cache) after the
    prompt's draft seed and the first extend, 3 lanes."""
    toks = m["toks"]

    @jax.jit
    def jstart(t):
        out = JT.prefill(m["jcfg"], m["jp"], t, max_len=64)
        dc = jeagle.seed_prompt_pairs(
            m["jdcfg"], m["jdp"], m["jp"]["embed"],
            jeagle.init_draft_cache(m["jdcfg"], 3, 64), out["captures"], t,
            jnp.zeros((3,), jnp.int32))
        first = out["logits"].argmax(-1).astype(jnp.int32)
        c = jspec.init_carry(m["jcfg"], m["jdcfg"], out, first, GAMMA)
        lg, h, dc = jeagle.draft_extend(m["jdcfg"], m["jdp"],
                                        m["jp"]["embed"], dc, c.feats,
                                        c.tokens, c.advance)
        return h[:, 0], lg[:, 0], dc
    tt = torch.tensor(toks)
    out = T.prefill(m["cfg"], m["tp"], tt, max_len=64)
    dc = eagle.seed_prompt_pairs(
        m["dcfg"], m["tdp"], m["tp"]["embed"],
        eagle.init_draft_cache(m["dcfg"], 3, 64, device="cpu"),
        out["captures"], tt, torch.zeros((3,), dtype=torch.int32))
    first = out["logits"].argmax(-1).to(torch.int32)
    c = spec.init_carry(m["cfg"], m["dcfg"], out, first, GAMMA)
    lg, h, dc = eagle.draft_extend(m["dcfg"], m["tdp"], m["tp"]["embed"], dc,
                                   c.feats, c.tokens, c.advance)
    return jstart(jnp.asarray(toks)), (h[:, 0], lg[:, 0], dc)


def _first_departure(got, want):
    """The first index (row-major) where two token arrays differ."""
    bad = np.argwhere(np.asarray(got) != np.asarray(want))
    return None if bad.size == 0 else tuple(bad[0])


@pytest.mark.parametrize("width,keyed", [(0, "keys"), (0, "key"),
                                         (1, "keys"), (3, "keys"),
                                         (2, "key")])
def test_sampled_drafting_equal_jax(models, width, keyed):
    """Sampled ``draft_propose`` (width 0) and ``draft_propose_tree``:
    JAX's tokens, logits within 2e-5; a departing token only at a draw
    whose top-two gap of JAX's logits + noise is a near-tie."""
    m = models
    (jh, jl, jdc), (th, tl, tdc) = _post_extend(m)
    per_lane = keyed == "keys"
    jk = (jax.random.split(jax.random.key(6), 3) if per_lane
          else jax.random.key(8))
    kw = dict(keys=_kd(jk)) if per_lane else dict(key=_kd(jk))
    if width:
        jt, jlg, _ = jax.jit(lambda dc, h, fl, k: jeagle.draft_propose_tree(
            m["jdcfg"], m["jdp"], m["jp"]["embed"], dc, h, fl, GAMMA, width,
            greedy=False, key=None if per_lane else k,
            keys=k if per_lane else None))(jdc, jh, jl, jk)
        tt, tlg, _ = eagle.draft_propose_tree(
            m["dcfg"], m["tdp"], m["tp"]["embed"], tdc, th, tl, GAMMA, width,
            greedy=False, **kw)
    else:
        jt, jlg, _ = jax.jit(lambda dc, h, fl, k: jeagle.draft_propose(
            m["jdcfg"], m["jdp"], m["jp"]["embed"], dc, h, fl, GAMMA,
            greedy=False, key=None if per_lane else k,
            keys=k if per_lane else None))(jdc, jh, jl, jk)
        tt, tlg, _ = eagle.draft_propose(
            m["dcfg"], m["tdp"], m["tp"]["embed"], tdc, th, tl, GAMMA,
            greedy=False, **kw)
    jt, jlg = np.asarray(jt), np.asarray(jlg)
    at = _first_departure(tt.numpy(), jt)
    if at is None:
        np.testing.assert_allclose(tlg.numpy(), jlg, rtol=2e-5, atol=2e-5)
    else:
        lane, j = at[0], at[-1]
        r = at[1] if width else 0
        row = jlg[(lane, r, j) if width else (lane, j)]
        if r > 0:                        # a greedy sibling pick
            gap = _gap(row)
        elif per_lane:
            gap = _gap(row + np.asarray(jax.random.gumbel(
                jax.random.fold_in(jk[lane], j), row.shape)))
        else:
            gap = _gap(row + np.asarray(jax.random.gumbel(
                jax.random.split(jk, GAMMA)[j], (3,) + row.shape))[lane])
        assert gap < STREAM_TIE, f"draw {at} departs with gap {gap}"
    if width > 1:
        roots = tt[:, :, 0].numpy()
        assert all(len(set(r)) == width for r in roots.tolist())


@pytest.mark.parametrize("keyed", ["keys", "key"])
def test_sampled_plain_decode_step_equal_jax(models, keyed):
    m = models
    toks = m["toks"]
    per_lane = keyed == "keys"
    jk = (jax.random.split(jax.random.key(12), 3) if per_lane
          else jax.random.key(13))
    nxt = np.array([5, 77, 300], np.int32)

    @jax.jit
    def jrun(t, k):
        out = JT.prefill(m["jcfg"], m["jp"], t, max_len=64)
        return jspec.plain_decode_step(
            m["jcfg"], m["jp"], out["cache"], jnp.asarray(nxt),
            greedy=False, key=None if per_lane else k,
            keys=k if per_lane else None)
    jo = jrun(jnp.asarray(toks), jk)
    out = T.prefill(m["cfg"], m["tp"], torch.tensor(toks), max_len=64)
    to = spec.plain_decode_step(
        m["cfg"], m["tp"], out["cache"], torch.tensor(nxt), greedy=False,
        **(dict(keys=_kd(jk)) if per_lane else dict(key=_kd(jk))))
    jl = np.asarray(jo["logits"])
    np.testing.assert_allclose(to["logits"].numpy(), jl, rtol=1e-4,
                               atol=1e-4)
    assert to["token"].dtype == torch.int32
    assert to["cache"]["lengths"].tolist() == [13, 13, 13]
    noise = (np.asarray(jax.vmap(lambda k: jax.random.gumbel(
        k, jl.shape[-1:]))(jk)) if per_lane else
        np.asarray(jax.random.gumbel(jk, jl.shape)))
    _assert_lanes_equal([to["token"].numpy()], [np.asarray(jo["token"])],
                        lambda i: [_gap(jl[i] + noise[i])], STREAM_TIE)


# ================================================================ engine
@pytest.fixture(scope="module")
def pretrained():
    """tide_tiny pretrained in JAX (40 steps), JAX's initial draft, both
    bridged; 8 science prompts with ragged budgets."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    jcfg = C.get("tide-tiny")
    jdcfg = jeagle.draft_config(jcfg)
    jp = jax.jit(JT.init, static_argnums=0)(jcfg, jax.random.key(0))
    domains = make_domains(jcfg.vocab_size, ["science"], branchings=[2],
                           seed=3)
    corpus = training_corpus(domains["science"], 64, 40, 1)
    jp, _ = pretrain_target(jcfg, jp, corpus, steps=40, lr=3e-3)
    jdp = jax.jit(jeagle.draft_init, static_argnums=0)(jdcfg,
                                                       jax.random.key(7))
    cfg = get("tide-tiny")
    dcfg = eagle.draft_config(cfg)
    tp = bridge.target_from_numpy(cfg, _flatten(jp), device="cpu")
    tdp = bridge.draft_from_numpy(dcfg, _flatten(jdp), device="cpu")
    rng = np.random.default_rng(0)
    prompts = [domains["science"].sample_prompt(rng) for _ in range(8)]
    budgets = [24, 9, 24, 17, 5, 24, 12, 20]
    yield dict(jcfg=jcfg, jdcfg=jdcfg, jp=jp, jdp=jdp, cfg=cfg, dcfg=dcfg,
               tp=tp, tdp=tdp, prompts=prompts, budgets=budgets)
    torch.set_num_threads(threads)


SEED = 5
_CONF = dict(batch_size=2, max_len=96, gamma=GAMMA, greedy=False, seed=SEED)


def _port(pt, rounds, *, stream=True, **kw):
    eng = ServingEngine(pt["cfg"], pt["tp"], pt["dcfg"], pt["tdp"],
                        config=ServingConfig(**_CONF, superstep_rounds=rounds,
                                             **kw), device="cpu")
    reqs = [Request(prompt=list(p), max_new_tokens=m)
            for p, m in zip(pt["prompts"], pt["budgets"])]
    if stream:
        eng.serve_stream(iter(reqs))
    else:
        for i in range(0, len(reqs), 2):
            eng.serve_wave(reqs[i:i + 2])
    assert [len(r.generated) for r in reqs] == pt["budgets"]
    return [list(r.generated) for r in reqs], eng


@pytest.fixture(scope="module")
def jax_streams(pretrained):
    """JAX's stepwise engines (dense chain, paged chain, dense tree W 2)
    with every round's inputs recorded for the near-tie rule."""
    pt = pretrained
    out = {}
    for name, kw in (("chain", {}), ("paged", dict(page_size=8)),
                     ("tree", dict(tree_width=2))):
        eng = JaxEngine(pt["jcfg"], pt["jp"], pt["jdcfg"], pt["jdp"],
                        config=JaxConfig(**_CONF, superstep_rounds=0, **kw))
        log = _record(eng)
        reqs = [JaxRequest(prompt=list(p), max_new_tokens=m)
                for p, m in zip(pt["prompts"], pt["budgets"])]
        eng.serve_stream(iter(reqs))
        out[name] = dict(streams=[list(r.generated) for r in reqs],
                         sids=[r.sid for r in reqs], log=log,
                         width=kw.get("tree_width", 0))
    return out


def _record(eng):
    """Wrap a JAX engine's stepwise round functions to keep each round's
    inputs and outputs (the stepwise jit does not donate them)."""
    log = []
    spec_fn, plain_fn = eng._spec_fn, eng._plain_fn

    def spec_rec(params, dparams, cache, dcache, carry, keys):
        out = spec_fn(params, dparams, cache, dcache, carry, keys)
        log.append(("spec", (dparams, cache, dcache, carry, keys), out))
        return out

    def plain_rec(params, cache, carry, keys):
        out = plain_fn(params, cache, carry, keys)
        log.append(("plain", (cache, carry, keys), out))
        return out
    eng._spec_fn, eng._plain_fn = spec_rec, plain_rec
    return log


def _round_margins(pt, rec, lane, width, upto):
    """The margins of every decision of ``lane``'s round ``rec`` that can
    decide its committed token ``upto`` (0-based in the round), from
    JAX's own logits and keys: the draft draws and sibling picks of
    depth <= upto, the acceptance tests and the bonus draw."""
    kind, args, _ = rec
    jcfg, jdcfg, jp = pt["jcfg"], pt["jdcfg"], pt["jp"]
    if kind == "plain":
        cache, carry, keys = args
        t0 = jnp.take_along_axis(carry.tokens, (carry.advance - 1)[:, None],
                                 axis=1)[:, 0]
        lg = np.asarray(jax.jit(lambda c, t: jspec.plain_decode_step(
            jcfg, jp, c, t)["logits"])(cache, t0))[lane]
        return [_gap(lg + np.asarray(jax.random.gumbel(keys[lane],
                                                       lg.shape)))]
    dparams, cache, dcache, carry, keys = args

    @jax.jit
    def inputs(dparams, cache, dcache, carry, keys):
        k_draft = jax.vmap(lambda k: jax.random.fold_in(k, 0))(keys)
        lg, h, dc = jeagle.draft_extend(jdcfg, dparams, jp["embed"], dcache,
                                        carry.feats, carry.tokens,
                                        carry.advance)
        last = (carry.advance - 1)[:, None, None]
        h_last = jnp.take_along_axis(h, last, axis=1)[:, 0]
        fl = jnp.take_along_axis(lg, last, axis=1)[:, 0]
        toks, dlog, _ = jeagle.draft_propose_tree(
            jdcfg, dparams, jp["embed"], dc, h_last, fl, GAMMA,
            max(width, 1), greedy=False, keys=k_draft)
        t0 = jnp.take_along_axis(carry.tokens, (carry.advance - 1)[:, None],
                                 axis=1)
        block = jnp.concatenate([t0, toks.reshape(toks.shape[0], -1)], 1)
        tree = (width, GAMMA) if width else None
        tl = JT.decode_step(jcfg, jp, cache, block, tree=tree)["logits"]
        return tl, dlog, toks, k_draft
    tl, dlog, toks, k_draft = (np.asarray(x) if i < 3 else x for i, x in
                               enumerate(inputs(dparams, cache, dcache,
                                                carry, keys)))
    margins = []
    for r in range(dlog.shape[1]):
        for j in range(min(upto + 1, GAMMA)):
            row = dlog[lane, r, j]
            if r == 0:
                row = row + np.asarray(jax.random.gumbel(
                    jax.random.fold_in(k_draft[lane], j), row.shape))
            margins.append(_gap(row))
    k_ver = jax.random.fold_in(keys[lane], 1)
    u, g = _verify_noise(k_ver[None], 1, dlog.shape[1], tl.shape[-1], True)
    return margins + _accept_margins(tl[lane], dlog[lane], toks[lane], u[0],
                                     g[0])


def _stream_margins(pt, js, prompt, budget, sid, i):
    """The margins of the decisions behind token ``i`` of the JAX stream
    of request ``sid``: its first token's draw (i == 0), else the round
    of its own step whose commit holds token i, found in the recorded
    rounds by the lane key ``fold_in(fold_in(key(SEED), sid), step)``."""
    base = jax.random.key(SEED)
    if i == 0:
        lg = np.asarray(JT.prefill(pt["jcfg"], pt["jp"],
                                   jnp.asarray([prompt], jnp.int32))
                        ["logits"][0])
        k0 = jax.random.fold_in(jax.random.fold_in(base, sid), 0)
        return [_gap(lg + np.asarray(jax.random.gumbel(k0, lg.shape)))]
    done = 1
    for step in range(1, budget + 1):
        want = np.asarray(jax.random.key_data(jax.random.fold_in(
            jax.random.fold_in(base, sid), step)))
        for rec in js["log"]:
            kd = np.asarray(jax.random.key_data(rec[1][-1]))
            lanes = np.flatnonzero((kd == want).all(-1))
            if lanes.size:
                lane = int(lanes[0])
                n = min(int(np.asarray(rec[2]["n_commit"])[lane]),
                        budget - done)
                if done + n > i:
                    return _round_margins(pt, rec, lane, js["width"],
                                          i - done)
                done += n
                break
    raise AssertionError(f"token {i} of sid {sid} not in the recorded rounds")


def _assert_streams_match(pt, js, got):
    """Equal streams, or each first departure at a near-tie decision of
    JAX's round (the module docstring's rule)."""
    ties = 0
    for k, (g, w) in enumerate(zip(got, js["streams"])):
        assert len(g) == len(w)
        if g == w:
            continue
        i = next(j for j in range(len(g)) if g[j] != w[j])
        m = min(_stream_margins(pt, js, pt["prompts"][k], pt["budgets"][k],
                                js["sids"][k], i))
        assert m < STREAM_TIE, f"request {k} departs at token {i}, margin {m}"
        ties += 1
    assert ties <= 1, f"{ties} near-tie departures: too many to be ties"


def test_stream_margins_are_computed_from_jax_rounds(pretrained, jax_streams):
    """The near-tie rule's machinery on a real round: every decision
    margin of request 0's third token (chain and tree) is finite and
    non-negative, and its round is found by its lane key."""
    pt = pretrained
    for name in ("chain", "tree"):
        js = jax_streams[name]
        m = _stream_margins(pt, js, pt["prompts"][0], pt["budgets"][0],
                            js["sids"][0], 2)
        assert m and all(np.isfinite(x) and x >= 0 for x in m), (name, m)


def test_sampled_chain_streams_equal_jax_and_ladder(pretrained, jax_streams):
    """Dense chain: the port's superstep stream equals JAX's stepwise
    engine; within the port K 8 == K 0 == waves == stream, and the width-1
    tree is the chain."""
    pt = pretrained
    g8, e8 = _port(pt, 8)
    _assert_streams_match(pt, jax_streams["chain"], g8)
    assert e8.stats.accept_len > 1.0, "no sampled acceptance exercised"
    assert e8.stats.refills == len(pt["budgets"]) - 2
    g0, e0 = _port(pt, 0)
    assert g0 == g8 and e0.stats.tokens_out == e8.stats.tokens_out
    gw, _ = _port(pt, 8, stream=False)
    assert gw == g8
    gt1, _ = _port(pt, 8, tree_width=1)
    assert gt1 == g8


def test_sampled_paged_streams_equal_dense_and_jax(pretrained, jax_streams):
    pt = pretrained
    gd, _ = _port(pt, 8)
    gp, ep = _port(pt, 8, page_size=8)
    assert gp == gd
    _assert_streams_match(pt, jax_streams["paged"], gp)
    gp0, _ = _port(pt, 0, page_size=8)
    assert gp0 == gd
    ep.release_prefix_cache()
    ep.allocator.assert_clean()


def test_sampled_tree_streams_equal_jax_and_ladder(pretrained, jax_streams):
    """Tree W 2: superstep == stepwise == wave, paged == dense, and equal
    to JAX's stepwise tree engine."""
    pt = pretrained
    g8, e8 = _port(pt, 8, tree_width=2)
    _assert_streams_match(pt, jax_streams["tree"], g8)
    g0, _ = _port(pt, 0, tree_width=2)
    assert g0 == g8
    gw, _ = _port(pt, 8, stream=False, tree_width=2)
    assert gw == g8
    gp, _ = _port(pt, 8, tree_width=2, page_size=8)
    assert gp == g8
    assert e8.stats.accept_len > 1.0
