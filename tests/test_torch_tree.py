"""The port's greedy tree speculation, over dense and paged KV, against
the JAX package and against the port's own chain and dense tree.

* The tree-mode plain versions of the verify kernel, dense and paged,
  against the JAX Pallas kernel (interpret mode) and the JAX tree oracle
  at the shapes of tests/test_tree.py, window > 0 included; the CPU
  dispatch of ``ops.verify_attention(tree=)``.
* Slot helpers, tree acceptance (ties, no match), the compaction of the
  accepted branch (lanes near max_len included), the tree draft and the
  tree step against JAX; width 1 against the port's own chain, bit for
  bit.
* Paged: ``compact_tree_cache`` through a block table gives exactly
  JAX's pools (sel > 0, and lanes inactive or unreserved near max_len,
  whose rows route to the trash page; sel == 0 keeps every byte); a
  paged tree step is the dense tree step on the gathered view, and at
  width 1 the paged chain step, bit for bit.
* The engine: width-2 streams equal the JAX engine's on its prompts and
  on the request sets of tests/test_tree.py; width-1 streams equal chain
  streams; the port's ladder (stepwise == superstep == stream == wave)
  at width 2.  Paged: width-2 streams equal the dense tree's (superstep
  and stepwise) and the JAX paged tree engine's within one stream; width
  1 equals the paged chain; the reservation, deferrals and peak pages
  equal JAX's; no page leaks after a drain; the same ladder.

Every model-level test runs on one weight set: tide_tiny briefly
pretrained on the corpus of tests/test_torch_engine.py, with a briefly
trained draft, so that branches other than 0 win.

Tolerances: fp32 rtol/atol 2e-5, bf16 2e-2 (tests/test_kernels.py).
Streams, counts, ``sel``, slots and compacted cache bytes are compared
exactly; a stream may differ from JAX's only at a near-tie of the
target's top-2 logits.  Fixed seeds throughout."""
import functools

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
from repro.models import attention as jattn  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serving.engine import ServingEngine as JaxEngine  # noqa: E402
from repro.serving.policy import ServingConfig as JaxConfig  # noqa: E402
from repro.serving.request import Request as JaxRequest  # noqa: E402
from repro.training.optimizer import adamw  # noqa: E402
from repro.training.trainer import pretrain_target  # noqa: E402
from repro_torch.checkpoint import bridge  # noqa: E402
from repro_torch.configs import get  # noqa: E402
from repro_torch.core import eagle, speculative as spec  # noqa: E402
from repro_torch.core.paging import gather_view  # noqa: E402
from repro_torch.kernels.verify_attn import ops  # noqa: E402
from repro_torch.kernels.verify_attn.ref import (  # noqa: E402
    verify_attention_ref, verify_attention_tree_paged_ref,
    verify_attention_tree_ref)
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from repro_torch.serving.policy import (ServingConfig,  # noqa: E402
                                        SpeculationPolicy)
from repro_torch.serving.request import Request  # noqa: E402
from test_torch_paging import _assert_streams_match  # noqa: E402

TREE_SHAPES = [(1, 3, 0), (2, 3, 0), (3, 2, 0), (2, 4, 6), (4, 2, 5)]
DTYPES = ["float32", "bfloat16"]
TOL = dict(rtol=2e-5, atol=2e-5)
GAMMA = 3
START_LEN = 64           # max_len of the step-level tests' caches
NEAR_TIE = 1e-4          # top-2 logit gap below which a flip is a tie
PAGE = 8                 # page size of the paged tests
LENS, BUDGETS = [5, 30, 11, 23, 8, 17], [6, 4, 8, 5, 7, 6]


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else TOL


def _both(x, dtype):
    return (jnp.asarray(x, getattr(jnp, dtype)),
            torch.tensor(np.asarray(x, np.float32)).to(getattr(torch, dtype)))


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


# ================================================ kernel plain versions
def _tree_inputs(w, g, dtype, seed):
    t = w * g + 1
    b, hq, hk, d, s = 2, 4, 2, 16, 64
    rng = np.random.default_rng(seed * 100 + w * 10 + g)
    q, tq = _both(rng.normal(size=(b, t, hq, d)), dtype)
    k, tk = _both(rng.normal(size=(b, s, hk, d)), dtype)
    v, tv = _both(rng.normal(size=(b, s, hk, d)), dtype)
    lengths, pad = np.array([17, 30], np.int32), np.array([3, 0], np.int32)
    return (q, k, v), (tq, tk, tv), lengths, pad


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("w,g,window", TREE_SHAPES)
def test_tree_ref_vs_pallas(w, g, window, dtype):
    """The tree plain version against the tree-masked Pallas kernel
    (interpret mode) and the JAX tree oracle; the CPU dispatch of
    ``verify_attention(tree=)`` is that plain version."""
    from repro.kernels.verify_attn.kernel import verify_attention as jkern
    from repro.kernels.verify_attn.ref import verify_attention_tree_ref as jref
    (q, k, v), (tq, tk, tv), lengths, pad = _tree_inputs(w, g, dtype, 0)
    jl, jp = jnp.asarray(lengths), jnp.asarray(pad)
    tl, tp = torch.tensor(lengths), torch.tensor(pad)
    kern = jax.jit(functools.partial(
        jkern, window=window, block_kv=32, interpret=True, tree=(w, g)))(
        q, k, v, jl, jp)
    oracle = jref(q, k, v, jl, jp, tree=(w, g), window=window)
    got = verify_attention_tree_ref(tq, tk, tv, tl, tp, tree=(w, g),
                                    window=window)
    np.testing.assert_allclose(_np(got), _np(kern), **_tol(dtype))
    np.testing.assert_allclose(_np(got), _np(oracle), **_tol(dtype))
    n0 = (ops.verify_attention.launches, ops.verify_attention.tree_launches)
    assert torch.equal(ops.verify_attention(tq, tk, tv, tl, tp, tree=(w, g),
                                            window=window), got)
    assert n0 == (ops.verify_attention.launches,
                  ops.verify_attention.tree_launches), "CPU call counted"
    if w == 1:
        # the one-branch tree is the chain, mask for mask
        assert torch.equal(got, verify_attention_ref(tq, tk, tv, tl, tp,
                                                     window=window))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("w,g,window", TREE_SHAPES)
def test_tree_paged_ref_vs_pallas(w, g, window, dtype):
    """Paged tree plain version against the paged Pallas kernel in tree
    mode, behind a shuffled table with a trash page; equal to the dense
    plain version on the gathered view."""
    from repro.kernels.verify_attn.kernel import (
        verify_attention_paged as jkern)
    (q, k, v), (tq, tk, tv), lengths, pad = _tree_inputs(w, g, dtype, 1)
    b, s, hk, d = tk.shape
    p = 16
    n_pg = s // p
    perm = np.random.default_rng(w * 10 + g).permutation(b * n_pg)
    tbl = perm.reshape(b, n_pg).astype(np.int32)

    def pool(x):
        flat = np.asarray(_np(x)).reshape(b * n_pg, p, hk, d)
        out = np.zeros((b * n_pg + 1, p, hk, d), np.float32)
        out[perm] = flat
        return out

    kp, tkp = _both(pool(tk), dtype)
    vp, tvp = _both(pool(tv), dtype)
    jl, jp = jnp.asarray(lengths), jnp.asarray(pad)
    tl, tp, tt = torch.tensor(lengths), torch.tensor(pad), torch.tensor(tbl)
    kern = jax.jit(functools.partial(
        jkern, window=window, interpret=True, tree=(w, g)))(
        q, kp, vp, jnp.asarray(tbl), jl, jp)
    got = verify_attention_tree_paged_ref(tq, tkp, tvp, tt, tl, tp,
                                          tree=(w, g), window=window)
    np.testing.assert_allclose(_np(got), _np(kern), **_tol(dtype))
    dense = verify_attention_tree_ref(tq, gather_view(tkp, tt),
                                      gather_view(tvp, tt), tl, tp,
                                      tree=(w, g), window=window)
    assert torch.equal(got, dense)
    assert torch.equal(ops.verify_attention_paged(
        tq, tkp, tvp, tt, tl, tp, tree=(w, g), window=window), got)


def test_tree_wrapper_refuses_bad_shape():
    q = torch.zeros((1, 5, 2, 32))
    k = torch.zeros((1, 16, 1, 32))
    with pytest.raises(ValueError, match="tree"):
        ops.verify_attention(q, k, k, torch.tensor([3]), tree=(2, 3))


# ============================================== slots and acceptance
def test_tree_slot_helpers_vs_jax():
    shapes = ((1, 3), (2, 3), (4, 3), (3, 1))

    def grids(w, g):
        t = w * g + 1
        qi, ks = np.meshgrid(np.arange(t), np.arange(-2, t + 2),
                             indexing="ij")
        return qi, ks, np.arange(w, dtype=np.int32)

    @jax.jit
    def jall():        # one compile for every JAX helper call
        out = []
        for w, g in shapes:
            qi, ks, sel = grids(w, g)
            out.append((jattn.tree_offsets(w, g),
                        jattn.tree_block_visible(jnp.asarray(qi),
                                                 jnp.asarray(ks), w, g),
                        jspec.tree_path_slots(jnp.asarray(sel), g)))
        return out

    for (w, g), (joff, jvis, jslots) in zip(shapes, jall()):
        qi, ks, sel = grids(w, g)
        np.testing.assert_array_equal(attn.tree_offsets(w, g).numpy(),
                                      np.asarray(joff))
        np.testing.assert_array_equal(
            attn.tree_block_visible(torch.tensor(qi), torch.tensor(ks), w,
                                    g).numpy(), np.asarray(jvis))
        np.testing.assert_array_equal(
            spec.tree_path_slots(torch.tensor(sel), g).numpy(),
            np.asarray(jslots))


def _onehot(ids, v=8):
    return 10.0 * np.eye(v, dtype=np.float32)[np.asarray(ids)]


@pytest.mark.parametrize("ids,draft,want", [
    # branch 1 matches to the leaf; bonus from its leaf slot
    ([[3, 7, 7, 4, 6]], [[[1, 2], [3, 4]]], (2, 1, 6)),
    # no branch matches: n_acc 0, lowest branch, root correction
    ([[5, 7, 7, 7, 7]], [[[1, 2], [3, 4]]], (0, 0, 5)),
    # branches 1 and 2 tie at depth 2: the lower one wins
    ([[3, 0, 0, 4, 5, 4, 6]], [[[1, 2], [3, 4], [3, 4]]], (2, 1, 5)),
])
def test_verify_tree_greedy_cases(ids, draft, want):
    tl, dt = _onehot(ids), np.asarray(draft, np.int32)
    got = spec.verify_tree_greedy(torch.tensor(tl), torch.tensor(dt))
    ref = jax.jit(jspec.verify_tree_greedy)(jnp.asarray(tl), jnp.asarray(dt))
    assert tuple(int(x[0]) for x in got) == want
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_verify_tree_greedy_random_ties_vs_jax():
    """Small-integer logits tie often, within rows (argmax) and across
    branches (sel); width 1 is the chain rule."""
    rng = np.random.default_rng(0)
    b, w, g, v = 64, 3, GAMMA, 8
    tl = rng.integers(0, 3, size=(b, w * g + 1, v)).astype(np.float32)
    am = tl.argmax(-1)
    draft = rng.integers(0, v, size=(b, w, g)).astype(np.int32)
    draft[::2, :, 0] = am[::2, :1]                 # every branch ties at 1
    draft[1::3, 1] = am[1::3, [0, 4, 5]]            # branch 1 runs deep
    got = spec.verify_tree_greedy(torch.tensor(tl), torch.tensor(draft))
    ref = jax.jit(jspec.verify_tree_greedy)(jnp.asarray(tl),
                                            jnp.asarray(draft))
    for a, r in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(r))
    sel, n_acc = got[1].numpy(), got[0].numpy()
    assert (sel > 0).any() and (n_acc == 0).any() and (n_acc == g).any()
    one = spec.verify_tree_greedy(torch.tensor(tl[:, :g + 1]),
                                  torch.tensor(draft[:, :1]))
    chain = spec.verify_greedy(torch.tensor(tl[:, :g + 1]),
                               torch.tensor(draft[:, 0]))
    assert torch.equal(one[0], chain[0]) and torch.equal(one[2], chain[1])
    assert not one[1].any()


def test_compact_tree_cache_vs_jax():
    """Exact against JAX, including lanes whose path runs past max_len
    (reads clamp, writes drop) and an inactive lane far beyond it."""
    w, g, smax = 3, GAMMA, 32
    rng = np.random.default_rng(5)
    leaf = rng.normal(size=(2, 6, smax, 2, 8)).astype(np.float32)
    lengths = np.array([4, 20, smax - w * g - 1, smax - 5, smax - 2, 70],
                       np.int32)
    sel = np.array([2, 1, 2, 1, 2, 0], np.int32)
    jc = {"lengths": jnp.asarray(lengths), "pad": jnp.zeros(6, jnp.int32),
          "body": {"pos0": {"k": jnp.asarray(leaf),
                            "v": jnp.asarray(-leaf)}}}
    tc = {"lengths": torch.tensor(lengths), "pad": torch.zeros(6,
                                                                dtype=torch.int32),
          "body": {"pos0": {"k": torch.tensor(leaf),
                            "v": torch.tensor(-leaf)}}}
    want = jspec.compact_tree_cache(jc, jnp.asarray(sel), g)
    got = spec.compact_tree_cache(tc, torch.tensor(sel), g)
    for k in ("k", "v"):
        np.testing.assert_array_equal(got["body"]["pos0"][k].numpy(),
                                      np.asarray(want["body"]["pos0"][k]))
    assert not np.array_equal(got["body"]["pos0"]["k"].numpy(), leaf)


def _paged_inputs(seed):
    """Two layers of pools (L, NP + 1, P, Hk, D) behind a shuffled table:
    six lanes of max_len 32 (4 pages each, 24 pages + trash), where lane
    3 maps only its first 2 pages and lane 5 none (unreserved entries
    name the trash page)."""
    rng = np.random.default_rng(seed)
    b, n_tbl, hk, d = 6, 4, 2, 8
    n_pages = b * n_tbl
    pool = rng.normal(size=(2, n_pages + 1, PAGE, hk, d)).astype(np.float32)
    tbl = rng.permutation(n_pages).reshape(b, n_tbl).astype(np.int32)
    tbl[3, 2:] = n_pages
    tbl[5] = n_pages
    return pool, tbl


@pytest.mark.parametrize("seed", [0, 1])
def test_compact_tree_cache_paged_vs_jax(seed):
    """Exact against JAX's paged branch on every mapped page, with
    paths past max_len (reads and writes through the trash page), an
    unreserved lane and one far beyond the table; sel == 0 keeps every
    byte, the trash page included."""
    w, g, smax = 3, GAMMA, 4 * PAGE
    pool, tbl = _paged_inputs(seed)
    lengths = np.array([4, 17, smax - w * g - 1, 9, smax - 2, 70], np.int32)
    sel = np.array([2, 1, 2, 2, 1, 0], np.int32)
    n_pages = tbl.size

    def jcache(p):
        return {"lengths": jnp.asarray(lengths),
                "pad": jnp.zeros(6, jnp.int32), "page_tbl": jnp.asarray(tbl),
                "body": {"pos0": {"k": jnp.asarray(p),
                                  "v": jnp.asarray(-p)}}}

    def tcache(p):
        return {"lengths": torch.tensor(lengths),
                "pad": torch.zeros(6, dtype=torch.int32),
                "page_tbl": torch.tensor(tbl),
                "body": {"pos0": {"k": torch.tensor(p),
                                  "v": torch.tensor(-p)}}}

    want = jspec.compact_tree_cache(jcache(pool), jnp.asarray(sel), g)
    got = spec.compact_tree_cache(tcache(pool), torch.tensor(sel), g)
    for k in ("k", "v"):
        # several lanes may route a write to the trash page in one call;
        # which lands there is undefined in both frameworks
        np.testing.assert_array_equal(
            got["body"]["pos0"][k].numpy()[:, :n_pages],
            np.asarray(want["body"]["pos0"][k])[:, :n_pages])
    moved = got["body"]["pos0"]["k"].numpy()
    assert not np.array_equal(moved[:, :n_pages], pool[:, :n_pages])
    # lanes 0 and 1 moved their branch rows through the table
    for b_ in (0, 1):
        row = torch.tensor(tbl[b_:b_ + 1])
        view = gather_view(torch.tensor(moved[0]), row)
        src = lengths[b_] + 1 + sel[b_] * g + np.arange(g)
        orig = gather_view(torch.tensor(pool[0]), row)
        assert torch.equal(view[0, lengths[b_] + 1:lengths[b_] + 1 + g],
                           orig[0, src])
    same = spec.compact_tree_cache(tcache(pool),
                                   torch.zeros(6, dtype=torch.int32), g)
    assert np.array_equal(same["body"]["pos0"]["k"].numpy(), pool)
    assert np.array_equal(same["body"]["pos0"]["v"].numpy(), -pool)


# ============================================ model, draft, step
@pytest.fixture(scope="module")
def models():
    """One weight set for every model-level test: tide_tiny pretrained in
    JAX on the corpus of tests/test_torch_eng.py (40 steps, half its
    recipe), and its draft trained 20 steps on the target's captures of
    16 of those sequences, so that the draft's first choice is often
    right and its second choice sometimes is (a branch other than 0
    wins); both bridged into the port.  The step counts keep the file's
    setup to a few seconds."""
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
    caps = jax.jit(lambda p, x: JT.prefill(jcfg, p, x)["captures"])(jp, sub)
    feats, toks = caps[:, :-1], sub[:, 1:]
    opt = adamw(lr=3e-3, weight_decay=0.0)

    def loss(dp):
        return jeagle.draft_train_loss(jdcfg, dp, jp["embed"], feats, toks,
                                       ttt=False)

    @jax.jit
    def step(dp, st, it):
        (_, _), g = jax.value_and_grad(loss, has_aux=True)(dp)
        return opt.update(dp, g, st, it)

    jdp = jax.jit(jeagle.draft_init, static_argnums=0)(jdcfg,
                                                       jax.random.key(7))
    st = opt.init(jdp)
    for it in range(20):
        jdp, st = step(jdp, st, it)

    @jax.jit
    def jstart(toks, pad):
        """JAX half of ``_start`` (one compile instead of eager ops)."""
        out = JT.prefill(jcfg, jp, toks, max_len=START_LEN, pad=pad)
        dc = jeagle.seed_prompt_pairs(
            jdcfg, jdp, jp["embed"],
            jeagle.init_draft_cache(jdcfg, toks.shape[0], START_LEN),
            out["captures"], toks, pad)
        first = out["logits"].argmax(-1).astype(jnp.int32)
        return out["cache"], dc, jspec.init_carry(jcfg, jdcfg, out, first,
                                                  GAMMA)

    rng = np.random.default_rng(0)
    prompts = [domains["science"].sample_prompt(rng) for _ in range(8)]
    budgets = [24, 9, 24, 17, 5, 24, 12, 20]
    cfg = get("tide-tiny")
    dcfg = eagle.draft_config(cfg)
    tp = bridge.target_from_numpy(cfg, _flatten(jp), device="cpu")
    tdp = bridge.draft_from_numpy(dcfg, _flatten(jdp), device="cpu")
    yield dict(jcfg=jcfg, jdcfg=jdcfg, jp=jp, jdp=jdp, cfg=cfg, dcfg=dcfg,
               tp=tp, tdp=tdp, jstart=jstart, prompts=prompts,
               budgets=budgets)
    torch.set_num_threads(threads)


def _start(m, max_len=START_LEN):
    """Prefilled target and seeded draft caches, both frameworks, for 3
    left-padded prompts."""
    rng = np.random.default_rng(4)
    lens = [12, 9, 5]
    toks = np.zeros((3, 12), np.int32)
    pad = np.array([12 - n for n in lens], np.int32)
    for i, n in enumerate(lens):
        toks[i, pad[i]:] = rng.integers(0, 512, size=n)
    tout = T.prefill(m["cfg"], m["tp"], torch.tensor(toks), max_len=max_len,
                     pad=torch.tensor(pad))
    tdc = eagle.seed_prompt_pairs(
        m["dcfg"], m["tdp"], m["tp"]["embed"],
        eagle.init_draft_cache(m["dcfg"], 3, max_len, device="cpu"),
        tout["captures"], torch.tensor(toks), torch.tensor(pad))
    tfirst = tout["logits"].argmax(-1).to(torch.int32)
    tcarry = spec.init_carry(m["cfg"], m["dcfg"], tout, tfirst, GAMMA)
    return pad, m["jstart"](jnp.asarray(toks), jnp.asarray(pad)), \
        (tout["cache"], tdc, tcarry)


@pytest.mark.parametrize("width", [1, 3])
def test_draft_propose_tree_vs_jax(models, width):
    m = models
    pad, (jc, jdc, jcarry), (tc, tdc, tcarry) = _start(m)
    jl, jh, jdc = jax.jit(lambda dc, c: jeagle.draft_extend(
        m["jdcfg"], m["jdp"], m["jp"]["embed"], dc, c.feats, c.tokens,
        c.advance))(jdc, jcarry)
    tl, th, tdc = eagle.draft_extend(
        m["dcfg"], m["tdp"], m["tp"]["embed"], tdc, tcarry.feats,
        tcarry.tokens, tcarry.advance)
    last = np.zeros(3, np.int64)
    jt, jlg, jdc = jax.jit(lambda dc, h, fl: jeagle.draft_propose_tree(
        m["jdcfg"], m["jdp"], m["jp"]["embed"], dc, h, fl, GAMMA, width))(
        jdc, jh[np.arange(3), last], jl[np.arange(3), last])
    tt, tlg, tdc = eagle.draft_propose_tree(
        m["dcfg"], m["tdp"], m["tp"]["embed"], tdc, th[np.arange(3), last],
        tl[np.arange(3), last], GAMMA, width)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(_np(tlg), _np(jlg), **TOL)
    np.testing.assert_array_equal(tdc["lengths"].numpy(),
                                  np.asarray(jdc["lengths"]))
    first = tt[:, :, 0].numpy()
    assert all(len(set(r)) == width for r in first.tolist())


def _eq_tree(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_eq_tree(a[k], b[k]) for k in a)
    return torch.equal(a, b)


def _clone(x):
    if isinstance(x, dict):
        return {k: _clone(v) for k, v in x.items()}
    if isinstance(x, tuple):
        vals = [_clone(v) for v in x]
        return type(x)(*vals) if hasattr(x, "_fields") else tuple(vals)
    return x.clone()


def test_tree_step_width1_bitwise_chain(models):
    """Width-1 ``tree_decode_step`` is the port's ``spec_decode_step``
    bit for bit over four rounds: commits, logits, captures, caches."""
    m = models
    _, _, start = _start(m)
    sa, sb = _clone(start), _clone(start)
    for i in range(4):
        oa = spec.spec_decode_step(m["cfg"], m["dcfg"], m["tp"], m["tdp"],
                                   *sa, gamma=GAMMA)
        ob = spec.tree_decode_step(m["cfg"], m["dcfg"], m["tp"], m["tdp"],
                                   *sb, gamma=GAMMA, width=1)
        for f in ("tokens", "n_commit", "n_acc", "target_logits", "captures",
                  "block", "accept_mask"):
            assert torch.equal(oa[f], ob[f]), (i, f)
        assert not ob["sel"].any()
        assert _eq_tree(oa["cache"], ob["cache"]), i
        assert _eq_tree(oa["dcache"], ob["dcache"]), i
        sa = (oa["cache"], oa["dcache"], oa["carry"])
        sb = (ob["cache"], ob["dcache"], ob["carry"])


def test_tree_step_vs_jax(models):
    """Width-3 ``tree_decode_step`` against JAX's over three rounds."""
    m = models
    pad, (jc, jdc, jcarry), (tc, tdc, tcarry) = _start(m)
    jstep = jax.jit(lambda c, dc, cr: jspec.tree_decode_step(
        m["jcfg"], m["jdcfg"], m["jp"], m["jdp"], c, dc, cr, gamma=GAMMA,
        width=3))
    for i in range(3):
        jo = jstep(jc, jdc, jcarry)
        to = spec.tree_decode_step(m["cfg"], m["dcfg"], m["tp"], m["tdp"],
                                   tc, tdc, tcarry, gamma=GAMMA, width=3)
        for k in ("tokens", "n_commit", "n_acc", "sel", "block",
                  "accept_mask"):
            np.testing.assert_array_equal(to[k].numpy(), np.asarray(jo[k]),
                                          err_msg=f"round {i} {k}")
        for k in ("target_logits", "captures"):
            np.testing.assert_allclose(_np(to[k]), _np(jo[k]), **TOL,
                                       err_msg=f"round {i} {k}")
        jc, jdc, jcarry = jo["cache"], jo["dcache"], jo["carry"]
        tc, tdc, tcarry = to["cache"], to["dcache"], to["carry"]
        lengths = tc["lengths"].numpy()
        np.testing.assert_array_equal(lengths, np.asarray(jc["lengths"]))
        np.testing.assert_array_equal(tdc["lengths"].numpy(),
                                      np.asarray(jdc["lengths"]))
        for leaf in ("k", "v"):          # the committed rows
            for b in range(3):
                np.testing.assert_allclose(
                    _np(tc["body"]["pos0"][leaf][:, b, pad[b]:lengths[b]]),
                    _np(jc["body"]["pos0"][leaf][:, b, pad[b]:lengths[b]]),
                    **TOL)



# ============================================ step, paged vs dense
def _to_paged(cache, dcache, seed):
    """Paged copies of dense target and draft caches: every lane's whole
    window mapped through one shuffled table (B · max_len / P pages +
    trash), so each pool's gathered view is the dense leaf."""
    lengths = cache["lengths"]
    b, smax = lengths.shape[0], dcache["k"].shape[1]
    n_tbl = smax // PAGE
    perm = torch.as_tensor(np.random.default_rng(seed).permutation(b * n_tbl))
    tbl = perm.reshape(b, n_tbl).to(torch.int32)

    def pool(leaf):                              # (..., B, Smax, Hk, D)
        lead = leaf.shape[:-4]
        out = torch.zeros(lead + (b * n_tbl + 1, PAGE) + leaf.shape[-2:],
                          dtype=leaf.dtype)
        out[..., perm, :, :, :] = leaf.reshape(
            lead + (b * n_tbl, PAGE) + leaf.shape[-2:])
        return out

    pc = {k: (v.clone() if k in ("lengths", "pad") else
              {pos: {n: pool(x) for n, x in e.items()}
               for pos, e in v.items()})
          for k, v in cache.items()}
    pc["page_tbl"] = tbl
    pdc = dict(dcache, k=pool(dcache["k"]), v=pool(dcache["v"]),
               tbl=tbl.clone(), lengths=dcache["lengths"].clone(),
               pad=dcache["pad"].clone())
    return pc, pdc


def _views_equal(dense, paged, tbl):
    """Each dense leaf equals its pool's gathered view (every position)."""
    for name, group in dense.items():
        if name in ("lengths", "pad"):
            assert torch.equal(group, paged[name]), name
            continue
        for pos, entry in group.items():
            for leaf, x in entry.items():
                for i in range(x.shape[0]):
                    assert torch.equal(x[i], gather_view(
                        paged[name][pos][leaf][i], tbl)), (name, leaf, i)


@pytest.mark.parametrize("width", [1, 2, 3])
def test_paged_tree_step_equals_dense_on_view(models, width):
    """Four rounds of ``tree_decode_step`` on paged caches give the dense
    tree step's outputs bit for bit, and the pools' gathered views stay
    the dense caches, target and draft (a branch other than 0 wins in
    some round at width 3 on these weights)."""
    m = models
    _, _, (tc, tdc, carry) = _start(m)
    pc, pdc = _to_paged(tc, tdc, width)
    tbl = pc["page_tbl"]
    pcarry = _clone(carry)
    won = False
    for i in range(4):
        do = spec.tree_decode_step(m["cfg"], m["dcfg"], m["tp"], m["tdp"],
                                   tc, tdc, carry, gamma=GAMMA, width=width)
        po = spec.tree_decode_step(m["cfg"], m["dcfg"], m["tp"], m["tdp"],
                                   pc, pdc, pcarry, gamma=GAMMA, width=width)
        for f in ("tokens", "n_commit", "n_acc", "sel", "target_logits",
                  "captures", "block", "accept_mask"):
            assert torch.equal(do[f], po[f]), (i, f)
        won |= bool((do["sel"] > 0).any())
        tc, tdc, carry = do["cache"], do["dcache"], do["carry"]
        pc, pdc, pcarry = po["cache"], po["dcache"], po["carry"]
        _views_equal(tc, pc, tbl)
        for leaf in ("k", "v"):
            assert torch.equal(tdc[leaf], gather_view(pdc[leaf], pdc["tbl"]))
        assert torch.equal(tdc["lengths"], pdc["lengths"])
    if width == 3:
        assert won, "no branch >= 1 won: the compaction moved no row"


def test_paged_tree_step_width1_bitwise_paged_chain(models):
    """Width-1 ``tree_decode_step`` on paged caches is the paged
    ``spec_decode_step`` bit for bit over four rounds: commits, logits,
    captures and every pool byte, target and draft."""
    m = models
    _, _, (tc, tdc, carry) = _start(m)
    pa, pda = _to_paged(tc, tdc, 5)
    pb, pdb = _clone(pa), _clone(pda)
    ca, cb = _clone(carry), _clone(carry)
    for i in range(4):
        oa = spec.spec_decode_step(m["cfg"], m["dcfg"], m["tp"], m["tdp"],
                                   pa, pda, ca, gamma=GAMMA)
        ob = spec.tree_decode_step(m["cfg"], m["dcfg"], m["tp"], m["tdp"],
                                   pb, pdb, cb, gamma=GAMMA, width=1)
        for f in ("tokens", "n_commit", "n_acc", "target_logits", "captures",
                  "block", "accept_mask"):
            assert torch.equal(oa[f], ob[f]), (i, f)
        assert _eq_tree(oa["cache"], ob["cache"]), i
        assert _eq_tree(oa["dcache"], ob["dcache"]), i
        pa, pda, ca = oa["cache"], oa["dcache"], oa["carry"]
        pb, pdb, cb = ob["cache"], ob["dcache"], ob["carry"]


# ================================================================ engine
def _port_engine(m, width, rounds, *, policy=None, **kw):
    conf = ServingConfig(batch_size=2, max_len=96, gamma=GAMMA,
                         superstep_rounds=rounds, tree_width=width, **kw)
    return ServingEngine(m["cfg"], m["tp"], m["dcfg"], m["tdp"],
                         config=conf, device="cpu", policy=policy)


def _serve(eng, prompts, budgets, stream=True):
    """Serve on the port; paged engines are leak-checked after
    ``release_prefix_cache``."""
    reqs = [Request(prompt=list(p), max_new_tokens=n)
            for p, n in zip(prompts, budgets)]
    if stream:
        eng.serve_stream(iter(reqs))
    else:
        for i in range(0, len(reqs), eng.batch):
            eng.serve_wave(reqs[i:i + eng.batch])
    assert all(r.finish_t is not None for r in reqs)
    if eng.allocator is not None:
        eng.release_prefix_cache()
        eng.allocator.assert_clean()
    return [list(r.generated) for r in reqs]


_JAX_ENGINES = {}


def _jax_streams(m, width, prompts, budgets):
    """Greedy streams of a stepwise JAX engine (one per width, shared
    across tests: its compiles dominate)."""
    if width not in _JAX_ENGINES:
        _JAX_ENGINES[width] = JaxEngine(
            m["jcfg"], m["jp"], m["jdcfg"], m["jdp"], config=JaxConfig(
                batch_size=2, max_len=96, gamma=GAMMA, superstep_rounds=0,
                tree_width=width))
    eng = _JAX_ENGINES[width]
    reqs = [JaxRequest(prompt=list(p), max_new_tokens=n)
            for p, n in zip(prompts, budgets)]
    eng.serve_stream(iter(reqs))
    return [list(r.generated) for r in reqs]


def _test_tree_inputs(cfg, lens, budgets, seed):
    """The request sets of tests/test_tree.py:370-395."""
    rng = np.random.default_rng(seed)
    return [list(rng.integers(1, cfg.vocab_size, n)) for n in lens], budgets


@pytest.fixture
def sels(monkeypatch):
    """Every ``sel`` the tree step returns while the fixture is live."""
    seen = []
    real = spec.tree_decode_step

    def rec(*a, **kw):
        out = real(*a, **kw)
        seen.append(out["sel"].clone())
        return out

    monkeypatch.setattr(spec, "tree_decode_step", rec)
    return seen


@pytest.mark.parametrize("lens,budgets,seed", [
    ([5, 30, 11, 23], [6, 4, 8, 5], 21),
    ([5, 30, 11, 23, 8, 17], [6, 4, 8, 5, 7, 6], 3)])
def test_tree_streams_equal_jax_test_tree_inputs(models, lens, budgets,
                                                 seed):
    """Width-2 streams (superstep) equal the JAX engine's on the request
    sets of tests/test_tree.py; width-1 streams equal the chain's."""
    m = models
    prompts, budgets = _test_tree_inputs(m["cfg"], lens, budgets, seed)
    want = _jax_streams(m, 2, prompts, budgets)
    got = _serve(_port_engine(m, 2, 4), prompts, budgets)
    assert got == want
    assert [len(s) for s in got] == budgets
    assert _serve(_port_engine(m, 1, 4), prompts, budgets) == \
        _serve(_port_engine(m, 0, 4), prompts, budgets)


def test_tree_streams_equal_jax_pretrained(models, sels):
    """Width 2 on the pretrained target and its prompts: the port's
    streams equal the JAX engine's (a flip only at a near-tie of the
    top-2 target logits), and some round accepted a branch other than 0,
    so the compaction moved rows."""
    m = models
    want = _jax_streams(m, 2, m["prompts"],
                        m["budgets"])
    eng = _port_engine(m, 2, 8)
    got = _serve(eng, m["prompts"], m["budgets"])
    assert any(bool((s > 0).any()) for s in sels), "no branch >= 1 won"
    assert eng.stats.accept_len > 1.5
    ties = 0
    for prompt, g, w in zip(m["prompts"], got, want):
        assert len(g) == len(w)
        if g == w:
            continue
        i = next(j for j in range(len(g)) if g[j] != w[j])
        seq = jnp.asarray([list(prompt) + w[:i]], jnp.int32)
        logits = np.sort(np.asarray(
            JT.prefill(m["jcfg"], m["jp"], seq)["logits"][0]))
        assert logits[-1] - logits[-2] < NEAR_TIE, (
            f"stream diverged at step {i}, top-2 gap "
            f"{logits[-1] - logits[-2]}")
        ties += 1
    assert ties <= 1, f"{ties} near-tie flips: too many to be ties"


def test_tree_port_ladder(models):
    """Width 2 inside the port: stepwise == superstep (K 8) on waves, and
    waves == a stream whose supersteps (K 3) end mid-request (width 1 ==
    chain: test_tree_streams_equal_jax_test_tree_inputs)."""
    m = models
    args = (m["prompts"], m["budgets"])
    g0 = _serve(_port_engine(m, 2, 0), *args, stream=False)
    e8 = _port_engine(m, 2, 8)
    g8 = _serve(e8, *args, stream=False)
    gs3 = _serve(_port_engine(m, 2, 3), *args)
    assert g8 == g0 and gs3 == g0
    assert e8.metrics.snapshot()["spec.tree_width"] == 2


def test_tree_engine_knobs(models):
    m = models
    # trees over paged KV are served (the paged engine tests below)
    paged = ServingEngine(m["cfg"], m["tp"], m["dcfg"], m["tdp"],
                          device="cpu",
                          config=ServingConfig(batch_size=2, max_len=96,
                                               page_size=8, tree_width=2))
    assert paged.paged and paged.tree_width == 2
    assert ServingConfig(tree_width=3).make_policy().speculation \
        .tree_width == 3
    eng = _port_engine(m, 0, 8, policy=ServingConfig().make_policy())
    assert eng.tree_width == 0
    pol = ServingConfig().make_policy()
    pol.speculation = SpeculationPolicy(tree_width=2)
    # the policy is the one source of the draft shape; a config that
    # names another width does not go unread
    assert _port_engine(m, 0, 8, policy=pol).tree_width == 2
    assert _port_engine(m, 2, 8, policy=pol).tree_width == 2
    with pytest.raises(ValueError, match="speculation policy"):
        _port_engine(m, 1, 8, policy=pol)


# ========================================================= engine, paged
def _jax_paged_tree(m, prompts, budgets, **kw):
    """One stream of a stepwise JAX paged tree engine (width 2, P 8,
    prefix sharing on), leak-checked after the drain."""
    conf = dict(batch_size=2, max_len=96, gamma=GAMMA, superstep_rounds=0,
                tree_width=2, page_size=PAGE, share_prefix=True)
    conf.update(kw)
    eng = JaxEngine(m["jcfg"], m["jp"], m["jdcfg"], m["jdp"],
                    config=JaxConfig(**conf))
    reqs = [JaxRequest(prompt=list(p), max_new_tokens=n)
            for p, n in zip(prompts, budgets)]
    eng.serve_stream(iter(reqs))
    eng.release_prefix_cache()
    eng.allocator.assert_clean()
    return [list(r.generated) for r in reqs], eng


@pytest.mark.parametrize("rounds", [4, 0])
def test_paged_tree_streams_equal_dense(models, sels, rounds):
    """tests/test_tree.py::test_tree_width2_paged_equals_dense (greedy):
    width-2 paged streams equal the dense tree's, superstep and
    stepwise, with no page leaked after the drain; rows moved (sel > 0
    in some round)."""
    m = models
    prompts, budgets = _test_tree_inputs(m["cfg"], LENS, BUDGETS, 3)
    dense = _serve(_port_engine(m, 2, rounds), prompts, budgets)
    del sels[:]
    eng = _port_engine(m, 2, rounds, page_size=PAGE)
    paged = _serve(eng, prompts, budgets)
    assert paged == dense
    assert [len(s) for s in paged] == budgets
    assert any(bool((s > 0).any()) for s in sels), "no branch >= 1 won"
    assert eng.stats.pages_peak > 0


def test_paged_tree_width1_equals_paged_chain(models):
    m = models
    prompts, budgets = _test_tree_inputs(m["cfg"], LENS, BUDGETS, 21)
    def paged(width, rounds):
        return _serve(_port_engine(m, width, rounds, page_size=PAGE),
                      prompts, budgets)

    chain = paged(0, 4)
    assert paged(1, 4) == chain and paged(1, 0) == chain


def test_paged_tree_streams_equal_jax_paged_tree(models):
    """Width-2 streams of the paged tree engine equal the JAX paged tree
    engine's within one stream (P 8, prefix sharing on), with the same
    counters."""
    m = models
    prompts, budgets = _test_tree_inputs(m["cfg"], LENS, BUDGETS, 3)
    want, jeng = _jax_paged_tree(m, prompts, budgets)
    eng = _port_engine(m, 2, 0, page_size=PAGE)
    got = _serve(eng, prompts, budgets)
    _assert_streams_match(m, prompts, got, want)
    for k in ("admission_deferrals", "pages_peak", "prefix_hits",
              "completed"):
        assert getattr(eng.stats, k) == getattr(jeng.stats, k), k


def test_paged_tree_reservation_and_deferrals_equal_jax(models):
    """The tree reservation (width + budget + γ·W + 1) is JAX's for the
    same request; with a pool of 4 pages (one lane's tree reservation)
    the guard defers, and the deferrals and peak pages equal the JAX
    paged tree engine's (the inputs of
    tests/test_torch_paging.py::test_paged_admission_defers_equal_jax)."""
    m = models
    lens = [int(x) for x in np.random.default_rng(9).integers(3, 13, size=8)]
    budgets = [int(x) for x in
               np.random.default_rng(10).integers(3, 9, size=8)]
    rng = np.random.default_rng(33)
    prompts = [[int(t) for t in rng.integers(1, m["cfg"].vocab_size, n)]
               for n in lens]
    eng = _port_engine(m, 2, 0, page_size=PAGE, num_pages=4)
    chain = _port_engine(m, 0, 0, page_size=PAGE, num_pages=4)
    want, jeng = _jax_paged_tree(m, prompts, budgets, num_pages=4)
    for width, n in ((8, 6), (32, 4), (24, 17), (40, 1)):
        req = Request(prompt=[1] * 3, max_new_tokens=n)
        jreq = JaxRequest(prompt=[1] * 3, max_new_tokens=n)
        assert eng._reservation(width, req) == \
            jeng._reservation(width, jreq) == width + n + 2 * GAMMA + 1
        assert chain._reservation(width, req) == width + n + GAMMA + 1
    got = _serve(eng, prompts, budgets)
    _assert_streams_match(m, prompts, got, want)
    assert eng.stats.admission_deferrals > 0
    assert eng.stats.admission_deferrals == jeng.stats.admission_deferrals
    assert eng.stats.pages_peak == jeng.stats.pages_peak <= 4
    assert eng.stats.completed == len(prompts)


def test_paged_tree_port_ladder(models):
    """Width 2, paged, inside the port: stepwise == superstep (K 8) on
    waves, == a stream whose supersteps (K 3) end mid-request, with and
    without prefix sharing; the allocator is clean after each drain."""
    m = models
    args = (m["prompts"], m["budgets"])
    g0 = _serve(_port_engine(m, 2, 0, page_size=PAGE), *args, stream=False)
    e8 = _port_engine(m, 2, 8, page_size=PAGE)
    g8 = _serve(e8, *args, stream=False)
    gs3 = _serve(_port_engine(m, 2, 3, page_size=PAGE), *args)
    gp = _serve(_port_engine(m, 2, 3, page_size=PAGE, share_prefix=False),
                *args)
    assert g8 == g0 and gs3 == g0 and gp == g0
    snap = e8.metrics.snapshot()
    assert snap["spec.tree_width"] == 2 and snap["paging.pages_in_use"] == 0
