"""The port's greedy tree speculation (dense KV) against the JAX package.

* The tree-mode plain versions of the verify kernel, dense and paged,
  against the JAX Pallas kernel (interpret mode) and the JAX tree oracle
  at the shapes of tests/test_tree.py, window > 0 included; the CPU
  dispatch of ``ops.verify_attention(tree=)``.
* Slot helpers, tree acceptance (ties, no match), the compaction of the
  accepted branch (lanes near max_len included), the tree draft and the
  tree step against JAX; width 1 against the port's own chain, bit for
  bit.
* The engine: width-2 streams equal the JAX engine's on its prompts and
  on the request sets of tests/test_tree.py; width-1 streams equal chain
  streams; the port's ladder (stepwise == superstep == stream == wave)
  at width 2.

Every model-level test runs on one weight set: tide_tiny briefly
pretrained on the corpus of tests/test_torch_engine.py, with a briefly
trained draft, so that branches other than 0 win.

Tolerances: fp32 rtol/atol 2e-5, bf16 2e-2 (tests/test_kernels.py).
Streams, counts, ``sel``, slots and compacted cache bytes are compared
exactly.  Fixed seeds throughout."""
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

TREE_SHAPES = [(1, 3, 0), (2, 3, 0), (3, 2, 0), (2, 4, 6), (4, 2, 5)]
DTYPES = ["float32", "bfloat16"]
TOL = dict(rtol=2e-5, atol=2e-5)
GAMMA = 3
START_LEN = 64           # max_len of the step-level tests' caches
NEAR_TIE = 1e-4          # top-2 logit gap below which a flip is a tie


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
    with pytest.raises(NotImplementedError, match="paged tree"):
        spec.compact_tree_cache(dict(tc, page_tbl=torch.zeros((6, 2))),
                                torch.tensor(sel), g)


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


# ================================================================ engine
def _port_engine(m, width, rounds, *, policy=None):
    conf = ServingConfig(batch_size=2, max_len=96, gamma=GAMMA,
                         superstep_rounds=rounds, tree_width=width)
    return ServingEngine(m["cfg"], m["tp"], m["dcfg"], m["tdp"],
                         config=conf, device="cpu", policy=policy)


def _serve(eng, prompts, budgets, stream=True):
    reqs = [Request(prompt=list(p), max_new_tokens=n)
            for p, n in zip(prompts, budgets)]
    if stream:
        eng.serve_stream(iter(reqs))
    else:
        for i in range(0, len(reqs), eng.batch):
            eng.serve_wave(reqs[i:i + eng.batch])
    assert all(r.finish_t is not None for r in reqs)
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
    with pytest.raises(NotImplementedError, match="paged tree speculation"):
        ServingEngine(m["cfg"], m["tp"], m["dcfg"], m["tdp"], device="cpu",
                      config=ServingConfig(batch_size=2, max_len=96,
                                           page_size=8, tree_width=2))
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
