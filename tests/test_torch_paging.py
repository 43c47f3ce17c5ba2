"""The port's paged KV path held to the JAX reference on the CPU.

* The device page helpers of ``repro_torch.core.paging`` give exactly the
  JAX helpers' pools, trash routing included, and a seeded random
  sequence of allocator calls leaves both ``PageAllocator``s in the same
  state after every call.
* The paged kernels' plain versions match JAX's Pallas paged kernels
  (interpret mode) and JAX's paged oracles on permuted, non-contiguous
  tables, P in {8, 12, 16}: fp32 rtol/atol 2e-5, bf16 2e-2 (as
  tests/test_kernels.py).
* The paged engine on JAX-pretrained tide_tiny (weights bridged as numpy)
  emits the JAX paged engine's greedy streams and counters on the inputs
  of tests/test_paged.py; a divergence is accepted only at a near-tie of
  the target's top-2 logits.  Inside the port, paged == dense, stepwise
  == superstep and stream == wave hold exactly, with and without prefix
  sharing, and every page is free after ``release_prefix_cache``.

Fixed seeds, no hypothesis: no run writes ``.hypothesis/`` files."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import repro.configs as C  # noqa: E402
from repro.checkpoint.ckpt import _flatten  # noqa: E402
from repro.core import eagle as jeagle  # noqa: E402
from repro.core import paging as jpaging  # noqa: E402
from repro.data.workloads import make_domains, training_corpus  # noqa: E402
from repro.kernels.flash_attn.kernel import \
    flash_attention_paged as jflash_paged  # noqa: E402
from repro.kernels.flash_attn.ref import \
    flash_attention_paged_ref as jflash_paged_ref  # noqa: E402
from repro.kernels.verify_attn.kernel import \
    verify_attention_paged as jverify_paged  # noqa: E402
from repro.kernels.verify_attn.ref import \
    verify_attention_paged_ref as jverify_paged_ref  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serving.engine import ServingEngine as JaxEngine  # noqa: E402
from repro.serving.policy import ServingConfig as JaxConfig  # noqa: E402
from repro.serving.request import Request as JaxRequest  # noqa: E402
from repro.training.trainer import pretrain_target  # noqa: E402
from repro_torch.checkpoint import bridge  # noqa: E402
from repro_torch.configs import get  # noqa: E402
from repro_torch.core import eagle, paging  # noqa: E402
from repro_torch.kernels.flash_attn.ops import flash_attention_paged  # noqa: E402
from repro_torch.kernels.flash_attn.ref import (  # noqa: E402
    flash_attention_paged_ref, flash_attention_ref)
from repro_torch.kernels.verify_attn.ops import verify_attention_paged  # noqa: E402
from repro_torch.kernels.verify_attn.ref import (  # noqa: E402
    verify_attention_paged_ref, verify_attention_ref)
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from repro_torch.serving.policy import ServingConfig  # noqa: E402
from repro_torch.serving.request import Request  # noqa: E402

NEAR_TIE = 1e-4          # top-2 logit gap below which a flip is a tie


def _both(x, dtype="float32"):
    return (jnp.asarray(x, getattr(jnp, dtype)),
            torch.tensor(np.asarray(x, np.float32)).to(getattr(torch, dtype)))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else \
        dict(rtol=2e-5, atol=2e-5)


# ================================================ device page helpers
def test_gather_view_and_rows_exact():
    rng = np.random.default_rng(0)
    pool = rng.normal(size=(9, 4, 2, 3)).astype(np.float32)
    tbl = rng.permutation(8).reshape(2, 4).astype(np.int32)
    jp, tp = _both(pool)
    got = paging.gather_view(tp, torch.tensor(tbl))
    want = jpaging.gather_view(jp, jnp.asarray(tbl))
    np.testing.assert_array_equal(_np(got), _np(want))
    rows = np.array([[5, 2], [7, 0], [8, 8]], np.int32)
    got = paging.gather_rows_paged(tp, torch.tensor(rows), 6)
    want = jpaging.gather_rows_paged(jp, jnp.asarray(rows), 6)
    np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("lengths,valid", [
    ([3, 17], None),                        # lane 1 runs past the window
    ([0, 9], [[True, False, True, True], [True] * 4]),
    ([12, 13], [[True] * 4, [False] * 4]),
])
def test_page_slot_exact(lengths, valid):
    tbl = np.array([[4, 0, 2, 5], [1, 3, 6, 7]], np.int32)   # P 4, trash 8
    pos = np.asarray(lengths)[:, None] + np.arange(4)[None]
    v = None if valid is None else np.asarray(valid)
    pg, sl = paging.page_slot(torch.tensor(tbl), 4, torch.tensor(pos), 8,
                              None if v is None else torch.tensor(v))
    jpg, jsl = jpaging.page_slot(jnp.asarray(tbl), 4, jnp.asarray(pos), 8,
                                 None if v is None else jnp.asarray(v))
    np.testing.assert_array_equal(pg.numpy(), np.asarray(jpg))
    np.testing.assert_array_equal(sl.numpy(), np.asarray(jsl))


@pytest.mark.parametrize("lengths", [[0, 5], [2, 13], [15, 1]])
def test_scatter_kv_paged_exact(lengths):
    """One write at most goes to the trash page (positions past the
    16-token window of lane 0 or 1), so the whole pool, trash page
    included, must match."""
    rng = np.random.default_rng(1)
    pool = rng.normal(size=(9, 4, 2, 3)).astype(np.float32)
    tbl = np.array([[4, 0, 2, 5], [1, 3, 6, 7]], np.int32)
    new = rng.normal(size=(2, 2, 2, 3)).astype(np.float32)
    jp, tp = _both(pool)
    ln = np.asarray(lengths, np.int32)
    got = paging.scatter_kv_paged(tp, torch.tensor(tbl), torch.tensor(new),
                                  torch.tensor(ln))
    want = jpaging.scatter_kv_paged(jp, jnp.asarray(tbl), jnp.asarray(new),
                                    jnp.asarray(ln))
    assert got is tp                       # in place
    np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("mask,width", [([True, True], 10), ([False, True], 10),
                                        ([True, False], 16), ([True, True], 18)])
def test_write_rows_paged_exact(mask, width):
    """Masked lanes and positions past the window go to the trash page;
    every real page matches exactly, and the trash page holds one of the
    rows routed there."""
    rng = np.random.default_rng(2)
    pool = rng.normal(size=(9, 4, 2, 3)).astype(np.float32)
    tbl = np.array([[4, 0, 2, 5], [1, 3, 6, 8]], np.int32)  # lane 1: 3 pages
    rows = rng.normal(size=(2, width, 2, 3)).astype(np.float32)
    jp, tp = _both(pool)
    got = paging.write_rows_paged(tp, torch.tensor(tbl), torch.tensor(rows),
                                  torch.tensor(mask))
    want = jpaging.write_rows_paged(jp, jnp.asarray(tbl), jnp.asarray(rows),
                                    jnp.asarray(mask))
    np.testing.assert_array_equal(_np(got)[:8], _np(want)[:8])
    trash = _np(got)[8]
    routed = [rows[b, p] for b in range(2) for p in range(width)
              if not mask[b] or p >= 16 or tbl[b, p // 4] == 8]
    for s in range(4):
        assert any(np.array_equal(trash[s], c) for c in routed + [pool[8, s]])


def test_copy_page_exact():
    pool = np.arange(5 * 4, dtype=np.float32).reshape(5, 4, 1, 1)
    jp, tp = _both(pool)
    got = paging.copy_page(tp, 3, 1)
    want = jpaging.copy_page(jp, 3, 1)
    np.testing.assert_array_equal(_np(got), _np(want))


# ========================================================= allocator
def _state(a):
    return (a.table.tolist(), a.ref.tolist(), list(a._free),
            [(k, v) for k, v in a._registry.items()], a.peak_in_use,
            a.prefix_hits, a.prefix_tokens_saved, a.evictions, a.cow_forks,
            a.free_pages, a.pages_in_use)


@pytest.mark.parametrize("seed,share", [(0, True), (1, True), (2, False),
                                        (3, True)])
def test_allocator_random_calls_match_jax(seed, share):
    """A seeded random sequence of reserve / free / publish / lookup /
    adopt / fork / evict calls (a registry cap of 3 forces LRU eviction)
    leaves both allocators in equal state after every call."""
    rng = np.random.default_rng(seed)
    kw = dict(share_prefix=share, registry_cap=3)
    ours = paging.PageAllocator(20, 4, 4, 32, **kw)
    ref = jpaging.PageAllocator(20, 4, 4, 32, **kw)
    keys = []
    for _ in range(300):
        op = rng.integers(0, 7)
        lane = int(rng.integers(0, 4))
        if op == 0:
            tok = int(rng.integers(1, 40))
            assert ours.can_reserve(tok) == ref.can_reserve(tok)
            held = (ref.table[lane] != ref.trash).any()
            if not held:
                assert ours.reserve(lane, tok) == ref.reserve(lane, tok)
        elif op == 1:
            ours.free_lane(lane)
            ref.free_lane(lane)
        elif op == 2:
            n = int(rng.integers(1, 3))
            toks = rng.integers(0, 3, size=12).tolist()
            rows, width = int(rng.integers(1, 3)), int(rng.integers(8, 13))
            k = ours.prefix_key(rows, width, 0, toks, n, salt=1)
            assert k == ref.prefix_key(rows, width, 0, toks, n, salt=1)
            if (ref.table[lane, :n] != ref.trash).all():
                ours.publish(k, lane, n)
                ref.publish(k, lane, n)
                keys.append((k, n))
        elif op == 3 and keys:
            k, n = keys[int(rng.integers(0, len(keys)))]
            hit = ours.lookup(k)
            assert hit == ref.lookup(k)
            if hit is not None and (ref.table[lane] != ref.trash).any():
                ours.adopt(lane, hit[:n])
                ref.adopt(lane, hit[:n])
        elif op == 4 and ref.table[lane, 0] != ref.trash:
            try:
                want = ref.fork_for_write(lane, 0)
            except RuntimeError:
                with pytest.raises(RuntimeError):
                    ours.fork_for_write(lane, 0)
            else:
                assert ours.fork_for_write(lane, 0) == want
        elif op == 5:
            pages = int(rng.integers(1, 8))
            assert ours.can_fit(pages) == ref.can_fit(pages)
        elif op == 6:
            tok = int(rng.integers(0, 50))
            assert ours.pages_for(tok) == ref.pages_for(tok)
        assert _state(ours) == _state(ref)
    for lane in range(4):
        ours.free_lane(lane)
        ref.free_lane(lane)
    ours.release_prefix_cache()
    ref.release_prefix_cache()
    assert _state(ours) == _state(ref)
    ours.assert_clean()


def test_allocator_guards_match_jax():
    for mod in (paging, jpaging):
        a = mod.PageAllocator(4, 8, 2, 32)
        assert a.reserve(0, 32)
        assert not a.reserve(1, 8)
        assert (a.table[1] == a.trash).all()
        with pytest.raises(AssertionError):
            a.reserve(0, 8)
        with pytest.raises(AssertionError):
            a.assert_clean()
        a.free_lane(0)
        a.assert_clean()
        with pytest.raises(ValueError):
            mod.PageAllocator(4, 8, 2, 30)


def test_table_device_is_a_copy():
    a = paging.PageAllocator(4, 8, 2, 32)
    t = a.table_device("cpu")
    a.reserve(0, 8)
    assert t.dtype == torch.int32 and (t == 4).all()
    assert t.tolist() != a.table.tolist()


# ================================================== paged kernel refs
def _tables(rng, b, n_tbl, need):
    trash = b * n_tbl
    perm = rng.permutation(trash)
    tbl = np.full((b, n_tbl), trash, np.int32)
    for lane in range(b):
        tbl[lane, :need[lane]] = perm[lane * n_tbl:lane * n_tbl + need[lane]]
    return tbl, trash


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("page", [8, 12, 16])
def test_verify_paged_ref_vs_pallas(page, dtype):
    rng = np.random.default_rng(13)
    b, t, hq, hk, d, n_tbl = 2, 4, 4, 2, 64, 8
    lengths = rng.integers(t + 1, page * n_tbl - t, size=(b,)).astype(np.int32)
    pad = np.minimum(rng.integers(0, 16, size=(b,)), lengths - 1
                     ).astype(np.int32)
    tbl, trash = _tables(rng, b, n_tbl,
                         [-(-int(n + t) // page) for n in lengths])
    kp, tkp = _both(rng.normal(size=(trash + 1, page, hk, d)), dtype)
    vp, tvp = _both(rng.normal(size=(trash + 1, page, hk, d)), dtype)
    q, tq = _both(rng.normal(size=(b, t, hq, d)), dtype)
    args = (jnp.asarray(tbl), jnp.asarray(lengths), jnp.asarray(pad))
    pallas = jverify_paged(q, kp, vp, *args, interpret=True)
    oracle = jverify_paged_ref(q, kp, vp, *args)
    got = verify_attention_paged_ref(tq, tkp, tvp, torch.tensor(tbl),
                                     torch.tensor(lengths), torch.tensor(pad))
    np.testing.assert_allclose(_np(got), _np(pallas), **_tol(dtype))
    np.testing.assert_allclose(_np(got), _np(oracle), **_tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("page", [8, 12, 16])
def test_flash_paged_ref_vs_pallas(page, dtype):
    rng = np.random.default_rng(11)
    b, s, hq, hk, d = 2, 48, 4, 2, 64
    n_tbl = -(-s // page) + 1
    tbl, trash = _tables(rng, b, n_tbl, [n_tbl] * b)
    kp, tkp = _both(rng.normal(size=(trash + 1, page, hk, d)), dtype)
    vp, tvp = _both(rng.normal(size=(trash + 1, page, hk, d)), dtype)
    q, tq = _both(rng.normal(size=(b, s, hq, d)), dtype)
    pallas = jflash_paged(q, kp, vp, jnp.asarray(tbl), causal=True,
                          block_q=16, interpret=True)
    oracle = jflash_paged_ref(q, kp, vp, jnp.asarray(tbl), causal=True)
    got = flash_attention_paged_ref(tq, tkp, tvp, torch.tensor(tbl))
    np.testing.assert_allclose(_np(got), _np(pallas), **_tol(dtype))
    np.testing.assert_allclose(_np(got), _np(oracle), **_tol(dtype))


@pytest.mark.parametrize("window", [0, 12])
def test_flash_paged_ref_with_pad_is_dense_ref_on_view(window):
    rng = np.random.default_rng(12)
    b, s, hq, hk, d, page = 3, 40, 4, 2, 32, 12
    n_tbl = 5
    tbl, trash = _tables(rng, b, n_tbl, [4] * b)
    kp = torch.tensor(rng.normal(size=(trash + 1, page, hk, d)),
                      dtype=torch.float32)
    vp = torch.tensor(rng.normal(size=(trash + 1, page, hk, d)),
                      dtype=torch.float32)
    q = torch.tensor(rng.normal(size=(b, s, hq, d)), dtype=torch.float32)
    pad = torch.tensor([0, 7, 33], dtype=torch.int32)
    tb = torch.tensor(tbl)
    got = flash_attention_paged_ref(q, kp, vp, tb, pad, window=window)
    want = flash_attention_ref(q, paging.gather_view(kp, tb)[:, :s],
                               paging.gather_view(vp, tb)[:, :s], pad,
                               window=window)
    assert torch.equal(got, want)
    assert not got[2, :33].any()


def test_paged_wrappers_take_plain_version_on_cpu():
    rng = np.random.default_rng(4)
    kp = torch.tensor(rng.normal(size=(9, 8, 2, 32)), dtype=torch.float32)
    q = torch.tensor(rng.normal(size=(2, 16, 4, 32)), dtype=torch.float32)
    tbl = torch.tensor(rng.permutation(8).reshape(2, 4), dtype=torch.int32)
    lengths, pad = torch.tensor([4, 9]), torch.tensor([0, 3])
    n = (verify_attention_paged.launches, flash_attention_paged.launches)
    assert torch.equal(
        verify_attention_paged(q[:, :4], kp, kp, tbl, lengths, pad),
        verify_attention_ref(q[:, :4], paging.gather_view(kp, tbl),
                             paging.gather_view(kp, tbl), lengths, pad))
    assert torch.equal(flash_attention_paged(q, kp, kp, tbl, pad),
                       flash_attention_paged_ref(q, kp, kp, tbl, pad))
    assert n == (verify_attention_paged.launches,
                 flash_attention_paged.launches)


# ======================================================== the engine
@pytest.fixture(scope="module")
def pretrained():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    jcfg = C.get("tide-tiny")
    jp = JT.init(jcfg, jax.random.key(0))
    domains = make_domains(jcfg.vocab_size, ["science"], branchings=[2],
                           seed=3)
    corpus = training_corpus(domains["science"], 64, 40, 1)
    jp, _ = pretrain_target(jcfg, jp, corpus, steps=80, lr=3e-3)
    jdcfg = jeagle.draft_config(jcfg)
    jdp = jeagle.draft_init(jdcfg, jax.random.key(7))
    cfg = get("tide-tiny")
    dcfg = eagle.draft_config(cfg)
    tp = bridge.target_from_numpy(cfg, _flatten(jp), device="cpu")
    tdp = bridge.draft_from_numpy(dcfg, _flatten(jdp), device="cpu")
    yield dict(jcfg=jcfg, jp=jp, jdcfg=jdcfg, jdp=jdp, cfg=cfg, dcfg=dcfg,
               tp=tp, tdp=tdp)
    torch.set_num_threads(threads)


def _prompts(vocab, lens, seed):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(1, vocab, L)] for L in lens]


def _port(pt, prompts, budgets, *, stream=True, **kw):
    """Serve on the port; returns (streams, engine).  Paged engines are
    leak-checked after ``release_prefix_cache``."""
    conf = dict(batch_size=2, max_len=96, gamma=3, superstep_rounds=4)
    conf.update(kw)
    eng = ServingEngine(pt["cfg"], pt["tp"], pt["dcfg"], pt["tdp"],
                        device="cpu", config=ServingConfig(**conf))
    reqs = [Request(prompt=list(p), max_new_tokens=m)
            for p, m in zip(prompts, budgets)]
    if stream:
        eng.serve_stream(iter(reqs))
    else:
        for i in range(0, len(reqs), eng.batch):
            eng.serve_wave(reqs[i:i + eng.batch])
    assert all(r.finish_t is not None for r in reqs)
    if eng.allocator is not None:
        eng.release_prefix_cache()
        eng.allocator.assert_clean()
    return [list(r.generated) for r in reqs], eng


def _jax(pt, prompts, budgets, **kw):
    conf = dict(batch_size=2, max_len=96, gamma=3, seed=5,
                superstep_rounds=4)
    conf.update(kw)
    eng = JaxEngine(pt["jcfg"], pt["jp"], pt["jdcfg"], pt["jdp"],
                    config=JaxConfig(**conf))
    reqs = [JaxRequest(prompt=list(p), max_new_tokens=m)
            for p, m in zip(prompts, budgets)]
    eng.serve_stream(list(reqs))
    eng.release_prefix_cache()
    eng.allocator.assert_clean()
    return [list(r.generated) for r in reqs], eng


def _assert_streams_match(pt, prompts, got, want):
    """Equal streams, or a first divergence at a near-tie of the JAX
    target's greedy logits (a plain prefill of prompt + common prefix)."""
    ties = 0
    for prompt, g, w in zip(prompts, got, want):
        assert len(g) == len(w)
        if g == w:
            continue
        i = next(j for j in range(len(g)) if g[j] != w[j])
        seq = jnp.asarray([list(prompt) + w[:i]], jnp.int32)
        logits = np.asarray(JT.prefill(pt["jcfg"], pt["jp"], seq)["logits"][0])
        top = np.sort(logits)[-2:]
        assert top[1] - top[0] < NEAR_TIE, (
            f"stream diverged at step {i} with top-2 gap {top[1] - top[0]}")
        ties += 1
    assert ties <= 1, f"{ties} near-tie flips: too many to be ties"


def _counters(eng):
    s = eng.stats
    return (s.admission_deferrals, s.pages_peak, s.prefix_hits,
            s.prefix_tokens_saved, s.completed)


def test_paged_streams_equal_jax_stepwise(pretrained):
    """tests/test_paged.py::test_paged_stream_parity_stepwise's inputs."""
    prompts = _prompts(pretrained["cfg"].vocab_size, [5, 30, 11, 23], 21)
    budgets = [6, 4, 8, 5]
    want, jeng = _jax(pretrained, prompts, budgets, superstep_rounds=0,
                      page_size=8)
    got, eng = _port(pretrained, prompts, budgets, superstep_rounds=0,
                     page_size=8)
    _assert_streams_match(pretrained, prompts, got, want)
    assert _counters(eng) == _counters(jeng)
    assert eng.stats.pages_peak > 0


def test_paged_admission_defers_equal_jax(pretrained):
    """tests/test_paged.py::test_paged_admission_defers_under_page_pressure's
    inputs: P 8, 4 pages, so lanes serialize."""
    lens = [int(x) for x in np.random.default_rng(9).integers(3, 13, size=8)]
    budgets = [int(x) for x in
               np.random.default_rng(10).integers(3, 9, size=8)]
    prompts = _prompts(pretrained["cfg"].vocab_size, lens, 33)
    want, jeng = _jax(pretrained, prompts, budgets, page_size=8, num_pages=4)
    got, eng = _port(pretrained, prompts, budgets, page_size=8, num_pages=4)
    _assert_streams_match(pretrained, prompts, got, want)
    assert _counters(eng) == _counters(jeng)
    assert eng.stats.admission_deferrals > 0
    assert eng.stats.completed == 8 and eng.stats.pages_peak <= 4
    dense, _ = _port(pretrained, prompts, budgets)
    assert got == dense


def _workload(pt, shared):
    lens = [5, 30, 11, 23, 17, 40]
    prompts = _prompts(pt["cfg"].vocab_size, lens, 21)
    if shared:                         # four requests share one prompt
        for i in (2, 3, 5):
            prompts[i] = list(prompts[1])
    return prompts, [6, 9, 8, 5, 7, 4]


@pytest.mark.parametrize("page,share", [(8, True), (8, False), (16, True),
                                        (16, False)])
def test_paged_port_ladder(pretrained, page, share):
    """paged == dense, stepwise == superstep, stream == wave, exactly."""
    prompts, budgets = _workload(pretrained, shared=True)
    dense, _ = _port(pretrained, prompts, budgets)
    kw = dict(page_size=page, share_prefix=share)
    ss, eng = _port(pretrained, prompts, budgets, **kw)
    sw, _ = _port(pretrained, prompts, budgets, superstep_rounds=0, **kw)
    wave, _ = _port(pretrained, prompts, budgets, stream=False, **kw)
    assert ss == dense and sw == dense and wave == dense
    assert (eng.stats.prefix_hits > 0) == share


def test_paged_prefix_hits_keep_streams(pretrained):
    """Duplicate prompts adopt shared pages (hits, tokens saved) with the
    streams of a run without sharing."""
    prompts, budgets = _workload(pretrained, shared=True)
    shared, eng = _port(pretrained, prompts, budgets, page_size=8)
    private, eng0 = _port(pretrained, prompts, budgets, page_size=8,
                          share_prefix=False)
    assert shared == private
    assert eng.stats.prefix_hits > 0 and eng.stats.prefix_tokens_saved > 0
    assert eng0.stats.prefix_hits == 0


def test_paged_prefix_survives_across_streams(pretrained):
    """A prefix published in one serve_stream is adopted in the next:
    the pools outlive the stream, so the adopted pages still hold its
    bytes."""
    prompts, budgets = _workload(pretrained, shared=True)
    prompts, budgets = [prompts[1]] * 4, [6, 5, 7, 4]
    dense, _ = _port(pretrained, prompts, budgets, stream=False)
    conf = ServingConfig(batch_size=2, max_len=96, gamma=3,
                         superstep_rounds=4, page_size=8)
    eng = ServingEngine(pretrained["cfg"], pretrained["tp"],
                        pretrained["dcfg"], pretrained["tdp"], device="cpu",
                        config=conf)
    got = []
    for i in (0, 2):
        reqs = [Request(prompt=list(p), max_new_tokens=m)
                for p, m in zip(prompts[i:i + 2], budgets[i:i + 2])]
        eng.serve_wave(reqs)
        got += [list(r.generated) for r in reqs]
        if i == 0:
            hits0 = eng.stats.prefix_hits
    assert got == dense
    assert eng.stats.prefix_hits > hits0 > 0
    eng.release_prefix_cache()
    eng.allocator.assert_clean()


def test_paged_metrics_and_guards(pretrained):
    prompts, budgets = _workload(pretrained, shared=True)
    _, eng = _port(pretrained, prompts[:2], budgets[:2], page_size=8)
    snap = eng.metrics.snapshot()
    assert snap["paging.pages_peak"] == eng.stats.pages_peak > 0
    assert snap["paging.pages_in_use"] == 0
    assert snap["serving.pages_peak"] == eng.stats.pages_peak
    with pytest.raises(ValueError):
        ServingEngine(pretrained["cfg"], pretrained["tp"], pretrained["dcfg"],
                      pretrained["tdp"], device="cpu",
                      config=ServingConfig(batch_size=2, max_len=96,
                                           page_size=7))


# ============================================== paged lane scatters
@pytest.mark.parametrize("mask,src", [([True, False, True], [1, 0, 0]),
                                      ([False, True, True], [0, 1, 0])])
def test_scatter_target_and_draft_rows_paged_exact(mask, src):
    """The refill's writes of dense staging rows through the block table
    (``scatter_target_cache_paged``, ``scatter_draft_rows_paged``) give
    JAX's pools, lengths and pad; unmasked lanes write only the trash
    page, which is left out of the comparison (several lanes race
    there)."""
    from repro.core import speculative as jspec
    from repro_torch.core import speculative as spec
    from repro_torch.models import transformer as T
    jcfg, cfg = C.get("tide-tiny"), get("tide-tiny")
    jdcfg, dcfg = jeagle.draft_config(jcfg), eagle.draft_config(cfg)
    b, max_len, page, n_pages, r, w = 3, 32, 8, 10, 2, 24
    rng = np.random.default_rng(7)
    tbl = np.full((b, max_len // page), n_pages, np.int32)
    tbl[:, :3] = rng.permutation(9).reshape(3, 3)
    jc = JT.init_cache(jcfg, b, max_len, page_size=page, num_pages=n_pages)
    jd = jeagle.init_draft_cache(jdcfg, b, max_len, page_size=page,
                                 num_pages=n_pages)
    tc = T.init_cache(cfg, b, max_len, device="cpu", page_size=page,
                      num_pages=n_pages)
    td = eagle.init_draft_cache(dcfg, b, max_len, device="cpu",
                                page_size=page, num_pages=n_pages)
    jc["page_tbl"], jd["tbl"] = jnp.asarray(tbl), jnp.asarray(tbl)
    tc["page_tbl"], td["tbl"] = torch.tensor(tbl), torch.tensor(tbl)
    jnew = JT.init_cache(jcfg, r, w)
    tnew = {}
    for g, v in jnew.items():
        if g in ("lengths", "pad"):
            x = rng.integers(0, w, size=(r,)).astype(np.int32)
            jnew[g], tnew[g] = jnp.asarray(x), torch.tensor(x)
            continue
        tnew[g] = {}
        for pos, entry in v.items():
            tnew[g][pos] = {}
            for leaf, arr in entry.items():
                x = rng.normal(size=arr.shape).astype(np.float32)
                jnew[g][pos][leaf] = jnp.asarray(x)
                tnew[g][pos][leaf] = torch.tensor(x)
    jdn = {k: jnp.asarray(rng.normal(size=(r, max_len) + jd["k"].shape[2:]),
                          jnp.float32) for k in ("k", "v")}
    jdn["lengths"] = jnp.asarray([w - 1, w - 5], jnp.int32)
    jdn["pad"] = jnp.asarray([0, 4], jnp.int32)
    tdn = {k: torch.tensor(np.asarray(v)) for k, v in jdn.items()}
    m, s_ = np.asarray(mask), np.asarray(src, np.int32)
    jc = jspec.scatter_target_cache_paged(jc, jnew, jnp.asarray(m),
                                          jnp.asarray(s_))
    jd = jeagle.scatter_draft_rows_paged(jd, jdn, jnp.asarray(m),
                                         jnp.asarray(s_))
    spec.scatter_target_cache_paged(tc, tnew, torch.tensor(m),
                                    torch.tensor(s_))
    eagle.scatter_draft_rows_paged(td, tdn, torch.tensor(m), torch.tensor(s_))
    for k in ("lengths", "pad"):
        np.testing.assert_array_equal(tc[k].numpy(), np.asarray(jc[k]))
        np.testing.assert_array_equal(td[k].numpy(), np.asarray(jd[k]))
    for g, v in tc.items():
        if g in ("lengths", "pad", "page_tbl"):
            continue
        for pos, entry in v.items():
            for leaf, pools in entry.items():
                np.testing.assert_array_equal(
                    _np(pools)[:, :n_pages],
                    _np(jc[g][pos][leaf])[:, :n_pages])
    for leaf in ("k", "v"):
        np.testing.assert_array_equal(_np(td[leaf])[:n_pages],
                                      _np(jd[leaf])[:n_pages])
