"""The port's kernels: each plain version against the JAX Pallas
kernel (interpret mode on the CPU) and against the JAX model's masked
attention, the CPU dispatch of each wrapper, and -- on a CUDA card only
-- each CUDA kernel against its plain version, and each paged kernel
bit for bit against the dense kernel on the gathered view.  The paged
plain versions are held to JAX in tests/test_torch_paging.py.

The verify kernel's tree mode (the draft-tree verify) is held here on
the card; its plain version is held to JAX in tests/test_torch_tree.py.

Tolerances as in tests/test_kernels.py: fp32 rtol/atol 2e-5, bf16 2e-2;
extract_pack is a copy and is held exactly.  The JAX half imports JAX
inside a fixture, so the card's machine (no JAX) runs the card half."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.paging import gather_view  # noqa: E402
from repro_torch.kernels.extract_pack.ops import MAX_T, pack_signals  # noqa: E402
from repro_torch.kernels.extract_pack.ref import extract_pack_ref  # noqa: E402
from repro_torch.kernels.flash_attn.ops import (  # noqa: E402
    flash_attention, flash_attention_paged)
from repro_torch.kernels.flash_attn.ref import (  # noqa: E402
    flash_attention_paged_ref, flash_attention_ref)
from repro_torch.kernels.linear_rows.ops import (  # noqa: E402
    BLOCK_K, BLOCK_N, k_splits, linear_rows, tile)
from repro_torch.kernels.verify_attn.ops import (  # noqa: E402
    verify_attention, verify_attention_paged, verify_route)
from repro_torch.kernels.verify_attn.ref import (  # noqa: E402
    verify_attention_paged_ref, verify_attention_ref,
    verify_attention_tree_ref)
from repro_torch.obs.cobatch import (SHIFT_KINDS, lane_inputs,  # noqa: E402
                                     pad_shift_departure)

DTYPES = ["float32", "bfloat16"]
FLASH_SHAPES = [(1, 128, 2, 1, 64, True, 0), (2, 256, 4, 2, 64, True, 0),
                (1, 128, 4, 4, 128, False, 0), (1, 256, 2, 2, 64, True, 96),
                (2, 128, 8, 2, 32, True, 0)]
VERIFY_SHAPES = [(2, 4, 4, 2, 64, 512, 0), (1, 4, 8, 8, 128, 256, 0),
                 (3, 1, 2, 1, 64, 512, 0), (2, 8, 4, 2, 32, 1024, 0),
                 (2, 4, 4, 2, 64, 1024, 256)]
PACK_SHAPES = [(2, 4, 512, 0.5), (3, 8, 1024, 0.25), (1, 4, 1536, 1.0),
               (2, 4, 512, 0.0)]
# (W, gamma, window) as tests/test_tree.py:59
TREE_SHAPES = [(1, 3, 0), (2, 3, 0), (3, 2, 0), (2, 4, 6), (4, 2, 5)]


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else \
        dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(scope="module")
def jx():
    """The JAX half.  The comparisons must not depend on what ran before
    in this process: start from a fresh compile state (as
    tests/test_tree.py does), pay the process's first Pallas interpret
    compile on a throwaway call so that no compared case is it, and pin
    torch to 2 threads for this module (the count is restored after
    it)."""
    pytest.importorskip("jax")
    import gc

    import jax
    import jax.numpy as jnp
    from repro.kernels.extract_pack.kernel import extract_pack
    from repro.kernels.flash_attn.kernel import flash_attention as jflash
    from repro.kernels.verify_attn.kernel import verify_attention as jverify
    from repro.models import attention as jattn
    jax.clear_caches()
    gc.collect()
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    z = jnp.zeros((1, 64, 1, 32), jnp.float32)
    jflash(z, z, z, causal=True, block_q=64, block_kv=64,
           interpret=True).block_until_ready()
    yield dict(jax=jax, jnp=jnp, extract_pack=extract_pack, flash=jflash,
               verify=jverify, attn=jattn)
    torch.set_num_threads(threads)


def _both(x, dtype, jnp):
    """The same numpy array as a JAX and a torch CPU array of ``dtype``
    (both round fp32 -> bf16 to nearest even)."""
    return (jnp.asarray(x, getattr(jnp, dtype)),
            torch.tensor(np.asarray(x, np.float32)).to(getattr(torch, dtype)))


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _attention_f64(q, k, v, *, causal, window, mask=None):
    """Masked GQA softmax attention in float64 numpy over the torch
    inputs as given (after their dtype's rounding).  ``mask``: a
    (B, T, S) bool array in place of the causal/window prefill mask
    (every row must see a key)."""
    qf, kf, vf = (np.asarray(x.float().numpy(), np.float64) for x in (q, k, v))
    s, hq, d = qf.shape[1], qf.shape[2], qf.shape[3]
    g = hq // kf.shape[2]
    if mask is None:
        qi, ki = np.arange(s)[:, None], np.arange(s)[None, :]
        mask = np.ones((s, s), bool)
        if causal:
            mask &= ki <= qi
        if window:
            mask &= ki > qi - window
    out = np.zeros_like(qf)
    for h in range(hq):
        sc = np.einsum("bqd,bkd->bqk", qf[:, :, h], kf[:, :, h // g]) \
            / np.sqrt(d)
        sc = np.where(mask, sc, -np.inf)
        p = np.exp(sc - sc.max(-1, keepdims=True))
        out[:, :, h] = np.einsum("bqk,bkd->bqd", p / p.sum(-1, keepdims=True),
                                 vf[:, :, h // g])
    return out


# ------------------------------------------------ plain versions vs JAX
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,s,hq,hk,d,causal,window", FLASH_SHAPES)
def test_flash_ref_vs_pallas(jx, b, s, hq, hk, d, causal, window, dtype):
    rng = np.random.default_rng(1)
    q, tq = _both(rng.normal(size=(b, s, hq, d)), dtype, jx["jnp"])
    k, tk = _both(rng.normal(size=(b, s, hk, d)), dtype, jx["jnp"])
    v, tv = _both(rng.normal(size=(b, s, hk, d)), dtype, jx["jnp"])
    want = jx["flash"](q, k, v, causal=causal, window=window, block_q=64,
                       block_kv=64, interpret=True)
    got = flash_attention_ref(tq, tk, tv, causal=causal, window=window)
    # each side against a float64 oracle first, so that a failure names
    # the side that departs; a second port call says whether a
    # departure is transient
    oracle = _attention_f64(tq, tk, tv, causal=causal, window=window)
    again = flash_attention_ref(tq, tk, tv, causal=causal, window=window)
    repeat = ("second port call equal" if torch.equal(again, got) else
              "second port call differs, max abs vs float64 "
              f"{np.abs(_f32(again) - oracle).max():.3g}")
    cap = torch.backends.cpu.get_cpu_capability()
    state = (f"torch {torch.__version__} {cap} x{torch.get_num_threads()}"
             f", fp32 matmul precision "
             f"{torch.get_float32_matmul_precision()!r}, {repeat}"
             f", jax {jx['jax'].__version__}")
    for name, x in (("Pallas (interpret)", want), ("port plain", got)):
        off = np.abs(_f32(x) - oracle) > 2 * _tol(dtype)["atol"]
        np.testing.assert_allclose(
            _f32(x), oracle, **_tol(dtype),
            err_msg=f"{name} vs float64 ({state}); query rows off: "
                    f"{sorted(set(np.nonzero(off)[1].tolist()))[:16]}")
    np.testing.assert_allclose(_f32(got), _f32(want), **_tol(dtype))


def test_plain_attention_independent_of_fp32_matmul_mode():
    """The plain attention (the CPU path of every attention kernel, and
    the card's comparison) holds the fp32 tolerance against float64 under
    ``torch.set_float32_matmul_precision("medium")``, which lets an fp32
    product run in reduced precision: prefill at the shape of
    test_flash_ref_vs_pallas's first case, verify at T = 4 and a tree of
    W 2, gamma 3."""
    from repro_torch.kernels.verify_attn.ref import tree_mask, verify_mask
    rng = np.random.default_rng(1)

    def rnd(*shape):
        return torch.tensor(rng.normal(size=shape), dtype=torch.float32)

    q, k, v = rnd(1, 128, 2, 64), rnd(1, 128, 1, 64), rnd(1, 128, 1, 64)
    qv, kv, vv = rnd(2, 4, 4, 64), rnd(2, 512, 2, 64), rnd(2, 512, 2, 64)
    qt = rnd(2, 7, 4, 64)
    lengths = torch.tensor([100, 401], dtype=torch.int32)
    pad = torch.tensor([3, 50], dtype=torch.int32)
    mode = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("medium")
        cases = [
            ("flash", flash_attention_ref(q, k, v, causal=True),
             _attention_f64(q, k, v, causal=True, window=0)),
            ("verify", verify_attention_ref(qv, kv, vv, lengths, pad),
             _attention_f64(qv, kv, vv, causal=True, window=0,
                            mask=verify_mask(lengths, 4, 512, pad).numpy())),
            ("tree", verify_attention_tree_ref(qt, kv, vv, lengths, pad,
                                               tree=(2, 3)),
             _attention_f64(qt, kv, vv, causal=True, window=0,
                            mask=tree_mask(lengths, (2, 3), 512,
                                           pad).numpy()))]
    finally:
        torch.set_float32_matmul_precision(mode)
    for name, got, want in cases:
        np.testing.assert_allclose(_f32(got), want, **_tol("float32"),
                                   err_msg=name)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,t,hq,hk,d,s,window", VERIFY_SHAPES)
def test_verify_ref_vs_pallas(jx, b, t, hq, hk, d, s, window, dtype):
    jnp = jx["jnp"]
    rng = np.random.default_rng(7)
    q, tq = _both(rng.normal(size=(b, t, hq, d)), dtype, jnp)
    k, tk = _both(rng.normal(size=(b, s, hk, d)), dtype, jnp)
    v, tv = _both(rng.normal(size=(b, s, hk, d)), dtype, jnp)
    lengths = rng.integers(t + 1, s - t, size=(b,)).astype(np.int32)
    pad = np.minimum(rng.integers(0, s // 4, size=(b,)),
                     lengths - 1).astype(np.int32)
    want = jx["verify"](q, k, v, jnp.asarray(lengths), jnp.asarray(pad),
                        window=window, block_kv=128, interpret=True)
    got = verify_attention_ref(tq, tk, tv, torch.tensor(lengths),
                               torch.tensor(pad), window=window)
    np.testing.assert_allclose(_f32(got), _f32(want), **_tol(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,t,f,p", PACK_SHAPES)
def test_pack_ref_vs_pallas_exact(jx, b, t, f, p, dtype):
    jnp = jx["jnp"]
    rng = np.random.default_rng(3)
    feats, tfeats = _both(rng.normal(size=(b, t, f)), dtype, jnp)
    toks = rng.integers(0, 999, size=(b, t)).astype(np.int32)
    mask = rng.random((b, t)) < p
    pf, pt, cnt = jx["extract_pack"](feats, jnp.asarray(toks),
                                     jnp.asarray(mask), interpret=True)
    rf, rt, rc = extract_pack_ref(tfeats, torch.tensor(toks),
                                  torch.tensor(mask))
    np.testing.assert_array_equal(rc.numpy(), np.asarray(cnt))
    np.testing.assert_array_equal(rt.numpy(), np.asarray(pt))
    np.testing.assert_array_equal(_f32(rf), _f32(pf))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("window", [0, 24])
def test_flash_pad_vs_masked_attend(jx, dtype, window):
    """The serving prefill's pad mask (models/attention.py:404-412):
    rows at or past pad[b] match JAX's masked ``attend``; rows before
    it are zeros."""
    jnp = jx["jnp"]
    b, s, hq, hk, d = 3, 40, 4, 2, 32
    rng = np.random.default_rng(11)
    q, tq = _both(rng.normal(size=(b, s, hq, d)), dtype, jnp)
    k, tk = _both(rng.normal(size=(b, s, hk, d)), dtype, jnp)
    v, tv = _both(rng.normal(size=(b, s, hk, d)), dtype, jnp)
    pad = np.array([0, 7, 33], np.int32)
    kpos = jnp.arange(s)[None, None, :]
    qpos = jnp.arange(s)[None, :, None]
    msk = (kpos <= qpos) & (kpos >= jnp.asarray(pad)[:, None, None])
    if window:
        msk = msk & (kpos > qpos - window)
    want = _f32(jx["attn"].attend(q, k, v, msk[:, None, None]))
    got = _f32(flash_attention(tq, tk, tv, torch.tensor(pad),
                               window=window))
    assert np.isfinite(got).all()
    for i in range(b):
        np.testing.assert_allclose(got[i, pad[i]:], want[i, pad[i]:],
                                   **_tol(dtype))
        assert not got[i, :pad[i]].any()


def test_verify_ref_vs_decode_attend(jx):
    """The verify plain version is the JAX model's ``decode_attend``."""
    jnp = jx["jnp"]
    rng = np.random.default_rng(5)
    b, t, hq, hk, d, s = 3, 4, 4, 2, 32, 64
    q, tq = _both(rng.normal(size=(b, t, hq, d)), "float32", jnp)
    k, tk = _both(rng.normal(size=(b, s, hk, d)), "float32", jnp)
    v, tv = _both(rng.normal(size=(b, s, hk, d)), "float32", jnp)
    lengths = np.array([5, 30, 59], np.int32)
    pad = np.array([0, 3, 20], np.int32)
    want = jx["attn"].decode_attend(q, k, v, jnp.asarray(lengths),
                                    jnp.asarray(pad))
    got = verify_attention(tq, tk, tv, torch.tensor(lengths),
                           torch.tensor(pad))
    np.testing.assert_allclose(_f32(got), _f32(want), **_tol("float32"))


# ------------------------------------------------------- CPU dispatch
def test_wrappers_take_plain_version_on_cpu():
    rng = np.random.default_rng(2)
    q = torch.tensor(rng.normal(size=(2, 16, 4, 32)), dtype=torch.float32)
    k = torch.tensor(rng.normal(size=(2, 16, 2, 32)), dtype=torch.float32)
    counts = (flash_attention.launches, verify_attention.launches,
              pack_signals.launches)
    pad = torch.tensor([0, 3])
    assert torch.equal(flash_attention(q, k, k, pad),
                       flash_attention_ref(q, k, k, pad))
    lengths = torch.tensor([4, 9])
    assert torch.equal(verify_attention(q[:, :4], k, k, lengths, pad),
                       verify_attention_ref(q[:, :4], k, k, lengths, pad))
    mask = torch.tensor([[True, False] * 8, [False, True] * 8])
    toks = torch.arange(32, dtype=torch.int32).reshape(2, 16)
    for a, b_ in zip(pack_signals(q[..., 0, :], toks, mask),
                     extract_pack_ref(q[..., 0, :], toks, mask)):
        assert torch.equal(a, b_)
    assert counts == (flash_attention.launches, verify_attention.launches,
                      pack_signals.launches), "CPU calls counted as launches"


@pytest.mark.parametrize("dtype", DTYPES)
def test_pack_out_slot_on_cpu(dtype):
    """``pack_signals(..., out=slot)`` on the CPU writes extract_pack_ref's
    result into one slot of stacked (K, B, T, F), (K, B, T) and (K, B)
    buffers, returns that slot, leaves every other slot as it was and
    counts no launch (decode_superstep packs each round so)."""
    rng = np.random.default_rng(14)
    b, t, f, k, at = 3, 4, 64, 5, 2
    feats = torch.tensor(rng.normal(size=(b, t, f)),
                         dtype=getattr(torch, dtype))
    toks = torch.tensor(rng.integers(0, 999, size=(b, t)), dtype=torch.int32)
    mask = torch.tensor([[True, False, True, True], [False] * 4,
                         [False, True, False, True]])
    bufs = (torch.full((k, b, t, f), 7.0, dtype=feats.dtype),
            torch.full((k, b, t), 7, dtype=torch.int32),
            torch.full((k, b), 7, dtype=torch.int32))
    before = tuple(x.clone() for x in bufs)
    n0 = pack_signals.launches
    got = pack_signals(feats, toks, mask, out=tuple(x[at] for x in bufs))
    rest = [i for i in range(k) if i != at]
    for buf, old, g, w in zip(bufs, before, got,
                              extract_pack_ref(feats, toks, mask)):
        assert g.data_ptr() == buf[at].data_ptr()
        assert torch.equal(buf[at], w)
        assert torch.equal(buf[rest], old[rest])
    assert pack_signals.launches == n0, "CPU calls counted as launches"


def _bad_pack_out(kind, b, t, f):
    """A (packed_feats, packed_tokens, counts) for (B, T, F) fp32 feats
    with one fault of ``kind``."""
    pf = torch.zeros((b, t, f))
    pt = torch.zeros((b, t), dtype=torch.int32)
    cnt = torch.zeros((b,), dtype=torch.int32)
    return {"pair": (pf, pt),
            "feats_shape": (torch.zeros((b, t, f + 1)), pt, cnt),
            "feats_dtype": (pf.double(), pt, cnt),
            "tokens_shape": (pf, torch.zeros((b, t + 1), dtype=torch.int32),
                             cnt),
            "tokens_dtype": (pf, pt.long(), cnt),
            "counts_shape": (pf, pt, cnt[:, None]),
            "device": (pf.to("meta"), pt, cnt),
            "noncontiguous": (torch.zeros((b, f, t)).transpose(1, 2), pt,
                              cnt)}[kind]


@pytest.mark.parametrize("kind", ["pair", "feats_shape", "feats_dtype",
                                  "tokens_shape", "tokens_dtype",
                                  "counts_shape", "device", "noncontiguous"])
def test_pack_out_refused(kind):
    """An ``out`` that does not fit the inputs raises (the same
    ``checked_out`` guards the kernel's path): nothing is converted,
    reallocated or written elsewhere."""
    b, t, f = 2, 4, 16
    feats = torch.ones((b, t, f))
    toks = torch.ones((b, t), dtype=torch.int32)
    mask = torch.ones((b, t), dtype=torch.bool)
    out = _bad_pack_out(kind, b, t, f)
    with pytest.raises(ValueError):
        pack_signals(feats, toks, mask, out=out)
    assert not any(x.any() for x in out if not x.is_meta)


def test_timing_resolve_reads_each_deferred_once(monkeypatch):
    """``obs.timing.resolve`` replaces every Deferred device time in
    nested dicts and lists by its reading, and reads a Deferred that two
    places share (a row and its head case) once."""
    from repro_torch.obs import timing
    reads = []
    monkeypatch.setattr(timing, "device_ms",
                        lambda fn, match, iters: reads.append(match) or fn())
    d1 = timing.Deferred(lambda: 1.5, ("a",), 20)
    d2 = timing.Deferred(lambda: 2.5, ("b",), 20)
    rows = [{"ms": 3.0, "device_ms": d1,
             "cases": [{"device_ms": d1}, {"device_ms": d2, "T": 1}]}]
    assert timing.resolve(rows) == [
        {"ms": 3.0, "device_ms": 1.5,
         "cases": [{"device_ms": 1.5}, {"device_ms": 2.5, "T": 1}]}]
    assert sorted(reads) == [("a",), ("b",)]


def test_timing_resolve_takes_each_deferreds_reader(monkeypatch):
    """A Deferred made with ``read=`` (``launch_grids``) is resolved by
    that reader, the others by ``device_ms``."""
    from repro_torch.obs import timing
    monkeypatch.setattr(timing, "device_ms", lambda fn, match, iters: 1.0)
    grids = timing.Deferred(lambda: None, ("k",), 1,
                            read=lambda fn, match, iters: [[8, 2, 8]])
    ms = timing.Deferred(lambda: None, ("k",), 20)
    assert timing.resolve({"grid": grids, "ms": ms}) == {
        "grid": [[8, 2, 8]], "ms": 1.0}


def test_linear_rows_plain_on_cpu():
    """On CPU tensors ``linear_rows`` is ``x @ w`` bit for bit (the CPU
    prefill keeps its products) and counts no launch; its split over K
    comes from (N, K) alone, never from the row count."""
    rng = np.random.default_rng(8)
    w = torch.tensor(rng.normal(size=(64, 48)), dtype=torch.float32)
    n0 = linear_rows.launches
    for shape in ((5, 64), (2, 7, 64), (1, 64)):
        x = torch.tensor(rng.normal(size=shape), dtype=torch.float32)
        assert torch.equal(linear_rows(x, w), x @ w)
        assert torch.equal(linear_rows(x.bfloat16(), w.bfloat16()),
                           x.bfloat16() @ w.bfloat16())
    assert linear_rows.launches == n0, "CPU calls counted as launches"
    # glm4-9b's products: k/v (N 256), q/o, ffn up/gate, ffn down, lm_head
    assert [k_splits(n, k) for k, n in ((4096, 256), (4096, 4096),
                                         (4096, 13696), (13696, 4096),
                                         (4096, 151552))] == [4, 1, 1, 1, 1]


def test_linear_rows_tile_matches_source():
    """``k_splits`` counts the kernel's own K chunks over its own column
    tiles: ops.py's BLOCK_N and BLOCK_K are the production tile's of
    csrc/linear_rows.cu (kLrBN, kLrBK)."""
    import re
    from pathlib import Path

    from repro_torch.kernels.linear_rows import ops
    src = (Path(ops.__file__).resolve().parents[2] / "csrc"
           / "linear_rows.cu").read_text()

    def const(name):
        found = re.findall(rf"\b{name}\s*=\s*(\d+)", src)
        assert len(found) == 1, (name, found)
        return int(found[0])

    assert (ops.BLOCK_N, ops.BLOCK_K) == (const("kLrBN"), const("kLrBK"))


# (K, N) of glm4-9b (k/v, q/o, ffn up/gate, ffn down, lm_head) and of
# tide_tiny (q/o, k/v, ffn up/gate, ffn down, lm_head)
SPLIT_KN = [(4096, 256), (4096, 4096), (4096, 13696), (13696, 4096),
            (4096, 151552), (128, 128), (128, 64), (128, 512), (512, 128),
            (128, 512)]


@pytest.mark.parametrize("k,n", SPLIT_KN)
def test_linear_rows_k_splits_contract(k, n):
    """The split over K: 1 <= S <= the kernel's K chunks, at least 8
    chunks a part when S > 1 (as the kernel's split_range cuts them,
    covering every chunk once, in order), and S the same at every row
    count: k_splits is given N and K and nothing else."""
    import inspect

    assert list(inspect.signature(k_splits).parameters) == ["n", "k"]
    s = k_splits(n, k)
    chunks = -(-k // BLOCK_K)
    assert 1 <= s <= chunks
    bounds = [part * chunks // s for part in range(s + 1)]
    assert bounds[0] == 0 and bounds[-1] == chunks
    if s > 1:
        assert min(b - a for a, b in zip(bounds, bounds[1:])) >= 8


# (S, G) of the bf16 backward's schedule sweep: both sides of the 64-key
# and 64-row tile edges, where the rows per split step (S 128 -> 129 at
# G 16, 64 -> 65 at G 1), the draft's training shape (62, 16) and S 512
BWD_SCHEDULE_SG = [(s, g) for g in (1, 2, 4, 16)
                   for s in (1, 2, 15, 16, 17, 31, 33, 62, 63, 64, 65, 100,
                             127, 128, 129, 255, 256, 257, 300, 512, 1000)]
# (rows, keys) tiles: the kernel's (csrc/flash_attn_bwd.cu kTbRows,
# kTbKeys, which repro_flash_attn_bwd_tile reports on the card) and two
# others, so the schedule holds for whatever tiles the kernel is built at
BWD_TILES = [(64, 64), (128, 64), (64, 32)]


def _bwd_causal_pairs(s, g, rows, keys):
    """(row tile, key tile) pairs where some row of the row tile sees some
    key of the key tile, causally: the row tile's last position is at or
    after the key tile's first key."""
    n_rt = -(-s * g // rows)
    return {(rt, j) for rt in range(n_rt) for j in range(-(-s // keys))
            if (min(rt * rows + rows, s * g) - 1) // g >= j * keys}


@pytest.mark.parametrize("rows,keys", BWD_TILES)
@pytest.mark.parametrize("s,g", BWD_SCHEDULE_SG)
def test_bwd_schedule_covers_each_causal_pair_once(s, g, rows, keys):
    """Every causal (row tile, key tile) pair lands in exactly one split of
    its key tile, and no split holds a row tile that sees none of its
    key tile's keys."""
    from repro_torch.kernels.flash_attn.ops import bwd_schedule
    splits, _ = bwd_schedule(s, g, rows, keys)
    seen = [(rt, j) for j, lo, hi, _ in splits for rt in range(lo, hi)]
    assert len(seen) == len(set(seen))
    assert set(seen) == _bwd_causal_pairs(s, g, rows, keys)


@pytest.mark.parametrize("rows,keys", BWD_TILES)
@pytest.mark.parametrize("s,g", BWD_SCHEDULE_SG)
def test_bwd_schedule_order(s, g, rows, keys):
    """Key tiles in ascending order, each one's splits contiguous in the
    table and in ascending row order, back to back, all of one length
    but each key tile's last, which is no longer;
    ``tiles`` names each key tile's first split and count, and every
    split carries its key tile's count."""
    from repro_torch.kernels.flash_attn.ops import bwd_schedule
    splits, tiles = bwd_schedule(s, g, rows, keys)
    assert len(tiles) == -(-s // keys)
    assert [sp[0] for sp in splits] == sorted(sp[0] for sp in splits)
    per = splits[0][2] - splits[0][1]
    for j, (first, n) in enumerate(tiles):
        mine = splits[first:first + n]
        assert n >= 1 and [sp[0] for sp in mine] == [j] * n
        assert all(sp[3] == n for sp in mine)
        assert all(a[2] == b[1] for a, b in zip(mine, mine[1:]))
        assert all(sp[2] - sp[1] == per for sp in mine[:-1])
        assert 0 < mine[-1][2] - mine[-1][1] <= per
    assert sum(n for _, n in tiles) == len(splits)


def test_bwd_schedule_takes_no_batch():
    """The split schedule is a function of (S, G) and the kernel's tiles
    alone: no batch, no data, so a lane's split is the same alone and in
    any batch; at the draft's training shape (S 62, G 16) and 64-row,
    64-key tiles it gives the dK/dV pass 8 splits, 128 blocks at batch 8
    and 2 kv heads; at S 512 key tile 0 also has 8."""
    import inspect

    from repro_torch.kernels.flash_attn.ops import BWD_SPLITS, bwd_schedule
    assert list(inspect.signature(bwd_schedule).parameters) == [
        "s", "g", "rows", "keys"]
    splits, tiles = bwd_schedule(62, 16, 64, 64)
    assert len(splits) * 2 * 8 == 128 and tiles == [(0, BWD_SPLITS)]
    assert bwd_schedule(512, 16, 64, 64)[1][0] == (0, BWD_SPLITS)


def test_wrappers_refuse_mixed_devices():
    q = torch.zeros((1, 8, 2, 32))
    with pytest.raises(ValueError):
        flash_attention(q, q.to("meta"), q)


# ----------------------------------------------- CUDA kernels (card only)
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(shape, dtype, dev, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return torch.randn(shape, generator=g).to(device=dev,
                                              dtype=getattr(torch, dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,s,hq,hk,d,causal,window", FLASH_SHAPES + [
    (3, 100, 32, 2, 128, True, 0)])
def test_cuda_flash_vs_plain(cuda, b, s, hq, hk, d, causal, window, dtype):
    q = _randn((b, s, hq, d), dtype, cuda, 1)
    k = _randn((b, s, hk, d), dtype, cuda, 2)
    v = _randn((b, s, hk, d), dtype, cuda, 3)
    pad = torch.arange(b, device=cuda, dtype=torch.int32) * 5
    n0 = flash_attention.launches
    got = flash_attention(q, k, v, pad, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == n0 + 1
    want = flash_attention_ref(q, k, v, pad, causal=causal, window=window)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(_f32(got.cpu()), _f32(want.cpu()),
                               **_tol(dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,t,hq,hk,d,s,window", VERIFY_SHAPES + [
    (8, 4, 32, 2, 128, 1024, 0), (8, 511, 32, 2, 128, 1024, 0)])
def test_cuda_verify_vs_plain(cuda, b, t, hq, hk, d, s, window, dtype):
    q = _randn((b, t, hq, d), dtype, cuda, 4)
    k = _randn((b, s, hk, d), dtype, cuda, 5)
    v = _randn((b, s, hk, d), dtype, cuda, 6)
    g = np.random.default_rng(9)
    lengths = torch.tensor(g.integers(0, s - t, size=(b,)), dtype=torch.int32,
                           device=cuda)
    pad = torch.minimum(torch.tensor(g.integers(0, s // 4, size=(b,)),
                                     dtype=torch.int32, device=cuda), lengths)
    got = verify_attention(q, k, v, lengths, pad, window=window)
    want = verify_attention_ref(q, k, v, lengths, pad, window=window)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(_f32(got.cpu()), _f32(want.cpu()),
                               **_tol(dtype))


@pytest.mark.gpu
def test_cuda_masked_nonfinite_never_leaks(cuda):
    """Non-finite K/V at masked positions must not reach the output."""
    b, t, hq, hk, d, s = 2, 4, 8, 2, 64, 256
    q = _randn((b, t, hq, d), "bfloat16", cuda, 7)
    k = _randn((b, s, hk, d), "bfloat16", cuda, 8)
    v = _randn((b, s, hk, d), "bfloat16", cuda, 9)
    lengths = torch.tensor([40, 100], dtype=torch.int32, device=cuda)
    pad = torch.tensor([10, 0], dtype=torch.int32, device=cuda)
    k[0, :10] = float("nan")
    v[0, :10] = float("inf")
    k[:, 120:] = float("nan")
    v[:, 120:] = float("nan")
    out = verify_attention(q, k, v, lengths, pad)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    kp = _randn((b, 64, hk, d), "bfloat16", cuda, 10)
    vp = kp.clone()
    vp[1, :5] = float("nan")
    o2 = flash_attention(_randn((b, 64, hq, d), "bfloat16", cuda, 11), kp, vp,
                         torch.tensor([0, 5], dtype=torch.int32, device=cuda))
    assert torch.isfinite(o2).all()
    assert not o2[1, :5].any()


# beyond PACK_SHAPES (which the Pallas kernel takes too): the main path's
# shape, T 1, T = MAX_T at density 0.5, all true and all false, and rows
# of 1001 and 1003 elements, no multiple of 16 bytes (the scalar path)
CUDA_PACK_SHAPES = PACK_SHAPES + [
    (8, 4, 12288, 0.6), (5, 1, 4096, 0.5), (3, MAX_T, 1024, 0.5),
    (2, MAX_T, 512, 1.0), (2, MAX_T, 512, 0.0), (3, 4, 1001, 0.5),
    (2, 8, 1003, 0.7)]


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["contiguous", "misaligned", "out_slot"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,t,f,p", CUDA_PACK_SHAPES)
def test_cuda_pack_vs_plain_exact(cuda, b, t, f, p, dtype, layout):
    """The kernel equals the plain version bit for bit, with one launch.
    ``misaligned``: feats a contiguous view one element past a 16-byte
    boundary (the scalar path); ``out_slot``: the kernel writes slot 1
    of stacked buffers and leaves slots 0 and 2 as they were."""
    feats = _randn((b, t, f), dtype, cuda, 12)
    if layout == "misaligned":
        flat = torch.empty(b * t * f + 1, dtype=feats.dtype, device=cuda)
        feats = flat[1:].view(b, t, f).copy_(feats)
        assert feats.is_contiguous() and feats.data_ptr() % 16
    g = torch.Generator(device="cpu").manual_seed(13)
    toks = torch.randint(0, 999, (b, t), generator=g,
                         dtype=torch.int32).to(cuda)
    mask = (torch.rand((b, t), generator=g) < p).to(cuda)
    want = extract_pack_ref(feats, toks, mask)
    n0 = pack_signals.launches
    if layout == "out_slot":
        bufs = tuple(torch.full((3, *w.shape), 7, dtype=w.dtype, device=cuda)
                     for w in want)
        got = pack_signals(feats, toks, mask, out=tuple(x[1] for x in bufs))
        torch.cuda.synchronize()
        for buf in bufs:
            assert (buf[0] == 7).all() and (buf[2] == 7).all()
    else:
        got = pack_signals(feats, toks, mask)
        torch.cuda.synchronize()
    assert pack_signals.launches == n0 + 1
    for a, w in zip(got, want):
        assert torch.equal(a, w)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["t_past_max", "float64", "out_shape"])
def test_cuda_pack_refuses(cuda, kind):
    """What the kernel does not take raises on the card; nothing falls
    back to the plain version."""
    b, t, f = 2, MAX_T + 1 if kind == "t_past_max" else 4, 64
    dtype = torch.float64 if kind == "float64" else torch.bfloat16
    feats = torch.zeros((b, t, f), dtype=dtype, device=cuda)
    toks = torch.zeros((b, t), dtype=torch.int32, device=cuda)
    mask = torch.ones((b, t), dtype=torch.bool, device=cuda)
    out = None
    if kind == "out_shape":
        out = (torch.empty((b, t, f + 8), dtype=dtype, device=cuda),
               toks.clone(), toks[:, 0].clone())
    n0 = pack_signals.launches
    with pytest.raises(ValueError):
        pack_signals(feats, toks, mask, out=out)
    assert pack_signals.launches == n0


# ------------------------------------------ paged CUDA kernels (card only)
# (b, t, hq, hk, d, page, n_tbl, window); t = 0 marks the prefill kernel
PAGED_SHAPES = [(2, 4, 4, 2, 64, 16, 8, 0), (3, 1, 8, 2, 64, 8, 16, 0),
                (2, 4, 4, 2, 32, 12, 10, 0), (2, 8, 4, 2, 64, 16, 8, 24),
                (8, 4, 32, 2, 128, 16, 64, 0), (8, 1, 32, 2, 128, 16, 64, 0),
                (8, 511, 32, 2, 128, 16, 64, 0)]
FLASH_PAGED_SHAPES = [(2, 64, 4, 2, 64, 16, 0), (3, 100, 8, 2, 64, 12, 0),
                      (2, 40, 4, 2, 32, 8, 16), (8, 512, 32, 2, 128, 16, 0)]


def _paged_case(b, hk, d, page, n_tbl, dtype, dev, seed, need):
    """Pools with every table row a shuffled, non-contiguous page list;
    lanes 0 and 1 share their first page; entries past ``need[b]`` pages
    point at the trash page (the last one)."""
    g = np.random.default_rng(seed)
    n_pages = b * n_tbl
    k_pool = _randn((n_pages + 1, page, hk, d), dtype, dev, seed)
    v_pool = _randn((n_pages + 1, page, hk, d), dtype, dev, seed + 1)
    perm = g.permutation(n_pages)
    tbl = np.full((b, n_tbl), n_pages, np.int32)
    for lane in range(b):
        tbl[lane, :need[lane]] = perm[lane * n_tbl:lane * n_tbl + need[lane]]
    if b > 1:
        tbl[1, 0] = tbl[0, 0]
    return k_pool, v_pool, torch.tensor(tbl, device=dev)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,t,hq,hk,d,page,n_tbl,window", PAGED_SHAPES)
def test_cuda_verify_paged_vs_plain_and_dense(cuda, b, t, hq, hk, d, page,
                                               n_tbl, window, dtype):
    smax = page * n_tbl
    g = np.random.default_rng(21)
    lengths = g.integers(0, smax - t + 1, size=(b,)).astype(np.int32)
    pad = np.minimum(g.integers(0, smax // 4, size=(b,)), lengths)
    need = [-(-int(n + t) // page) for n in lengths]
    k_pool, v_pool, tbl = _paged_case(b, hk, d, page, n_tbl, dtype, cuda,
                                      31, need)
    q = _randn((b, t, hq, d), dtype, cuda, 33)
    ln = torch.tensor(lengths, device=cuda)
    pd = torch.tensor(pad, dtype=torch.int32, device=cuda)
    n0 = verify_attention_paged.launches
    got = verify_attention_paged(q, k_pool, v_pool, tbl, ln, pd,
                                 window=window)
    dense = verify_attention(q, gather_view(k_pool, tbl),
                             gather_view(v_pool, tbl), ln, pd, window=window)
    want = verify_attention_paged_ref(q, k_pool, v_pool, tbl, ln, pd,
                                      window=window)
    torch.cuda.synchronize()
    assert verify_attention_paged.launches == n0 + 1
    assert torch.isfinite(got).all()
    assert torch.equal(got, dense), "paged != dense kernel on the view"
    np.testing.assert_allclose(_f32(got.cpu()), _f32(want.cpu()),
                               **_tol(dtype))
    # the trash page and every page past lengths + t are never read
    k_pool[-1] = float("nan")
    v_pool[-1] = float("nan")
    again = verify_attention_paged(q, k_pool, v_pool, tbl, ln, pd,
                                   window=window)
    torch.cuda.synchronize()
    assert torch.equal(again, got)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,s,hq,hk,d,page,window", FLASH_PAGED_SHAPES)
def test_cuda_flash_paged_vs_plain_and_dense(cuda, b, s, hq, hk, d, page,
                                             window, dtype):
    n_tbl = -(-s // page) + 2
    need = [-(-s // page)] * b
    k_pool, v_pool, tbl = _paged_case(b, hk, d, page, n_tbl, dtype, cuda,
                                      41, need)
    q = _randn((b, s, hq, d), dtype, cuda, 43)
    pad = (torch.arange(b, device=cuda, dtype=torch.int32) * 7) % s
    n0 = flash_attention_paged.launches
    got = flash_attention_paged(q, k_pool, v_pool, tbl, pad, window=window)
    dense = flash_attention(q, gather_view(k_pool, tbl)[:, :s].contiguous(),
                            gather_view(v_pool, tbl)[:, :s].contiguous(), pad,
                            window=window)
    want = flash_attention_paged_ref(q, k_pool, v_pool, tbl, pad,
                                     window=window)
    torch.cuda.synchronize()
    assert flash_attention_paged.launches == n0 + 1
    assert torch.isfinite(got).all()
    assert torch.equal(got, dense), "paged != dense kernel on the view"
    np.testing.assert_allclose(_f32(got.cpu()), _f32(want.cpu()),
                               **_tol(dtype))
    k_pool[-1] = float("nan")
    v_pool[-1] = float("nan")
    again = flash_attention_paged(q, k_pool, v_pool, tbl, pad, window=window)
    torch.cuda.synchronize()
    assert torch.equal(again, got)


@pytest.mark.gpu
def test_cuda_paged_refuses_dense_cache(cuda):
    """A layer-stacked pool leaf or a table of the wrong batch raises
    before any launch."""
    q = _randn((2, 4, 4, 64), "bfloat16", cuda, 1)
    pool = _randn((3, 9, 16, 2, 64), "bfloat16", cuda, 2)
    tbl = torch.zeros((2, 4), dtype=torch.int32, device=cuda)
    ln = torch.tensor([3, 5], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        verify_attention_paged(q, pool, pool, tbl, ln)
    with pytest.raises(ValueError):
        verify_attention_paged(q, pool[0], pool[0], tbl[:1], ln)
    with pytest.raises(ValueError):
        flash_attention_paged(_randn((2, 100, 4, 64), "bfloat16", cuda, 3),
                              pool[0], pool[0], tbl)


# --------------------------------------- tree-mode verify kernels (card only)
def _tree_case(b, w, g, hq, hk, d, s, dtype, dev, seed):
    """Queries of a W-branch tree block and a cache; lane lengths spread
    over the cache, the last one so close to the end that the block runs
    past it; pads below each length."""
    t = w * g + 1
    q = _randn((b, t, hq, d), dtype, dev, seed)
    k = _randn((b, s, hk, d), dtype, dev, seed + 1)
    v = _randn((b, s, hk, d), dtype, dev, seed + 2)
    rng = np.random.default_rng(seed)
    lengths = rng.integers(t, s - t, size=(b,))
    lengths[-1] = s - 2
    pad = np.minimum(rng.integers(0, s // 4, size=(b,)), lengths - 1)
    return (q, k, v, torch.tensor(lengths, dtype=torch.int32, device=dev),
            torch.tensor(pad, dtype=torch.int32, device=dev))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,w,g,window,hq,hk,d,s", [
    (2, w, g, win, 4, 2, 64, 256) for w, g, win in TREE_SHAPES] + [
    (8, 4, 3, 0, 32, 2, 128, 1024), (8, 4, 3, 24, 32, 2, 128, 1024)])
def test_cuda_verify_tree_vs_plain(cuda, b, w, g, window, hq, hk, d, s,
                                   dtype):
    """The kernel's tree mode against its plain version; at W = 1 it is
    the chain kernel bit for bit."""
    q, k, v, ln, pd = _tree_case(b, w, g, hq, hk, d, s, dtype, cuda, 51)
    n0 = (verify_attention.launches, verify_attention.tree_launches)
    got = verify_attention(q, k, v, ln, pd, window=window, tree=(w, g))
    want = verify_attention_tree_ref(q, k, v, ln, pd, tree=(w, g),
                                     window=window)
    torch.cuda.synchronize()
    assert (verify_attention.launches, verify_attention.tree_launches) == \
        (n0[0] + 1, n0[1] + 1)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(_f32(got.cpu()), _f32(want.cpu()),
                               **_tol(dtype))
    if w == 1:
        chain = verify_attention(q, k, v, ln, pd, window=window)
        torch.cuda.synchronize()
        assert torch.equal(got, chain), "tree W=1 != chain kernel"


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,w,g,window,hq,hk,d,page,n_tbl", [
    (2, w, g, win, 4, 2, 64, 16, 16) for w, g, win in TREE_SHAPES] + [
    (8, 4, 3, 0, 32, 2, 128, 16, 64), (8, 4, 3, 24, 32, 2, 128, 16, 64)])
def test_cuda_verify_tree_paged_vs_dense(cuda, b, w, g, window, hq, hk, d,
                                         page, n_tbl, dtype):
    """The paged kernel's tree mode equals the dense kernel's on the
    gathered view bit for bit, matches the plain version, and never reads
    the trash page."""
    from repro_torch.kernels.verify_attn.ref import (
        verify_attention_tree_paged_ref)
    t = w * g + 1
    smax = page * n_tbl
    g_ = np.random.default_rng(61)
    lengths = g_.integers(t, smax - t, size=(b,)).astype(np.int32)
    pad = np.minimum(g_.integers(0, smax // 4, size=(b,)), lengths - 1)
    need = [-(-int(n + t) // page) for n in lengths]
    k_pool, v_pool, tbl = _paged_case(b, hk, d, page, n_tbl, dtype, cuda,
                                      63, need)
    q = _randn((b, t, hq, d), dtype, cuda, 65)
    ln = torch.tensor(lengths, device=cuda)
    pd = torch.tensor(pad, dtype=torch.int32, device=cuda)
    n0 = verify_attention_paged.tree_launches
    got = verify_attention_paged(q, k_pool, v_pool, tbl, ln, pd,
                                 window=window, tree=(w, g))
    dense = verify_attention(q, gather_view(k_pool, tbl),
                             gather_view(v_pool, tbl), ln, pd, window=window,
                             tree=(w, g))
    want = verify_attention_tree_paged_ref(q, k_pool, v_pool, tbl, ln, pd,
                                           tree=(w, g), window=window)
    torch.cuda.synchronize()
    assert verify_attention_paged.tree_launches == n0 + 1
    assert torch.isfinite(got).all()
    assert torch.equal(got, dense), "paged tree != dense tree on the view"
    np.testing.assert_allclose(_f32(got.cpu()), _f32(want.cpu()),
                               **_tol(dtype))
    k_pool[-1] = float("nan")
    v_pool[-1] = float("nan")
    again = verify_attention_paged(q, k_pool, v_pool, tbl, ln, pd,
                                   window=window, tree=(w, g))
    torch.cuda.synchronize()
    assert torch.equal(again, got)


# ------------------------- the bf16 tensor-core prefill at tile edges (card)
def _rel_l2(got, want):
    got, want = got.float(), want.float()
    return float((got - want).norm() / want.norm())


@pytest.mark.gpu
@pytest.mark.parametrize("s", [1, 63, 64, 65, 511, 512])
@pytest.mark.parametrize("hq,hk,d", [(32, 2, 128), (8, 2, 64), (2, 1, 32)])
def test_cuda_flash_bf16_tile_edges(cuda, s, hq, hk, d):
    """The bf16 prefill (dense and paged) against its plain version where
    a 64-row or 64-key tile ends: per element at the bf16 tolerance and
    as a whole at relative L2 below 1e-3 (chip_smoke.py's REL_L2_TOL);
    paged equals dense on the gathered view, bit for bit."""
    b, page = 3, 16
    q = _randn((b, s, hq, d), "bfloat16", cuda, 71)
    n_tbl = -(-s // page) + 1
    k_pool, v_pool, tbl = _paged_case(b, hk, d, page, n_tbl, "bfloat16",
                                      cuda, 73, [-(-s // page)] * b)
    k = gather_view(k_pool, tbl)[:, :s].contiguous()
    v = gather_view(v_pool, tbl)[:, :s].contiguous()
    pad = torch.tensor([0, min(5, s), s // 2], dtype=torch.int32, device=cuda)
    got = flash_attention(q, k, v, pad)
    paged = flash_attention_paged(q, k_pool, v_pool, tbl, pad)
    want = flash_attention_ref(q, k, v, pad)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert torch.equal(paged, got), "paged != dense kernel on the view"
    np.testing.assert_allclose(_f32(got.cpu()), _f32(want.cpu()),
                               **_tol("bfloat16"))
    if want.abs().sum() > 0:
        assert _rel_l2(got, want) < 1e-3
    for lane in range(b):
        assert not got[lane, :int(pad[lane])].any(), "rows before pad"


# --------------------------------- pad-shift invariance, bit for bit (card)
@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("hq,hk,d", [(32, 2, 128), (8, 2, 64)])
@pytest.mark.parametrize("kind", SHIFT_KINDS)
def test_cuda_pad_shift_bitwise(cuda, kind, hq, hk, d, dtype):
    """A lane's attention does not depend on where its prompt sits: its
    left pad, its row's width and the other lanes of the batch
    (``obs.cobatch.placed_rows``: pads 0, 5, 17, 31, 32, 100, rows 0, 40
    and 100 wider).  The refill pads each prompt to the widest of its
    batch, so without this a greedy stream depends on the prompts it was
    admitted with."""
    lane = lane_inputs(150, hq, hk, d, getattr(torch, dtype), cuda, 81)
    moved = pad_shift_departure(kind, lane)
    torch.cuda.synchronize()
    assert moved is None, \
        f"{kind}: rows at (pad, width +) {moved} differ from pad 0's"


# ------------------------- a chunked refill's continuation shape (card)
@pytest.mark.gpu
def test_cuda_verify_chunk_shape(cuda):
    """The verify kernel at the shape a chunked refill's continuation
    gives it on glm4-9b: 8 lanes of T 128 query rows against a 512-row
    staging cache, bf16, pads up to 400 (rows before a lane's pad see no
    key and are zero), against its plain version at the bf16 tolerance
    and at relative L2 below 1e-3; one launch, counted at T 128; and a
    lane's rows do not move with its pad or the batch
    (``pad_shift_departure("verify128")``)."""
    b, t, hq, hk, d, s = 8, 128, 32, 2, 128, 512
    q = _randn((b, t, hq, d), "bfloat16", cuda, 91)
    k = _randn((b, s, hk, d), "bfloat16", cuda, 92)
    v = _randn((b, s, hk, d), "bfloat16", cuda, 93)
    lengths = torch.tensor([128, 256, 384, 136, 264, 200, 384, 0],
                           dtype=torch.int32, device=cuda)
    pad = torch.tensor([0, 7, 400, 3, 100, 5, 250, 64], dtype=torch.int32,
                       device=cuda)
    n0, n128 = verify_attention.launches, verify_attention.launches_at_t[t]
    got = verify_attention(q, k, v, lengths, pad)
    want = verify_attention_ref(q, k, v, lengths, pad)
    torch.cuda.synchronize()
    assert verify_attention.launches == n0 + 1
    assert verify_attention.launches_at_t[t] == n128 + 1
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(_f32(got.cpu()), _f32(want.cpu()),
                               **_tol("bfloat16"))
    assert _rel_l2(got, want) < 1e-3
    for lane in range(b):
        blind = max(int(pad[lane]) - int(lengths[lane]), 0)
        assert not got[lane, :blind].any(), "rows that see no key"
    lane = lane_inputs(150, hq, hk, d, torch.bfloat16, cuda, 81)
    assert pad_shift_departure("verify128", lane) is None


# ------------------------------------- a refill's batch, layer by layer (card)
@pytest.mark.gpu
def test_cuda_cobatch_attention_never_departs(cuda):
    """glm4-9b at 2 layers, random weights: one prompt refilled alone and
    beside a longer prompt (another pad, width and row count).  No
    attention op may depart on its own; if nothing departs, the K/V
    rows, hidden states and logits are equal bit for bit."""
    import dataclasses

    from repro_torch.configs import get
    from repro_torch.core import eagle
    from repro_torch.models import transformer as T
    from repro_torch.obs.cobatch import cobatch_diff
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.request import Request
    cfg = dataclasses.replace(get("glm4-9b"), num_layers=2)
    dcfg = eagle.draft_config(cfg)
    eng = ServingEngine(cfg, T.init(cfg, 1, device=cuda), dcfg,
                        eagle.draft_init(dcfg, 2, device=cuda), batch_size=2,
                        max_len=512, device=cuda)
    rng = np.random.default_rng(12)
    short = rng.integers(1, cfg.vocab_size, 133).tolist()
    long_ = rng.integers(1, cfg.vocab_size, 301).tolist()

    def batch(prompts):
        reqs = [Request(prompt=p, max_new_tokens=4) for p in prompts]
        for i, r in enumerate(reqs):
            r.sid = i
        return eng._refill_arrays(list(enumerate(reqs)))[:2]

    d = cobatch_diff(cfg, eng.params, (*batch([short]), 0),
                     (*batch([long_, short]), 1))
    print(d)
    assert not [n for n in d["departing_alone"] if n.endswith(".attention")]
    if d["first_departing_op"] is None:
        assert d["kv_rows_equal"] and d["hidden_equal"] and d["logits_equal"]


# ------------------------------ the row-invariant prefill product (card)
# glm4-9b's (K, N): k_proj, q_proj / o_proj, ffn_up, ffn_down, lm_head
LINEAR_KN = [(4096, 256), (4096, 4096), (4096, 13696), (13696, 4096),
             (4096, 151552)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,k,n", [
    ("bfloat16", k, n) for k, n in LINEAR_KN + [(128, 64), (512, 128),
                                                (256, 136)]] + [
    ("float32", k, n) for k, n in LINEAR_KN[:2] + [(128, 64), (512, 128),
                                                   (256, 136)]])
def test_cuda_linear_rows_m_invariant(cuda, dtype, k, n):
    """Row r of ``linear_rows(x, w)`` depends only on row r of x and on
    w, bit for bit: the first M rows at M in {1, 2, 63, 64, 65, 126, 127,
    128, 129, 992} (a consumer warpgroup is 64 rows, a block 128), and
    rows shifted by one, equal the rows of the widest call.  Against
    float64 x @ w: relative L2 below 3e-3 in bf16 (one rounding of the
    output, 2^-9) and 1e-5 in fp32.  N 136 ends in a partial 64-column
    box.  A one-hot x (row r picks row r mod K of w) gives those rows of
    w exactly, which a wrong swizzle or transpose of either operand does
    not.  The built kernel's tile is the one ``k_splits`` counts."""
    t = tile()
    assert (t["BN"], t["BK"]) == (BLOCK_N, BLOCK_K), t
    ms = (1, 2, 63, 64, 65, 126, 127, 128, 129, 992)
    x = _randn((max(ms) + 1, k), dtype, cuda, 91)
    w = _randn((k, n), dtype, cuda, 92) / k ** 0.5
    n0 = linear_rows.launches
    full = linear_rows(x, w)
    for m in ms:
        assert torch.equal(linear_rows(x[:m], w), full[:m]), f"M={m}"
        assert torch.equal(linear_rows(x[1:m + 1], w), full[1:m + 1]), \
            f"M={m} shifted by a row"
    torch.cuda.synchronize()
    assert linear_rows.launches == n0 + 1 + 2 * len(ms)
    cols = slice(0, min(n, 4096))
    want = x[:128].double() @ w[:, cols].double()
    got = full[:128, cols].double()
    assert torch.isfinite(got).all()
    rel = float((got - want).norm() / want.norm())
    assert rel < (3e-3 if dtype == "bfloat16" else 1e-5), rel
    rows = torch.arange(x.shape[0], device=cuda) % k
    onehot = torch.zeros_like(x)
    onehot[torch.arange(x.shape[0], device=cuda), rows] = 1
    assert torch.equal(linear_rows(onehot, w), w[rows]), "one-hot rows"


# ------------------------- the verify routes, each named and held (card)
@pytest.mark.gpu
@pytest.mark.parametrize("window", [0, 24])
@pytest.mark.parametrize("kind", ["T1", "T4", "tree", "T511"])
@pytest.mark.parametrize("hq,hk,d,route", [(8, 2, 64, "fma"),
                                           (32, 2, 128, "tensor_core_bf16")])
def test_cuda_verify_routes(cuda, hq, hk, d, route, kind, window):
    """bf16 verify on each route (``verify_route``): against the plain
    version per element at the bf16 tolerance and as a whole at relative
    L2 below 1e-3 (chip_smoke.py's gate); paged equal to dense on the
    gathered view and tree W = 1 equal to the chain, bit for bit."""
    from repro_torch.kernels.verify_attn.ref import (
        verify_attention_tree_paged_ref)
    assert verify_route(torch.bfloat16, d) == route
    b, page, n_tbl = 4, 16, 40
    smax = page * n_tbl
    tree = (4, 3) if kind == "tree" else (0, 0)
    t = 13 if kind == "tree" else int(kind[1:])
    rng = np.random.default_rng(93)
    lengths = (rng.integers(0, 4, size=b) if t == 511 else
               rng.integers(t, smax - t, size=b)).astype(np.int32)
    pad = np.minimum(rng.integers(0, 60, size=b), np.maximum(lengths - 1, 0))
    need = [-(-int(x + t) // page) for x in lengths]
    k_pool, v_pool, tbl = _paged_case(b, hk, d, page, n_tbl, "bfloat16",
                                      cuda, 95, need)
    k, v = gather_view(k_pool, tbl), gather_view(v_pool, tbl)
    q = _randn((b, t, hq, d), "bfloat16", cuda, 97)
    ln = torch.tensor(lengths, device=cuda)
    pd = torch.tensor(pad, dtype=torch.int32, device=cuda)
    got = verify_attention(q, k, v, ln, pd, window=window, tree=tree)
    paged = verify_attention_paged(q, k_pool, v_pool, tbl, ln, pd,
                                   window=window, tree=tree)
    if tree[0]:
        want = verify_attention_tree_paged_ref(q, k_pool, v_pool, tbl, ln, pd,
                                               tree=tree, window=window)
        one = verify_attention(q[:, :4].contiguous(), k, v, ln, pd,
                               window=window, tree=(1, 3))
        chain = verify_attention(q[:, :4].contiguous(), k, v, ln, pd,
                                 window=window)
    else:
        want = verify_attention_paged_ref(q, k_pool, v_pool, tbl, ln, pd,
                                          window=window)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert torch.equal(paged, got), "paged != dense kernel on the view"
    if tree[0]:
        assert torch.equal(one, chain), "tree W=1 != chain kernel"
    np.testing.assert_allclose(_f32(got.cpu()), _f32(want.cpu()),
                               **_tol("bfloat16"))
    assert _rel_l2(got, want) < 1e-3


# ------------------------ a refill's batch departs nowhere (card, bf16)
@pytest.mark.gpu
def test_cuda_cobatch_no_op_departs(cuda):
    """tide_tiny's widths in bf16 on the card: one prompt refilled alone
    and beside a longer one (another pad, width and row count).  With
    the prefill's products on ``linear_rows`` no op of the prefill
    departs, alone or through its inputs: the verdict is none."""
    import dataclasses

    from repro_torch.configs import get
    from repro_torch.core import eagle
    from repro_torch.models import transformer as T
    from repro_torch.obs.cobatch import cobatch_diff
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.request import Request
    cfg = dataclasses.replace(get("tide-tiny"), dtype="bfloat16")
    dcfg = eagle.draft_config(cfg)
    eng = ServingEngine(cfg, T.init(cfg, 3, device=cuda), dcfg,
                        eagle.draft_init(dcfg, 4, device=cuda), batch_size=3,
                        max_len=256, device=cuda)
    rng = np.random.default_rng(14)
    short = rng.integers(1, cfg.vocab_size, 37).tolist()
    mid = rng.integers(1, cfg.vocab_size, 90).tolist()
    long_ = rng.integers(1, cfg.vocab_size, 200).tolist()

    def batch(prompts):
        reqs = [Request(prompt=p, max_new_tokens=4) for p in prompts]
        for i, r in enumerate(reqs):
            r.sid = i
        return eng._refill_arrays(list(enumerate(reqs)))[:2]

    d = cobatch_diff(cfg, eng.params, (*batch([short]), 0),
                     (*batch([long_, mid, short]), 2))
    print(d)
    assert d["first_departing_op"] is None and not d["departing_alone"], d
    assert d["kv_rows_equal"] and d["hidden_equal"] and d["logits_equal"]


# ------------------------ the prefill attention's backward kernel (card)
# S on both sides of the 64-key and 64-row tiles and where the split
# count steps (G 16: S 128 -> 129; G 1: 64 -> 65), the train phase's 62
BWD_SEQ = [(1, 1), (2, 31), (2, 33), (2, 62), (1, 63), (1, 64), (2, 65),
           (3, 100), (1, 127), (2, 128), (1, 129), (1, 300)]


def _bwd_case(b, s, g, d, dtype, dev, seed, hk=2):
    """q, k, v, dO of a causal GQA training call and the forward's
    output and LSE from the prefill kernel."""
    from repro_torch.kernels.flash_attn.ops import flash_attention as fa
    q = _randn((b, s, hk * g, d), dtype, dev, seed)
    k = _randn((b, s, hk, d), dtype, dev, seed + 1)
    v = _randn((b, s, hk, d), dtype, dev, seed + 2)
    do = _randn((b, s, hk * g, d), dtype, dev, seed + 3)
    o, lse = fa(q, k, v, return_lse=True)
    return q, k, v, o, do, lse


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("g", [1, 4, 16])
@pytest.mark.parametrize("b,s", BWD_SEQ)
def test_cuda_flash_bwd_vs_plain(cuda, b, s, g, d, dtype):
    """flash_attention_bwd against its plain version (float64) on the same
    inputs, S at 1 and on both sides of the 32-key tile, G 1-16: relative
    L2 per gradient below 2e-5 (fp32) or 1e-3 (bf16, chip_smoke.py's
    REL_L2_TOL; both sides rounded once to bf16), bf16 also per element
    at 2e-2; at S 1 dq and dk are 0 but for rounding on both sides (one
    key: dS = 0), held below 1e-4; one launch a call."""
    from repro_torch.kernels.flash_attn.ops import flash_attention_bwd
    from repro_torch.kernels.flash_attn.ref import flash_attention_bwd_ref
    q, k, v, o, do, lse = _bwd_case(b, s, g, d, dtype, cuda, 91)
    n0 = flash_attention_bwd.launches
    got = flash_attention_bwd(q, k, v, o, do, lse)
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches == n0 + 1
    want = flash_attention_bwd_ref(q, k, v, o, do, lse)
    for name, x, y in zip("qkv", got, want):
        assert x.shape == y.shape and x.dtype == y.dtype
        assert torch.isfinite(x).all(), f"d{name} non-finite"
        if name in "qk" and s == 1:   # one key: dS, so dq and dk, are 0
            assert x.abs().max() < 1e-4 and y.abs().max() < 1e-4
            continue
        rel = _rel_l2(x, y)
        assert rel < (1e-3 if dtype == "bfloat16" else 2e-5), (name, rel)
        if dtype == "bfloat16":
            np.testing.assert_allclose(_f32(x.cpu()), _f32(y.cpu()),
                                       **_tol(dtype), err_msg=f"d{name}")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,b,s,g,d", [
    ("bfloat16", 8, 512, 16, 128), ("bfloat16", 8, 63, 16, 128),
    ("float32", 2, 100, 4, 64), ("bfloat16", 8, 62, 16, 128),
    ("bfloat16", 2, 129, 16, 64), ("bfloat16", 3, 65, 1, 32)])
def test_cuda_flash_bwd_deterministic(cuda, dtype, b, s, g, d):
    """No atomics: two calls on the same inputs give equal bits."""
    from repro_torch.kernels.flash_attn.ops import flash_attention_bwd
    args = _bwd_case(b, s, g, d, dtype, cuda, 95)
    first = flash_attention_bwd(*args)
    second = flash_attention_bwd(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(first, second))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("s,g,d", [(62, 16, 128), (512, 16, 128),
                                   (129, 4, 64), (65, 1, 32)])
def test_cuda_flash_bwd_lane_invariant(cuda, s, g, d, dtype):
    """A lane's dq, dk, dv are the same bits when it is the whole batch
    and when it is lane 0 or lane 5 of a batch of 8: no sum's order, and
    no split of the dK/dV pass, depends on the batch."""
    from repro_torch.kernels.flash_attn.ops import flash_attention_bwd
    args = _bwd_case(8, s, g, d, dtype, cuda, 77)
    batch = flash_attention_bwd(*args)
    for lane in (0, 5):
        alone = flash_attention_bwd(*(t[lane:lane + 1].contiguous()
                                      for t in args))
        torch.cuda.synchronize()
        for name, x, y in zip(("dq", "dk", "dv"), alone, batch):
            assert torch.equal(x[0], y[lane]), (name, lane)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,s,hq,hk,d", [(2, 1, 4, 2, 64), (3, 65, 32, 2, 128),
                                         (1, 127, 8, 2, 32),
                                         (8, 512, 32, 2, 128)])
def test_cuda_flash_lse_forward_equal(cuda, b, s, hq, hk, d, dtype):
    """The forward that stores the LSE gives, bit for bit, the output of
    the serving forward (which leaves the pointer null), with a pad too;
    the LSE equals its plain version at 1e-5 (fp32 statistics of the
    same inputs)."""
    from repro_torch.kernels.flash_attn.ref import flash_attention_lse_ref
    q = _randn((b, s, hq, d), dtype, cuda, 97)
    k = _randn((b, s, hk, d), dtype, cuda, 98)
    v = _randn((b, s, hk, d), dtype, cuda, 99)
    for pad in (None, torch.arange(b, device=cuda, dtype=torch.int32) * 3):
        n0 = flash_attention.launches
        out, lse = flash_attention(q, k, v, pad, return_lse=True)
        plain = flash_attention(q, k, v, pad)
        torch.cuda.synchronize()
        assert flash_attention.launches == n0 + 2
        assert torch.equal(out, plain), "the LSE store changed the output"
        want = flash_attention_lse_ref(q, k, pad)
        fin = torch.isfinite(want)
        assert torch.equal(torch.isfinite(lse), fin)
        np.testing.assert_allclose(lse[fin].cpu().numpy(),
                                   want[fin].cpu().numpy(), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["pad", "window", "softcap", "noncausal",
                                  "head_dim", "lse_dtype"])
def test_cuda_flash_bwd_refuses(cuda, kind):
    """What the backward kernel does not take raises on the card: a pad,
    a window, a softcap, a non-causal mask or a head dim outside
    HEAD_DIMS (NotImplementedError whenever a gradient is needed), and an
    LSE that is not float32 (ValueError); no call falls back."""
    from repro_torch.kernels.flash_attn.ops import (attention_train,
                                                    flash_attention_bwd)
    d = 48 if kind == "head_dim" else 64
    q, k, v = [_randn((2, 16, 4, d), "bfloat16", cuda, 5 + i)
               .requires_grad_(True) for i in range(3)]
    n0 = (flash_attention.launches, flash_attention_bwd.launches)
    if kind == "lse_dtype":
        with pytest.raises(ValueError):
            flash_attention_bwd(q.detach(), k.detach(), v.detach(),
                                q.detach(), q.detach(),
                                torch.zeros((2, 16, 4), device=cuda,
                                            dtype=torch.bfloat16))
    else:
        kw = {"pad": dict(pad=torch.tensor([0, 3], device=cuda)),
              "window": dict(window=4), "softcap": dict(softcap=30.0),
              "noncausal": dict(causal=False), "head_dim": {}}[kind]
        with pytest.raises(NotImplementedError):
            attention_train(q, k, v, **kw)
    assert n0 == (flash_attention.launches, flash_attention_bwd.launches)


@pytest.mark.gpu
def test_cuda_flash_bwd_refuses_missing_scratch(cuda):
    """The C entry itself refuses a bf16 split table with a key tile of
    several splits and no scratch for their partial sums, or with fewer
    splits than key tiles (cudaErrorInvalidValue), and launches nothing;
    the same table with the scratch runs."""
    from repro_torch.kernels import stream_of
    from repro_torch.kernels.build import library
    from repro_torch.kernels.flash_attn.ops import _bwd_tables
    b, s, g, d = 2, 62, 16, 64
    q, k, v, o, do, lse = _bwd_case(b, s, g, d, "bfloat16", cuda, 3)
    split, ktile, ws_keys = _bwd_tables(s, g, q.device)
    assert ws_keys and split.shape[0] > ktile.shape[0]
    delta = torch.empty(lse.shape, dtype=torch.float32, device=cuda)
    out = [torch.zeros_like(t) for t in (q, k, v)]
    ws = torch.empty((b, 2, split.shape[0], 2, ws_keys, d),
                     dtype=torch.float32, device=cuda)

    def call(ws_ptr, n_split):
        return library().repro_flash_attn_bwd(
            *(t.data_ptr() for t in (q, k, v, o, do, lse, delta, *out)),
            split.data_ptr(), ktile.data_ptr(), ws_ptr, b, s, 2 * g, 2, d,
            n_split, 1, stream_of(q))

    assert call(None, split.shape[0]) == 1      # cudaErrorInvalidValue
    assert call(ws.data_ptr(), 0) == 1
    torch.cuda.synchronize()
    assert all(not t.any() for t in out), "a refused call wrote"
    assert call(ws.data_ptr(), split.shape[0]) == 0
    torch.cuda.synchronize()
    assert all(t.any() for t in out)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_attention_train_autograd(cuda, dtype):
    """Autograd through ``attention_train`` on the card: one forward
    launch (with the LSE) and one backward launch, the gradients those
    of the plain backward on the kernel's own output, relative L2 as in
    test_cuda_flash_bwd_vs_plain; the TTT pattern (a second call on an
    input that itself needs a gradient) accumulates both."""
    from repro_torch.kernels.flash_attn.ops import (attention_train,
                                                    flash_attention_bwd)
    from repro_torch.kernels.flash_attn.ref import flash_attention_bwd_ref
    q, k, v, _, do, _ = _bwd_case(2, 45, 4, 64, dtype, cuda, 31)
    q, k, v = (t.clone().requires_grad_(True) for t in (q, k, v))
    n0 = (flash_attention.launches, flash_attention_bwd.launches)
    out = attention_train(q, k, v)
    out2 = attention_train(out * 0.5, k, v)
    (out2.float() * do.float()).sum().backward()
    torch.cuda.synchronize()
    assert (flash_attention.launches - n0[0],
            flash_attention_bwd.launches - n0[1]) == (2, 2)
    assert all(torch.isfinite(t.grad).all() for t in (q, k, v))
    q2, k2, v2 = (t.detach() for t in (q, k, v))
    o1, lse1 = flash_attention(q2, k2, v2, return_lse=True)
    q3 = (o1 * 0.5).contiguous()
    o2, lse2 = flash_attention(q3, k2, v2, return_lse=True)
    g3, gk2, gv2 = flash_attention_bwd_ref(q3, k2, v2, o2, do, lse2)
    gq1, gk1, gv1 = flash_attention_bwd_ref(q2, k2, v2, o1,
                                            (g3.float() * 0.5).to(q2.dtype),
                                            lse1)
    tol = 2e-2 if dtype == "bfloat16" else 1e-4
    assert _rel_l2(q.grad, gq1) < tol
    assert _rel_l2(k.grad, gk1.float() + gk2.float()) < tol
    assert _rel_l2(v.grad, gv1.float() + gv2.float()) < tol


# ------------------------------------- sampling kernels (card only)
def _words(shape, dev, seed):
    """Random uint32 words in int64, high bits set too."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    return torch.randint(0, 2 ** 32, shape, generator=g,
                         dtype=torch.int64).to(dev)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 3, 4, 151552])
def test_cuda_threefry2x32_vs_plain(cuda, n):
    """The hash kernel's words equal the plain version's bit for bit, at
    R 8 and the main path's counter counts (one fold-in, γ, γ + 1, a
    vocabulary)."""
    from repro_torch.kernels.sample.ops import threefry2x32
    from repro_torch.kernels.sample.ref import threefry2x32_ref
    keys = _words((8, 2), cuda, 1)
    ctr = _words((8, n, 2), cuda, 2)
    n0 = threefry2x32.launches
    got = threefry2x32(keys, ctr)
    torch.cuda.synchronize()
    assert threefry2x32.launches == n0 + 1
    assert torch.equal(got, threefry2x32_ref(keys, ctr))
    assert got.dtype == torch.int64 and int(got.min()) >= 0
    assert int(got.max()) < 2 ** 32


@pytest.mark.gpu
@pytest.mark.parametrize("peaked", [False, True], ids=["random", "peaked"])
@pytest.mark.parametrize("r,v,stride", [(8, 151552, 0), (32, 151552, 0),
                                        (3, 512, 0), (5, 2049, 0),
                                        (4, 4097, 4097), (1, 1, 0)])
def test_cuda_categorical_rows_vs_plain(cuda, r, v, stride, peaked):
    """The fused draw picks the plain version's index, except on rows
    whose top two of logits + gumbel lie within 4·eps32·max|z| (none
    expected); peaked logits put the mass on 8 tokens and the rest at
    -30 (the Leviathan check's shape)."""
    from repro_torch.kernels.sample.ops import categorical_rows
    from repro_torch.kernels.sample.ref import (near_tie_rows,
                                                perturbed_rows_ref)
    keys = _words((r, 2), cuda, 3)
    lg = _randn((r, v), "float32", cuda, 4) * 3
    if peaked:
        lg = torch.full_like(lg, -30.0)
        lg[:, :8] = _randn((r, min(8, v)), "float32", cuda, 5)[:, :v]
    n0 = categorical_rows.launches
    got = categorical_rows(keys, lg, row_stride=stride)
    torch.cuda.synchronize()
    assert categorical_rows.launches == n0 + 1
    z = perturbed_rows_ref(keys, lg, stride)
    want = z.argmax(-1).to(torch.int32)
    bad = (got != want) & ~near_tie_rows(z)
    assert not bad.any(), (got[bad], want[bad])
    assert got.dtype == torch.int32


@pytest.mark.gpu
def test_cuda_sampling_wrappers_refuse(cuda):
    from repro_torch.kernels.sample.ops import categorical_rows, threefry2x32
    keys = _words((2, 2), cuda, 6)
    with pytest.raises(ValueError):
        categorical_rows(keys, torch.zeros((2, 8), dtype=torch.bfloat16,
                                           device=cuda))
    with pytest.raises(ValueError):
        categorical_rows(keys[:1], torch.zeros((2, 8), device=cuda))
    with pytest.raises(ValueError):
        threefry2x32(keys.to(torch.int32), _words((2, 3, 2), cuda, 7))
    with pytest.raises(ValueError):
        threefry2x32(keys, _words((3, 3, 2), cuda, 7))


# --------------- the attention-mixer families' shapes (card): phi3-medium,
# starcoder2-7b, granite-moe, gpt-oss-120b and its draft
# (Hq, Hk, D): groups of 4, 9, 3, 8 and 9; head_dim 64 takes the FMA loop
FAMILY_HEADS = [(40, 10, 128), (36, 4, 128), (24, 8, 64), (64, 8, 64),
                (45, 5, 64)]
FAMILY_PAD = [0, 7, 23, 40]


def _family_pools(hk, d, dev, seed, b=4, smax=128, page=16):
    """Shuffled page pools of ``b`` lanes x ``smax`` rows, their table and
    the dense view."""
    n_tbl = smax // page
    g = torch.Generator(device="cpu").manual_seed(seed)
    tbl = torch.randperm(b * n_tbl, generator=g).to(torch.int32).reshape(
        b, n_tbl).to(dev)
    kp = _randn((b * n_tbl + 1, page, hk, d), "bfloat16", dev, seed + 1)
    vp = _randn((b * n_tbl + 1, page, hk, d), "bfloat16", dev, seed + 2)
    return kp, vp, tbl, gather_view(kp, tbl), gather_view(vp, tbl)


@pytest.mark.gpu
@pytest.mark.parametrize("hq,hk,d", FAMILY_HEADS)
def test_cuda_family_prefill_vs_plain(cuda, hq, hk, d):
    """The prefill at a family's heads (batch 4, width 64, left pads),
    dense and paged, against the plain version; paged equal to dense on
    the gathered view."""
    s = 64
    kp, vp, tbl, kc, vc = _family_pools(hk, d, cuda, 61)
    q = _randn((4, s, hq, d), "bfloat16", cuda, 64)
    pad = torch.tensor(FAMILY_PAD, dtype=torch.int32, device=cuda)
    k, v = kc[:, :s].contiguous(), vc[:, :s].contiguous()
    got = flash_attention(q, k, v, pad)
    paged = flash_attention_paged(q, kp, vp, tbl, pad)
    want = flash_attention_ref(q, k, v, pad)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert torch.equal(paged, got), "paged != dense kernel on the view"
    np.testing.assert_allclose(_f32(got.cpu()), _f32(want.cpu()),
                               **_tol("bfloat16"))
    assert _rel_l2(got, want) < 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("t", [1, 4, 13])
@pytest.mark.parametrize("hq,hk,d", FAMILY_HEADS)
def test_cuda_family_verify_vs_plain(cuda, hq, hk, d, t):
    """The verify at a family's heads: T 1 and 4 (chain) and 13 (tree W 4,
    gamma 3) against a 128-row cache, dense and paged, against the plain
    version; paged equal to dense on the view; the route is the one
    ``verify_route`` names (head_dim 64: the FMA loop)."""
    kp, vp, tbl, kc, vc = _family_pools(hk, d, cuda, 71)
    q = _randn((4, t, hq, d), "bfloat16", cuda, 74)
    ln = torch.tensor([40, 57, 90, 110], dtype=torch.int32, device=cuda)
    pad = torch.tensor(FAMILY_PAD, dtype=torch.int32, device=cuda)
    kw = {"tree": (4, 3)} if t == 13 else {}
    got = verify_attention(q, kc, vc, ln, pad, **kw)
    paged = verify_attention_paged(q, kp, vp, tbl, ln, pad, **kw)
    want = (verify_attention_tree_ref(q, kc, vc, ln, pad, tree=(4, 3))
            if kw else verify_attention_ref(q, kc, vc, ln, pad))
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert torch.equal(paged, got), "paged != dense kernel on the view"
    np.testing.assert_allclose(_f32(got.cpu()), _f32(want.cpu()),
                               **_tol("bfloat16"))
    assert _rel_l2(got, want) < 1e-3
    assert verify_route(torch.bfloat16, d) == (
        "tensor_core_bf16" if d == 128 else "fma")


# the families' (K, N) of the prefill and the draft seed: q, k, o, the
# FFN (dense families), the LM head (granite-moe's N 49 155 is no
# multiple of 8), the router in fp32 (MoE), the draft's fc, q and k
FAMILY_LINEAR = [
    ("bfloat16", 5120, 5120), ("bfloat16", 5120, 1280),
    ("bfloat16", 5120, 17920), ("bfloat16", 17920, 5120),
    ("bfloat16", 5120, 100352), ("bfloat16", 10240, 5120),
    ("bfloat16", 4608, 4608), ("bfloat16", 4608, 512),
    ("bfloat16", 4608, 18432), ("bfloat16", 18432, 4608),
    ("bfloat16", 4608, 49152), ("bfloat16", 9216, 4608),
    ("bfloat16", 1536, 1536), ("bfloat16", 1536, 512),
    ("bfloat16", 1536, 49155), ("float32", 1536, 40),
    ("bfloat16", 3072, 1536),
    ("bfloat16", 2880, 4096), ("bfloat16", 2880, 512),
    ("bfloat16", 4096, 2880), ("bfloat16", 2880, 201088),
    ("float32", 2880, 128), ("bfloat16", 5760, 2880),
    ("bfloat16", 2880, 2880), ("bfloat16", 2880, 320)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,k,n", FAMILY_LINEAR)
def test_cuda_linear_rows_family_shapes(cuda, dtype, k, n):
    """``test_cuda_linear_rows_m_invariant`` at the families' (K, N):
    rows equal across M and shifted by a row, against float64, one-hot
    rows exact; an N off the 16-byte row stride runs on a zero-padded
    copy of w, one launch a call."""
    test_cuda_linear_rows_m_invariant(cuda, dtype, k, n)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "gpt-oss-120b"])
def test_cuda_moe_combine_repeatable(cuda, arch):
    """A MoE layer at the family's widths on the card (random bf16 weights;
    gpt-oss-120b's 128 experts): two calls of ``moe_sort`` on one input
    give the same output and aux bit for bit (the combine adds each
    token's k contributions in a fixed order, no atomics), and it agrees
    with the one-hot oracle per element at the bf16 tolerance."""
    from repro_torch.configs import get
    from repro_torch.models import moe
    from repro_torch.models.param import init_params
    cfg = get(arch)
    g = torch.Generator(device=cuda).manual_seed(3)
    p = init_params(moe.moe_specs(cfg), g, cuda, torch.bfloat16)
    x = torch.randn((4, 64, cfg.d_model), generator=g,
                    device=cuda).to(torch.bfloat16)
    a, aa = moe.moe_sort(cfg, p, x)
    b, ab = moe.moe_sort(cfg, p, x)
    ref, _ = moe.moe_einsum(cfg, p, x)
    torch.cuda.synchronize()
    assert torch.equal(a, b) and torch.equal(aa, ab)
    np.testing.assert_allclose(_f32(a.cpu()), _f32(ref.cpu()),
                               **_tol("bfloat16"))
    assert _rel_l2(a, ref) < 2e-2
