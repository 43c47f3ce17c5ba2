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
from repro_torch.kernels.extract_pack.ops import pack_signals  # noqa: E402
from repro_torch.kernels.extract_pack.ref import extract_pack_ref  # noqa: E402
from repro_torch.kernels.flash_attn.ops import (  # noqa: E402
    flash_attention, flash_attention_paged)
from repro_torch.kernels.flash_attn.ref import (  # noqa: E402
    flash_attention_paged_ref, flash_attention_ref)
from repro_torch.kernels.linear_rows.ops import (  # noqa: E402
    k_splits, linear_rows)
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
                                         (4096, 151552))] == [8, 2, 1, 2, 1]


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


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,t,f,p", PACK_SHAPES + [(8, 4, 12288, 0.6)])
def test_cuda_pack_vs_plain_exact(cuda, b, t, f, p, dtype):
    feats = _randn((b, t, f), dtype, cuda, 12)
    g = torch.Generator(device="cpu").manual_seed(13)
    toks = torch.randint(0, 999, (b, t), generator=g,
                         dtype=torch.int32).to(cuda)
    mask = (torch.rand((b, t), generator=g) < p).to(cuda)
    got = pack_signals(feats, toks, mask)
    want = extract_pack_ref(feats, toks, mask)
    torch.cuda.synchronize()
    for a, w in zip(got, want):
        assert torch.equal(a, w)


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
    ("bfloat16", k, n) for k, n in LINEAR_KN + [(128, 64), (512, 128)]] + [
    ("float32", k, n) for k, n in LINEAR_KN[:2] + [(128, 64), (512, 128)]])
def test_cuda_linear_rows_m_invariant(cuda, dtype, k, n):
    """Row r of ``linear_rows(x, w)`` depends only on row r of x and on
    w, bit for bit: the first M rows at M in {1, 2, 126, 128, 992}, and
    rows shifted by one, equal the rows of the widest call.  Against
    float64 x @ w: relative L2 below 3e-3 in bf16 (one rounding of the
    output, 2^-9) and 1e-5 in fp32."""
    ms = (1, 2, 126, 128, 992)
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
