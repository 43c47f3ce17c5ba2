"""The port's three kernels: each plain version against the JAX Pallas
kernel (interpret mode on the CPU) and against the JAX model's masked
attention, the CPU dispatch of each wrapper, and -- on a CUDA card only
-- each CUDA kernel against its plain version.

Tolerances as in tests/test_kernels.py: fp32 rtol/atol 2e-5, bf16 2e-2;
extract_pack is a copy and is held exactly.  The JAX half imports JAX
inside a fixture, so the card's machine (no JAX) runs the card half."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.extract_pack.ops import pack_signals  # noqa: E402
from repro_torch.kernels.extract_pack.ref import extract_pack_ref  # noqa: E402
from repro_torch.kernels.flash_attn.ops import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attn.ref import flash_attention_ref  # noqa: E402
from repro_torch.kernels.verify_attn.ops import verify_attention  # noqa: E402
from repro_torch.kernels.verify_attn.ref import verify_attention_ref  # noqa: E402

DTYPES = ["float32", "bfloat16"]
FLASH_SHAPES = [(1, 128, 2, 1, 64, True, 0), (2, 256, 4, 2, 64, True, 0),
                (1, 128, 4, 4, 128, False, 0), (1, 256, 2, 2, 64, True, 96),
                (2, 128, 8, 2, 32, True, 0)]
VERIFY_SHAPES = [(2, 4, 4, 2, 64, 512, 0), (1, 4, 8, 8, 128, 256, 0),
                 (3, 1, 2, 1, 64, 512, 0), (2, 8, 4, 2, 32, 1024, 0),
                 (2, 4, 4, 2, 64, 1024, 256)]
PACK_SHAPES = [(2, 4, 512, 0.5), (3, 8, 1024, 0.25), (1, 4, 1536, 1.0),
               (2, 4, 512, 0.0)]


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else \
        dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.extract_pack.kernel import extract_pack
    from repro.kernels.flash_attn.kernel import flash_attention as jflash
    from repro.kernels.verify_attn.kernel import verify_attention as jverify
    from repro.models import attention as jattn
    return dict(jnp=jnp, extract_pack=extract_pack, flash=jflash,
                verify=jverify, attn=jattn)


def _both(x, dtype, jnp):
    """The same numpy array as a JAX and a torch CPU array of ``dtype``
    (both round fp32 -> bf16 to nearest even)."""
    return (jnp.asarray(x, getattr(jnp, dtype)),
            torch.tensor(np.asarray(x, np.float32)).to(getattr(torch, dtype)))


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


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
    np.testing.assert_allclose(_f32(got), _f32(want), **_tol(dtype))


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
