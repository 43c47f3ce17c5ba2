"""The port's MoE FFN (``repro_torch/models/moe.py``) against the JAX
package's (``repro/models/moe.py``) on the CPU, fp32, with the same
weights bridged in as numpy arrays.

Tolerance: fp32 rtol/atol 2e-5 (tests/test_kernels.py:18).  Routing is
compared exactly: the experts each token picks, and which of its
assignments drop at the capacity (JAX's drops are read from its own
``_route`` and the sort dispatch's rank rule of ``moe_sort``).  Inputs
come from fixed numpy seeds."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import repro.configs as C  # noqa: E402
from repro.checkpoint.ckpt import _flatten  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.param import init_params as jinit  # noqa: E402
from repro_torch.checkpoint import bridge  # noqa: E402
from repro_torch.configs import get, get_reduced  # noqa: E402
from repro_torch.models import moe  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)
MOE_ARCHS = ["granite-moe-3b-a800m", "gpt-oss-120b"]


@pytest.fixture(scope="module", autouse=True)
def _threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _cfgs(arch, **kw):
    """(JAX config, port config): the arch's REDUCED with ``kw``."""
    return (dataclasses.replace(C.get_reduced(arch), **kw),
            dataclasses.replace(get_reduced(arch), **kw))


def _params(jcfg, cfg, seed=0):
    jp = jinit(jax.random.key(seed), jmoe.moe_specs(jcfg))
    tp = bridge.from_numpy(moe.moe_specs(cfg), _flatten(jp), device="cpu",
                           dtype=torch.float32)
    return jp, tp


def _x(b, t, d, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (b, t, d)).astype(np.float32)


def _jax_drops(jcfg, jp, x):
    """JAX's routing of x (B, T, D): (idx (N, k), keep (N*k,) in the flat
    (token, choice) order), from its ``_route`` and ``moe_sort``'s rank
    rule (``src/repro/models/moe.py:85-98``)."""
    n = x.shape[0] * x.shape[1]
    idx, _, _ = jmoe._route(jcfg, jp, jnp.asarray(x).reshape(n, -1))
    cap = jmoe._capacity(jcfg, n)
    flat_e = idx.reshape(-1)
    order = jnp.argsort(flat_e)
    counts = jnp.bincount(flat_e, length=jcfg.num_experts)
    starts = jnp.concatenate([jnp.zeros(1, counts.dtype),
                              jnp.cumsum(counts)[:-1]])
    rank = jnp.arange(flat_e.shape[0]) - starts[flat_e[order]]
    keep = np.empty(flat_e.shape[0], bool)
    keep[np.asarray(order)] = np.asarray(rank < cap)
    return np.asarray(idx), keep


def _port_drops(cfg, tp, x):
    n = x.shape[0] * x.shape[1]
    xf = torch.tensor(x).reshape(n, -1)
    idx, _, _ = moe._route(cfg, tp, xf)
    return idx.numpy(), moe.dispatch(cfg, idx, n)["keep"].numpy()


# ------------------------------------------------------------- capacity
@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("cf", [1.25, 0.5, 1.0, 2.0])
def test_capacity_matches_jax(arch, reduced, cf):
    jcfg = (C.get_reduced if reduced else C.get)(arch)
    cfg = (get_reduced if reduced else get)(arch)
    jcfg = dataclasses.replace(jcfg, capacity_factor=cf)
    cfg = dataclasses.replace(cfg, capacity_factor=cf)
    for n in (1, 3, 8, 16, 32, 52, 60, 104, 256, 1000, 3968):
        assert moe._capacity(cfg, n) == jmoe._capacity(jcfg, n), n


def test_capacity_at_a_granite_chain_verify():
    """B 8 x T 4 tokens over 40 experts, top 8: 8 slots an expert for 256
    assignments (6.4 a expert on average), so uniformly random choices
    already drop some."""
    cfg = get("granite-moe-3b-a800m")
    assert moe._capacity(cfg, 32) == 8
    rng = np.random.default_rng(0)
    idx = torch.tensor(np.stack([rng.permutation(cfg.num_experts)[
        :cfg.experts_per_tok] for _ in range(32)]))
    keep = moe.dispatch(cfg, idx, 32)["keep"]
    assert 0 < int((~keep).sum()) < 256


# ---------------------------------------------------- sort and einsum
@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("cf", [1.25, 0.5])
@pytest.mark.parametrize("impl", ["sort", "einsum"])
def test_moe_matches_jax(arch, cf, impl):
    """Output, aux and the routing (experts and drops) of one call
    against JAX's, at capacity factors that drop some assignments (0.5)
    or few (1.25)."""
    jcfg, cfg = _cfgs(arch, capacity_factor=cf)
    jp, tp = _params(jcfg, cfg)
    x = _x(3, 20, cfg.d_model)
    jfn = jmoe.moe_sort if impl == "sort" else jmoe.moe_einsum
    tfn = moe.moe_sort if impl == "sort" else moe.moe_einsum
    jout, jaux = jfn(jcfg, jp, jnp.asarray(x))
    tout, taux = tfn(cfg, tp, torch.tensor(x))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), **TOL)
    jidx, jkeep = _jax_drops(jcfg, jp, x)
    tidx, tkeep = _port_drops(cfg, tp, x)
    np.testing.assert_array_equal(tidx, jidx)
    np.testing.assert_array_equal(tkeep, jkeep)
    if cf == 0.5:
        assert not tkeep.all(), "no assignment dropped at cf 0.5"


@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_sort_equals_einsum_oracle(cf):
    jcfg, cfg = _cfgs("granite-moe-3b-a800m", capacity_factor=cf)
    _, tp = _params(jcfg, cfg, seed=3)
    x = torch.tensor(_x(2, 33, cfg.d_model, seed=4))
    a, aa = moe.moe_sort(cfg, tp, x)
    b, ab = moe.moe_einsum(cfg, tp, x)
    np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)
    assert float(aa) == float(ab)


def test_shared_experts_match_jax():
    """num_shared_experts > 0 (DeepSeek-V3's shared expert) adds a SwiGLU
    FFN of moe_hidden x the count, as JAX's does."""
    jcfg, cfg = _cfgs("granite-moe-3b-a800m", num_shared_experts=2)
    jp, tp = _params(jcfg, cfg, seed=5)
    assert "shared" in tp
    x = _x(2, 9, cfg.d_model, seed=6)
    for jfn, tfn in ((jmoe.moe_sort, moe.moe_sort),
                     (jmoe.moe_einsum, moe.moe_einsum)):
        jout, _ = jfn(jcfg, jp, jnp.asarray(x))
        tout, _ = tfn(cfg, tp, torch.tensor(x))
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)


def test_moe_impl_dispatch():
    """``impl``: "einsum" takes the oracle; "shard_map" takes sort (the
    port has no mesh, and JAX's takes sort without one); "sort" too."""
    jcfg, cfg = _cfgs("gpt-oss-120b", capacity_factor=0.5)
    jp, tp = _params(jcfg, cfg, seed=8)
    x = _x(2, 11, cfg.d_model, seed=9)
    t = torch.tensor(x)
    sort, _ = moe.moe_sort(cfg, tp, t)
    assert torch.equal(moe.moe(cfg, tp, t, "shard_map")[0], sort)
    assert torch.equal(moe.moe(cfg, tp, t)[0], sort)
    assert torch.equal(moe.moe(cfg, tp, t, "einsum")[0],
                       moe.moe_einsum(cfg, tp, t)[0])
    jout, _ = jmoe.moe(jcfg, jp, jnp.asarray(x), "shard_map")
    np.testing.assert_allclose(sort.numpy(), np.asarray(jout), **TOL)


# ------------------------------------------------ ties and a crowded expert
def _tied(jcfg, cfg, jp):
    """Router weights whose columns 1 and 2 are equal (every token's
    logits tie there) and whose column 0 is large (expert 0 is every
    token's first choice, so it overflows)."""
    r = np.array(jp["router"])
    r[:, 2] = r[:, 1]
    r[:, 0] = 3.0 * np.abs(r).max()
    jp = dict(jp, router=jnp.asarray(r))
    tp = bridge.from_numpy(moe.moe_specs(cfg), _flatten(jp), device="cpu",
                           dtype=torch.float32)
    return jp, tp


@pytest.mark.parametrize("impl", ["sort", "einsum"])
def test_router_ties_and_crowded_expert(impl):
    """Exact ties go to the lower expert index (``jax.lax.top_k``), and an
    expert's slots go to its assignments in token order (a stable sort):
    with every token on expert 0 and tied on experts 1 and 2, the first
    ``capacity`` tokens keep expert 0, the rest drop it, and the second
    choice is expert 1 -- in both packages."""
    jcfg, cfg = _cfgs("granite-moe-3b-a800m", capacity_factor=1.0)
    jp, tp = _params(jcfg, cfg, seed=11)
    jp, tp = _tied(jcfg, cfg, jp)
    x = np.abs(_x(2, 24, cfg.d_model, seed=12))
    n, k = 48, cfg.experts_per_tok
    xf = torch.tensor(x).reshape(n, -1)
    logits = moe.router_logits(tp, xf)
    assert torch.equal(logits[:, 1], logits[:, 2])
    jidx, jkeep = _jax_drops(jcfg, jp, x)
    tidx, tkeep = _port_drops(cfg, tp, x)
    np.testing.assert_array_equal(tidx, jidx)
    np.testing.assert_array_equal(tkeep, jkeep)
    assert (tidx[:, 0] == 0).all() and (tidx[:, 1] == 1).all()
    cap = moe._capacity(cfg, n)
    assert cap < n
    first = tkeep.reshape(n, k)[:, 0]
    assert first[:cap].all() and not first[cap:].any()
    jfn = jmoe.moe_sort if impl == "sort" else jmoe.moe_einsum
    tfn = moe.moe_sort if impl == "sort" else moe.moe_einsum
    jout, _ = jfn(jcfg, jp, jnp.asarray(x))
    tout, _ = tfn(cfg, tp, torch.tensor(x))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)


def test_dropped_slot_is_never_read():
    """A dropped assignment contributes nothing: setting every token's
    first choice to overflow leaves only the kept contributions, and the
    out-of-range slot ``E * cap`` of ``dispatch`` reads the zero row."""
    jcfg, cfg = _cfgs("granite-moe-3b-a800m", capacity_factor=1.0)
    jp, tp = _params(jcfg, cfg, seed=11)
    _, tp = _tied(jcfg, cfg, jp)
    x = torch.tensor(np.abs(_x(2, 24, cfg.d_model, seed=12)))
    n = 48
    idx, gate, _ = moe._route(cfg, tp, x.reshape(n, -1))
    dsp = moe.dispatch(cfg, idx, n)
    cap, e = dsp["cap"], cfg.num_experts
    assert (dsp["slot"][~dsp["keep"]] == e * cap).all()
    assert (dsp["slot"][dsp["keep"]] < e * cap).all()
    assert len(set(dsp["slot"][dsp["keep"]].tolist())) == \
        int(dsp["keep"].sum())
    out, _ = moe.moe_sort(cfg, tp, x)
    # the same output from the kept assignments alone, one token at a time
    want = torch.zeros((n, cfg.d_model))
    xf = x.reshape(n, -1)
    keep = dsp["keep"].reshape(n, -1)
    for t_ in range(n):
        for j in range(cfg.experts_per_tok):
            if not keep[t_, j]:
                continue
            ex = int(idx[t_, j])
            xs = xf[t_][None, None]
            y = moe._experts_ffn(
                {k_: tp[k_][ex:ex + 1] for k_ in ("w_gate", "w_up",
                                                   "w_down")}, xs,
                torch.float32)[0, 0]
            want[t_] += y * gate[t_, j]
    np.testing.assert_allclose(out.reshape(n, -1).numpy(), want.numpy(),
                               **TOL)


# ----------------------------------------------------------- determinism
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_combine_is_bitwise_repeatable(dtype):
    """The same call twice gives the same output bit for bit (the combine
    adds each token's contributions in a fixed order, no atomics)."""
    jcfg, cfg = _cfgs("granite-moe-3b-a800m", capacity_factor=0.5)
    _, tp = _params(jcfg, cfg, seed=13)
    tp = tp.to(dtype)
    x = torch.tensor(_x(4, 16, cfg.d_model, seed=14)).to(dtype)
    a, aa = moe.moe_sort(cfg, tp, x)
    b, ab = moe.moe_sort(cfg, tp, x)
    assert torch.equal(a, b) and torch.equal(aa, ab)


def test_moe_backward_matches_jax():
    """Gradients of a scalar of the sort path (output and aux) with
    respect to x and the router against JAX's."""
    jcfg, cfg = _cfgs("granite-moe-3b-a800m", capacity_factor=0.5)
    jp, tp = _params(jcfg, cfg, seed=15)
    x = _x(2, 10, cfg.d_model, seed=16)
    proj = np.random.default_rng(17).standard_normal(
        (cfg.d_model,)).astype(np.float32)

    def jloss(p, xx):
        out, aux = jmoe.moe_sort(jcfg, p, xx)
        return (out @ jnp.asarray(proj)).sum() + aux

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    leaves = {k_: v.detach().clone().requires_grad_(True)
              for k_, v in bridge.flat(tp).items()}
    xt = torch.tensor(x, requires_grad=True)
    out, aux = moe.moe_sort(cfg, leaves, xt)
    loss = (out @ torch.tensor(proj)).sum() + aux
    loss.backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), **TOL)
    for name in ("router", "w_gate", "w_up", "w_down"):
        np.testing.assert_allclose(leaves[name].grad.numpy(),
                                   np.asarray(jgp[name]), **TOL)
