"""JAX parameters -> port -> numpy round trip, exact, for the target and
the EAGLE-3 draft."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import repro.configs as C  # noqa: E402
from repro.checkpoint.ckpt import _flatten  # noqa: E402
from repro.core import eagle as jeagle  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.checkpoint import bridge  # noqa: E402
from repro_torch.configs import get  # noqa: E402
from repro_torch.core import eagle  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.param import count_params  # noqa: E402


def _jax_flat(which):
    cfg = C.get("tide-tiny")
    if which == "target":
        return _flatten(JT.init(cfg, jax.random.key(0)))
    return _flatten(jeagle.draft_init(jeagle.draft_config(cfg),
                                      jax.random.key(7)))


@pytest.mark.parametrize("which", ["target", "draft"])
def test_round_trip_exact(which):
    flat = _jax_flat(which)
    cfg = get("tide-tiny")
    if which == "target":
        params = bridge.target_from_numpy(cfg, flat, device="cpu")
    else:
        params = bridge.draft_from_numpy(eagle.draft_config(cfg), flat,
                                         device="cpu")
    back = bridge.tree_to_numpy(params)
    assert sorted(back) == sorted(flat)
    for k in flat:
        assert back[k].shape == flat[k].shape
        np.testing.assert_array_equal(back[k], flat[k])


def test_specs_match_reference():
    """Same '/'-keys and shapes as the JAX param specs, and the same
    parameter counts (glm4-9b full size included)."""
    def jax_shapes(specs):
        leaves = jax.tree_util.tree_flatten_with_path(specs)[0]
        return {"/".join(p.key for p in path): tuple(s.shape)
                for path, s in leaves}

    def port_shapes(specs, prefix=""):
        if hasattr(specs, "shape"):
            return {prefix: tuple(specs.shape)}
        out = {}
        for k, v in specs.items():
            out.update(port_shapes(v, f"{prefix}/{k}" if prefix else k))
        return out

    for name in ("tide-tiny", "glm4-9b"):
        jcfg, cfg = C.get(name), get(name)
        assert port_shapes(T.param_specs(cfg)) == jax_shapes(
            JT.param_specs(jcfg))
        assert cfg.param_count() == jcfg.param_count()
        jd, td = jeagle.draft_config(jcfg), eagle.draft_config(cfg)
        assert eagle.draft_param_count(td) == jeagle.draft_param_count(jd)
        assert (td.num_heads, td.num_kv_heads, td.head_dim, td.d_ff) == (
            jd.num_heads, jd.num_kv_heads, jd.head_dim, jd.d_ff)


def test_shape_mismatch_raises():
    flat = _jax_flat("target")
    key = next(k for k in flat if k.endswith("wq"))
    flat[key] = flat[key][..., :-1]
    with pytest.raises(ValueError, match="shape"):
        bridge.target_from_numpy(get("tide-tiny"), flat, device="cpu")


def test_random_init_shapes_and_scale():
    cfg = get("tide-tiny")
    params = T.init(cfg, 3, device="cpu")
    again = T.init(cfg, 3, device="cpu")
    flat, flat2 = params.flat(), again.flat()
    assert count_params(T.param_specs(cfg)) == sum(
        v.numel() for v in flat.values())
    for k in flat:
        assert torch.equal(flat[k], flat2[k]), "init is not seeded"
    # fan-in is every axis but the last and the layer stack: d_model * Hq
    wq = flat["body/pos0/mix/wq"]
    want = 0.8796 / np.sqrt(cfg.d_model * cfg.num_heads)
    assert abs(float(wq.std()) / want - 1.0) < 0.05
    assert float(flat["embed/tok"].std()) == pytest.approx(0.02, rel=0.05)
