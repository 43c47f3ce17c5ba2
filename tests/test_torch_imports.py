"""The PyTorch port stands alone: no module of ``src/repro_torch`` and not
``chip_smoke.py`` imports JAX or the JAX package, and the serving
engine refuses to fall back to the CPU on its own.  Configurations once
refused serve: sampled decoding (``greedy=False``, ``seed``), chunked
refill prefill and the overload response (``preempt``, ``shed``,
``shed_queue_depth``)."""
import ast
import pathlib

import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_imports_no_jax(path):
    bad = sorted({r for r in _imported_roots(path) if r in FORBIDDEN})
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_file_list_is_complete():
    """The scan covers the package and the smoke script."""
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    for want in ("chip_smoke.py", "src/repro_torch/serving/engine.py",
                 "src/repro_torch/kernels/verify_attn/ops.py",
                 "src/repro_torch/core/paging.py",
                 "src/repro_torch/core/tide.py",
                 "src/repro_torch/core/transport.py",
                 "src/repro_torch/training/service.py",
                 "src/repro_torch/checkpoint/ckpt.py",
                 "src/repro_torch/data/workloads.py",
                 "src/repro_torch/launch/serve.py",
                 "src/repro_torch/launch/train.py",
                 "src/repro_torch/training/trainer.py",
                 "src/repro_torch/core/prng.py",
                 "src/repro_torch/kernels/sample/ops.py",
                 "src/repro_torch/kernels/sample/ref.py",
                 "src/repro_torch/fleet/wire.py",
                 "src/repro_torch/fleet/remote.py",
                 "src/repro_torch/fleet/trainer_main.py",
                 "src/repro_torch/fleet/router.py",
                 "src/repro_torch/fleet/bus.py",
                 "src/repro_torch/models/moe.py",
                 "src/repro_torch/configs/phi3_medium_14b.py",
                 "src/repro_torch/configs/starcoder2_7b.py",
                 "src/repro_torch/configs/starcoder2_15b.py",
                 "src/repro_torch/configs/granite_moe_3b_a800m.py",
                 "src/repro_torch/configs/gpt_oss_120b.py",
                 "src/repro_torch/configs/deepseek_v3_671b.py",
                 "src/repro_torch/models/mla.py",
                 "src/repro_torch/kernels/mla_attn/ops.py",
                 "src/repro_torch/kernels/mla_attn/ref.py"):
        assert want in names


def test_engine_without_device_needs_cuda(monkeypatch):
    from repro_torch.configs import get
    from repro_torch.core import eagle
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import ServingEngine
    cfg = get("tide-tiny")
    dcfg = eagle.draft_config(cfg)
    params = T.init(cfg, 0, device="cpu")
    dparams = eagle.draft_init(dcfg, 1, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(cfg, params, dcfg, dparams)
    eng = ServingEngine(cfg, params, dcfg, dparams, device="cpu")
    assert eng.device.type == "cpu"


@pytest.mark.parametrize("kw,item", [
    (dict(greedy=False), "sampled decoding"),
    (dict(page_size=8, prefill_chunk=16), "chunked refill prefill"),
    (dict(prefill_chunk=16), "chunked refill prefill"),
    # trees over paged KV are served; with chunked refill they are not
    (dict(tree_width=2, page_size=8, prefill_chunk=16),
     "chunked refill prefill"),
])
def test_engine_unported_paths_raise(kw, item):
    """Paths once refused here are served: sampled decoding (ROADMAP
    queue 1 item 4) and chunked refill prefill (item 5: dense, paged,
    and a paged tree), each a short wave to its budgets, the chunked
    ones through their chunk pipelines."""
    from repro_torch.configs import get
    from repro_torch.core import eagle
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.policy import ServingConfig
    cfg = get("tide-tiny")
    dcfg = eagle.draft_config(cfg)
    params = T.init(cfg, 0, device="cpu")
    dparams = eagle.draft_init(dcfg, 1, device="cpu")
    eng = ServingEngine(cfg, params, dcfg, dparams, device="cpu",
                        config=ServingConfig(**kw))
    _serves(eng, kw)
    if item == "chunked refill prefill":
        assert eng.prefill_chunk == 16 and eng.stats.prefill_chunks > 0
        assert eng.stats.prefill_op_width.max <= 16
        if eng.paged:
            eng.release_prefix_cache()
            eng.allocator.assert_clean()


@pytest.mark.parametrize("cls,kw", [
    ("ServingConfig", dict(preempt="deadline")),
    ("ServingConfig", dict(shed="expired")),
    ("ServingConfig", dict(shed_queue_depth=9)),
    ("ServingConfig", dict(seed=5)),
    ("ServingPolicy", dict(preemption="deadline")),
])
def test_overload_and_paging_knobs_are_not_accepted(cls, kw):
    """Knobs once refused here are served.  Preemption and shedding
    (ROADMAP queue 1 item 6): each ``ServingConfig`` knob reaches the
    engine's policy (``preempt`` its ``PreemptionPolicy``, ``shed`` and
    ``shed_queue_depth`` the composed ``ShedPolicy``), and the engine
    serves; ``ServingPolicy(preemption=...)`` builds, and an engine runs
    under it.  ``seed`` (item 4) reaches the engine's base key."""
    from repro_torch.configs import get
    from repro_torch.core import eagle
    from repro_torch.models import transformer as T
    from repro_torch.serving import policy
    from repro_torch.serving.engine import ServingEngine
    cfg = get("tide-tiny")
    dcfg = eagle.draft_config(cfg)
    params = T.init(cfg, 0, device="cpu")
    dparams = eagle.draft_init(dcfg, 1, device="cpu")
    if cls == "ServingPolicy":
        pol = policy.ServingPolicy(preemption=policy.DeadlinePreemption(
            shed=policy.ExpiredShed()))
        assert pol.preemption.enabled and pol.preemption.shed.name == \
            "expired"
        eng = ServingEngine(cfg, params, dcfg, dparams, device="cpu",
                            policy=pol)
        assert eng.policy.preemption is pol.preemption
        _serves(eng, {})
        return
    config = policy.ServingConfig(**kw)
    eng = ServingEngine(cfg, params, dcfg, dparams, device="cpu",
                        config=config)
    pre = eng.policy.preemption
    assert pre.name == config.preempt and pre.shed.name == config.shed
    assert getattr(pre.shed, "depth", config.shed_queue_depth) == \
        config.shed_queue_depth
    _serves(eng, kw)
    assert eng.stats.preemptions == eng.stats.shed_requests == 0


def _serves(eng, kw):
    """The engine took the configuration's greedy/seed (its base key is
    ``key(seed)``) and serves two requests to their budgets."""
    from repro_torch.core import prng
    from repro_torch.serving.request import Request
    assert eng.greedy == kw.get("greedy", True)
    assert eng.config.seed == kw.get("seed", 0)
    assert torch.equal(eng._base_key, prng.key(kw.get("seed", 0)))
    reqs = [Request(prompt=[3, 1, 4, 1, 5], max_new_tokens=6),
            Request(prompt=[2, 7, 1], max_new_tokens=4)]
    eng.serve_stream(iter(reqs))
    assert [len(r.generated) for r in reqs] == [6, 4]
