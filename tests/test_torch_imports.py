"""The PyTorch port stands alone: no module of ``src/repro_torch`` and not
``chip_smoke.py`` imports JAX or the JAX package, and the serving
engine refuses to fall back to the CPU on its own."""
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
                 "src/repro_torch/core/paging.py"):
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
    (dict(reseed_window=4), "overload and reseed"),
    (dict(page_size=8, prefill_chunk=16), "chunked refill prefill"),
    (dict(prefill_chunk=16), "chunked refill prefill"),
    # trees over paged KV are served; with chunked refill they are not
    (dict(tree_width=2, page_size=8, prefill_chunk=16),
     "chunked refill prefill"),
])
def test_engine_unported_paths_raise(kw, item):
    from repro_torch.configs import get
    from repro_torch.core import eagle
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.policy import ServingConfig
    cfg = get("tide-tiny")
    dcfg = eagle.draft_config(cfg)
    params = T.init(cfg, 0, device="cpu")
    dparams = eagle.draft_init(dcfg, 1, device="cpu")
    with pytest.raises(NotImplementedError, match=item):
        ServingEngine(cfg, params, dcfg, dparams, device="cpu",
                      config=ServingConfig(**kw))


@pytest.mark.parametrize("cls,kw", [
    ("ServingConfig", dict(preempt="deadline")),
    ("ServingConfig", dict(shed="expired")),
    ("ServingConfig", dict(shed_queue_depth=64)),
    ("ServingConfig", dict(seed=5)),
    ("ServingPolicy", dict(preemption=object())),
])
def test_overload_and_paging_knobs_are_not_accepted(cls, kw):
    """Preemption, shedding and sampling seeds have no path in the port
    yet, so their knobs do not exist (rather than being ignored)."""
    from repro_torch.serving import policy
    with pytest.raises(TypeError):
        getattr(policy, cls)(**kw)
