"""The port's entry points against the JAX package's on the CPU (tide_tiny,
fp32, fixed seeds; JAX is the oracle).

* ``launch/serve.py``: ``build_parser`` has JAX's options, defaults,
  types and choices; ``config_from_args`` builds JAX's ``ServingConfig``
  field for field (``dataclasses.asdict``, ``completion_sink`` aside) for
  every row of tests/test_config_mirror.py's flag table, and
  ``fleet_config_from_args`` JAX's ``FleetConfig``; ``--dryrun`` raises
  ``NotImplementedError`` naming its ROADMAP queue 1 item before any
  work, and the flags once refused (items 4-7: ``--sample``,
  ``--seed``, the chunk, overload and fleet flags) serve with their
  values in the engine, the fleet or the remote trainer; ``main(..., device="cpu")``
  serves 8 requests to their budgets and prints JAX's report; with a
  fixed ``LatencyProfile`` in place of the measured one (JAX's
  ``analytic_tpu_profile`` replaced by the same numbers), the port's
  pieces (``serve_corpus``, ``serve``) on JAX's pretrained target and
  initial draft give JAX's ``main``'s streams, greedy or sampled, its
  ``spec_steps``, cycles, deploys, parks and resumes exactly, and the
  same summary keys; ``measure_profile`` times finite, positive T(n)
  and D0 on the CPU.
* ``launch/train.py``: ``build_parser`` as above; ``main(...,
  device="cpu")`` on JAX's initial weights prints JAX's losses,
  accuracies and gradient norms (to JAX's printed digits).
* Without ``device`` both mains need a CUDA card."""
import dataclasses
import re
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import repro.configs as C  # noqa: E402
from repro.checkpoint.ckpt import _flatten  # noqa: E402
from repro.core import adaptive as jadaptive  # noqa: E402
from repro.core import tide as jtide  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.checkpoint import bridge  # noqa: E402
from repro_torch.configs import get, get_reduced  # noqa: E402
from repro_torch.core import eagle  # noqa: E402
from repro_torch.core.adaptive import LatencyProfile  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

# tests/test_config_mirror.py's flag table, one argv per ServingConfig
# field, and the bare argv
FLAG_ROWS = [
    [], ["--gamma", "5"], ["--batch", "7"], ["--max-len", "320"],
    ["--sample"], ["--superstep-rounds", "3"], ["--eos-id", "9"],
    ["--accept-ema", "0.5"], ["--seed", "13"], ["--policy", "deadline"],
    ["--commit", "eager"], ["--admission-lookahead", "17"],
    ["--gate-arrivals"], ["--idle-wait-s", "0.25"],
    ["--prefill-chunk", "16"], ["--page-size", "8"], ["--num-pages", "40"],
    ["--no-share-prefix"], ["--spec-park", "6"],
    ["--spec-probe-interval", "4"], ["--tree-width", "2"],
    ["--reseed-window", "8"], ["--trainer-threads", "2"],
    ["--preempt", "deadline"], ["--shed", "expired"],
    ["--shed-queue-depth", "9"], ["--async-train"], ["--continuous"]]

SERVE_ARGV = ["--arch", "tide-tiny", "--requests", "8",
              "--pretrain-steps", "10"]


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads, as the other port test files take: the suite
    runs in several worker processes, and torch's default of one thread
    a core makes its small ops wait on each other's spinning threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _actions(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.type,
                     None if a.choices is None else tuple(a.choices),
                     a.nargs, a.const, type(a).__name__)
            for a in parser._actions if a.dest != "help"}


def _jax_parser(module):
    """JAX's launcher parser: ``build_parser`` where the module has one,
    else the parser its ``main`` builds (captured at ``parse_args``)."""
    if hasattr(module, "build_parser"):
        return module.build_parser()
    import argparse
    seen = []

    class Stop(Exception):
        pass

    def grab(self, *a, **kw):
        seen.append(self)
        raise Stop
    old = argparse.ArgumentParser.parse_args
    argparse.ArgumentParser.parse_args = grab
    try:
        module.main()
    except Stop:
        pass
    finally:
        argparse.ArgumentParser.parse_args = old
    return seen[0]


@pytest.mark.parametrize("name", ["serve", "train"])
def test_parser_matches_jax(name):
    port = {"serve": serve, "train": train}[name]
    want = _actions(_jax_parser({"serve": jserve, "train": jtrain}[name]))
    assert _actions(port.build_parser()) == want


@pytest.mark.parametrize("argv", FLAG_ROWS, ids=lambda a: " ".join(a) or
                         "defaults")
def test_config_from_args_matches_jax(argv):
    got = dataclasses.asdict(serve.config_from_args(
        serve.build_parser().parse_args(argv)))
    want = dataclasses.asdict(jserve.config_from_args(
        jserve.build_parser().parse_args(argv)))
    got.pop("completion_sink")
    want.pop("completion_sink")
    assert got == want


@pytest.mark.parametrize("argv,item", [
    (["--dryrun"], "item 9"),
    (["--fleet-replicas", "2"], "item 7"),
    (["--trainer-endpoint", "spawn"], "item 7"),
    (["--sample"], "item 4"), (["--seed", "3"], "item 4"),
    (["--prefill-chunk", "16"], "item 5"), (["--commit", "eager"], "item 5"),
    (["--preempt", "deadline"], "item 6"), (["--shed", "expired"], "item 6"),
    (["--shed", "queue", "--shed-queue-depth", "9"], "item 6"),
], ids=lambda x: x if isinstance(x, str) else " ".join(x))
def test_serve_refusals_name_their_item(argv, item, monkeypatch):
    """Refused before any weight is made (``T.init`` would raise).  The
    flags of items 4-7, refused until sampling, chunked refill prefill,
    the overload response and the fleet were ported, serve: the engine
    takes ``--sample`` as ``greedy=False``, ``--seed`` as its seed,
    ``--prefill-chunk`` as its chunk width, ``--commit eager`` as its
    commit policy, ``--preempt`` as its preemption policy and ``--shed``
    and ``--shed-queue-depth`` as the shed policy it composes;
    ``--fleet-replicas 2`` serves through a ``ServingFleet`` of two
    replicas over one params object, ``--trainer-endpoint spawn``
    through a ``TideSystem`` whose trainer runs in a process of its
    own."""
    if item == "item 7":
        _serve_fleet_flags(argv)
        return
    if item in ("item 4", "item 5", "item 6"):
        args = serve.build_parser().parse_args(SERVE_ARGV + argv)
        sys_, done = serve.main(SERVE_ARGV + argv, device="cpu")
        eng = sys_.engine
        assert eng.greedy is not args.sample
        assert eng.config.seed == args.seed
        assert eng.prefill_chunk == args.prefill_chunk
        assert eng.policy.commit.name == args.commit
        assert (eng.stats.prefill_chunks > 0) == (args.prefill_chunk > 0)
        pre = eng.policy.preemption
        assert pre.name == args.preempt and pre.shed.name == args.shed
        assert getattr(pre.shed, "depth", args.shed_queue_depth) == \
            args.shed_queue_depth
        assert len(done) == 8 and all(len(r.generated) == 32 for r in done)
        return

    def no_init(*a, **kw):
        raise AssertionError("refusal came after the weights were made")
    monkeypatch.setattr(T, "init", no_init)
    with pytest.raises(NotImplementedError, match=item):
        serve.main(SERVE_ARGV + argv, device="cpu")


def _serve_fleet_flags(argv):
    from repro_torch.fleet import FleetConfig
    from repro_torch.fleet.remote import RemoteTrainingService
    from repro_torch.fleet.router import ServingFleet
    args = serve.build_parser().parse_args(SERVE_ARGV + argv)
    system, done = serve.main(SERVE_ARGV + argv, device="cpu")
    want = FleetConfig(replicas=args.fleet_replicas,
                       trainer_endpoint=args.trainer_endpoint,
                       route=args.fleet_route)
    assert system.tcfg.fleet == want
    assert len(done) == 8
    assert all(len(r.generated) == r.max_new_tokens for r in done)
    if args.fleet_replicas:
        assert isinstance(system, ServingFleet) and system.n == 2
        assert all(e.params is system.engines[0].params
                   for e in system.engines)
        s = system.summary()
        assert all(n > 0 for n in s["router_assigned"])
        assert s["tokens"] == sum(len(r.generated) for r in done)
        return
    svc = system.service
    assert isinstance(svc, RemoteTrainingService)
    assert svc.endpoint == "spawn" and system.trainer is None
    assert svc._proc.poll() is not None           # reaped by close()
    assert system.summary()["trainer_failures"] == 0


@pytest.mark.parametrize("argv", [
    [], ["--fleet-replicas", "2"], ["--trainer-endpoint", "spawn"],
    ["--fleet-replicas", "3", "--fleet-route", "rr", "--trainer-endpoint",
     "unix:/tmp/trainer.sock"]],
    ids=lambda a: " ".join(a) or "defaults")
def test_fleet_config_from_args_matches_jax(argv):
    got = serve.fleet_config_from_args(serve.build_parser().parse_args(argv))
    want = jserve.fleet_config_from_args(
        jserve.build_parser().parse_args(argv))
    if want is None:
        assert got is None
        return
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_train_dryrun_is_refused():
    with pytest.raises(NotImplementedError, match="item 9"):
        train.main(["--dryrun"], device="cpu")


def test_mains_need_a_card_without_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(SERVE_ARGV)


# ================================================================ train
_STEP = re.compile(r"step +(\d+) +loss ([\d.]+) +acc ([\d.]+) +gnorm "
                   r"([\d.]+)")


def _printed_steps(text):
    return [tuple(float(x) for x in m.groups())
            for m in _STEP.finditer(text)]


def test_train_main_matches_jax(monkeypatch, capsys):
    """The port's ``main`` on JAX's initial weights (``T.init`` replaced
    by the bridged JAX init of the same config) prints JAX's lines: each
    number within the last digit JAX prints (loss 4 places, accuracy 3,
    gradient norm 2)."""
    argv = ["--steps", "3", "--batch", "4", "--seq", "16"]
    monkeypatch.setattr(sys, "argv", ["train"] + argv)
    jtrain.main()
    want = _printed_steps(capsys.readouterr().out)
    cfg = get_reduced("tide-tiny")
    jp = JT.init(C.get_reduced("tide-tiny"), jax.random.key(0))

    def jax_init(c, seed, *, device):
        assert c == cfg and seed == 0
        return bridge.target_from_numpy(
            c, {k: np.asarray(v) for k, v in _flatten(jp).items()},
            device=device)
    monkeypatch.setattr(T, "init", jax_init)
    log = train.main(argv, device="cpu")
    got = _printed_steps(capsys.readouterr().out)
    assert len(got) == len(want) == 3 and len(log) == 3
    for g, w, e in zip(got, want, log):
        assert g[0] == w[0] == e["it"]
        assert abs(e["loss"] - w[1]) <= 6e-5 + 2e-5 * w[1]
        assert abs(e["accuracy"] - w[2]) <= 6e-4
        assert abs(e["grad_norm"] - w[3]) <= 6e-3
    assert log[-1]["loss"] < log[0]["loss"]


# ================================================================ serve
def test_serve_main_on_cpu(capsys):
    sys_, done = serve.main(SERVE_ARGV + ["--spec-park", "2"], device="cpu")
    out = capsys.readouterr().out
    assert len(done) == 8
    assert all(r.finish_t is not None and len(r.generated) == 32
               for r in done)
    assert "startup profile (measured)" in out
    summary = out.split("== TIDE summary")[1]
    for key in sys_.summary():
        assert f"  {key}: " in summary, key
    assert "accept_len trend:" in summary
    assert sys_.summary()["trainer_failures"] == 0


def test_measure_profile_on_cpu():
    cfg = get("tide-tiny")
    dcfg = eagle.draft_config(cfg)
    params = T.init(cfg, 0, device="cpu")
    dparams = eagle.draft_init(dcfg, 7, device="cpu")
    sizes = serve.profile_batch_sizes(4, 3)
    assert sizes == [1, 2, 4, 8, 16]
    assert serve.profile_batch_sizes(3, 3) == [1, 2, 4, 8, 16]
    assert serve.profile_batch_sizes(1, 0) == [1]
    prof = serve.measure_profile(cfg, params, dcfg, dparams, sizes, "cpu",
                                 max_len=96, draft_batch=4)
    assert prof.batch_sizes == sizes
    vals = list(prof.t_ms) + [prof.d0_ms, prof.c(4), prof.beta(4, 3)]
    assert all(np.isfinite(v) and v > 0 for v in vals), vals


# the fixed profiles: T flat at 2 ms; D0 0 (break-even accepted length
# 1.0: every round speculates, so the draft trains and deploys) or 0.2 ms
# (break-even 1.3: the gate starts off, parks, and probes)
PROFILES = {"always_on": ([1, 2, 4, 8, 16], [2.0] * 5, 0.0),
            "gated": ([1, 2, 4, 8, 16], [2.0] * 5, 0.2)}


@pytest.mark.parametrize("which", sorted(PROFILES))
def test_serve_pieces_match_jax_main(which, monkeypatch, capsys):
    _serve_pieces_match_jax_main(which, [], monkeypatch, capsys)


def test_sampled_serve_pieces_match_jax_main(monkeypatch, capsys):
    """``--sample --seed 3``: the port's sampled streams are JAX's main's
    token for token (every draft drawn, every acceptance and residual
    draw with JAX's threefry keys), through its training cycles."""
    sys_ = _serve_pieces_match_jax_main(
        "always_on", ["--sample", "--seed", "3"], monkeypatch, capsys)
    assert sys_.engine.greedy is False and sys_.engine.config.seed == 3


def _serve_pieces_match_jax_main(which, extra, monkeypatch, capsys):
    sizes, t_ms, d0 = PROFILES[which]
    argv = SERVE_ARGV + ["--spec-park", "2", "--spec-probe-interval",
                         "2"] + extra
    seen = {}

    class Captured(jtide.TideSystem):
        def __init__(self, cfg, params, tc, profile=None, dparams=None):
            super().__init__(cfg, params, tc, profile=profile,
                             dparams=dparams)
            seen.update(params=params, system=self)

        def run(self, *a, **kw):
            seen["done"] = super().run(*a, **kw)
            return seen["done"]

    monkeypatch.setattr(jadaptive, "analytic_tpu_profile",
                        lambda cfg, chips=1: jadaptive.LatencyProfile(
                            list(sizes), list(t_ms), d0))
    monkeypatch.setattr(jtide, "TideSystem", Captured)
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    jserve.main()
    jax_out = capsys.readouterr().out
    jsys = seen["system"]

    cfg = get("tide-tiny")
    dcfg = eagle.draft_config(cfg)
    args = serve.build_parser().parse_args(argv)
    params = bridge.target_from_numpy(
        cfg, {k: np.asarray(v) for k, v in _flatten(seen["params"]).items()},
        device="cpu")
    dparams = bridge.draft_from_numpy(
        dcfg, {k: np.asarray(v) for k, v in _flatten(jsys._dparams0).items()},
        device="cpu")
    domains, _ = serve.serve_corpus(cfg)
    sys_, done, wall_s = serve.serve(
        args, cfg, params, LatencyProfile(list(sizes), list(t_ms), d0),
        domains, device="cpu", dparams=dparams)
    serve.report(args, sys_, wall_s)
    port_out = capsys.readouterr().out

    assert [list(r.generated) for r in done] == \
        [list(r.generated) for r in seen["done"]]
    got, want = sys_.summary(), jsys.summary()
    assert list(got) == list(want)
    for key in ("tokens", "steps", "spec_steps", "train_cycles", "deploys",
                "deployed", "spec_parks", "spec_resumes",
                "signals_collected", "trainer_failures"):
        assert got[key] == want[key], (key, got[key], want[key])
    if which == "always_on":
        assert got["spec_steps"] == got["steps"] and got["train_cycles"] > 0
    else:
        assert got["spec_parks"] > 0 and got["spec_steps"] < got["steps"]

    def keys(text):
        block = text.split("== TIDE summary")[1].split("accept_len trend")[0]
        return re.findall(r"^  (\w+): ", block, re.M)
    assert keys(port_out) == keys(jax_out)
    return sys_
