"""The port's serving engine on JAX-pretrained tide_tiny (80 steps, as in
tests/test_superstep.py), weights bridged in as numpy arrays.

* Greedy ``serve_wave`` / ``serve_stream`` token streams equal the JAX
  engine's (no drafter).  A divergence is accepted only where the
  flipped step is a near-tie of the target's top-2 logits.
* Inside the port the reference's own ladder holds exactly: stepwise ==
  superstep (any K), stream == wave, also with an AdaptiveDrafter that
  falls back from speculation to plain decoding mid-wave."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import repro.configs as C  # noqa: E402
from repro.checkpoint.ckpt import _flatten  # noqa: E402
from repro.core import eagle as jeagle  # noqa: E402
from repro.data.workloads import make_domains, training_corpus  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serving.engine import ServingEngine as JaxEngine  # noqa: E402
from repro.serving.request import Request as JaxRequest  # noqa: E402
from repro.training.trainer import pretrain_target  # noqa: E402
from repro_torch.checkpoint import bridge  # noqa: E402
from repro_torch.configs import get  # noqa: E402
from repro_torch.core import eagle  # noqa: E402
from repro_torch.core.adaptive import AdaptiveDrafter, LatencyProfile  # noqa: E402
from repro_torch.core.signals import SignalExtractor, SignalStore  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from repro_torch.serving.request import Request  # noqa: E402

NEAR_TIE = 1e-4          # top-2 logit gap below which a flip is a tie
_FLAT = LatencyProfile([1, 2, 4, 8], [1.0, 1.0, 1.0, 1.0], d0_ms=0.33)


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
    rng = np.random.default_rng(0)
    prompts = [domains["science"].sample_prompt(rng) for _ in range(8)]
    budgets = [24, 9, 24, 17, 5, 24, 12, 20]
    yield dict(jcfg=jcfg, jp=jp, jdcfg=jdcfg, jdp=jdp, cfg=cfg, dcfg=dcfg,
               tp=tp, tdp=tdp, prompts=prompts, budgets=budgets)
    torch.set_num_threads(threads)


def _port(pt, rounds, *, drafter=False, ema0=None, stream=True, n=8,
          batch=2):
    store = SignalStore()
    eng = ServingEngine(pt["cfg"], pt["tp"], pt["dcfg"], pt["tdp"],
                        batch_size=batch, max_len=96, gamma=3,
                        superstep_rounds=rounds, device="cpu",
                        drafter=AdaptiveDrafter(_FLAT, gamma=3)
                        if drafter else None,
                        extractor=SignalExtractor(store, window=16))
    if ema0 is not None:
        eng.accept_ema = ema0
    reqs = [Request(prompt=list(p), max_new_tokens=m)
            for p, m in zip(pt["prompts"][:n], pt["budgets"][:n])]
    if stream:
        eng.serve_stream(iter(reqs))
    else:
        for i in range(0, n, batch):
            eng.serve_wave(reqs[i:i + batch])
    assert all(r.finish_t is not None for r in reqs)
    sig = [(b.tokens.tobytes(), b.feats.tobytes()) for b in store.drain()]
    return [list(r.generated) for r in reqs], sig, eng


def _jax(pt, *, stream=True, n=8, batch=2):
    eng = JaxEngine(pt["jcfg"], pt["jp"], pt["jdcfg"], pt["jdp"],
                    batch_size=batch, max_len=96, gamma=3,
                    superstep_rounds=0)
    reqs = [JaxRequest(prompt=list(p), max_new_tokens=m)
            for p, m in zip(pt["prompts"][:n], pt["budgets"][:n])]
    if stream:
        eng.serve_stream(iter(reqs))
    else:
        for i in range(0, n, batch):
            eng.serve_wave(reqs[i:i + batch])
    return [list(r.generated) for r in reqs]


def _assert_streams_match(pt, got, want):
    """Equal streams, or a first divergence at a near-tie of the JAX
    target's greedy logits (greedy speculative decoding emits the
    target's greedy continuation, so the logits at the flipped step are
    a plain prefill of prompt + common prefix)."""
    ties = 0
    for prompt, g, w in zip(pt["prompts"], got, want):
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


@pytest.mark.parametrize("stream", [True, False], ids=["stream", "wave"])
def test_greedy_streams_equal_jax(pretrained, stream):
    want = _jax(pretrained, stream=stream)
    got, _, eng = _port(pretrained, 8, stream=stream)
    _assert_streams_match(pretrained, got, want)
    assert eng.stats.accept_len > 1.0, "no speculative acceptance exercised"


def test_port_ladder_stepwise_superstep_stream_wave(pretrained):
    g0, s0, e0 = _port(pretrained, 0, stream=False)
    g8, s8, e8 = _port(pretrained, 8, stream=False)
    assert g8 == g0 and s8 == s0
    assert e8.stats.steps == e0.stats.steps
    assert e8.stats.tokens_out == e0.stats.tokens_out
    assert e8.accept_ema == e0.accept_ema
    gs0, ss0, _ = _port(pretrained, 0, stream=True)
    gs3, ss3, _ = _port(pretrained, 3, stream=True)
    assert gs0 == g0 and gs3 == g0
    # with refills the two modes co-admit requests in other refill
    # batches (other padded widths), so prefill features may differ in
    # the last ulps; the windows' tokens are identical
    assert [t for t, _ in ss0] == [t for t, _ in ss3]
    for (_, f0), (_, f3) in zip(ss0, ss3):
        np.testing.assert_allclose(np.frombuffer(f0, np.float32),
                                   np.frombuffer(f3, np.float32),
                                   rtol=2e-5, atol=2e-5)


def test_port_ladder_midwave_drafter_fallback(pretrained):
    g0, s0, e0 = _port(pretrained, 0, drafter=True, ema0=3.0, stream=False,
                       n=4)
    g8, s8, e8 = _port(pretrained, 8, drafter=True, ema0=3.0, stream=False,
                       n=4)
    assert g8 == g0 and s8 == s0
    assert e8.stats.steps == e0.stats.steps
    assert e8.stats.spec_steps == e0.stats.spec_steps
    assert e8.accept_ema == e0.accept_ema
    assert 0 < e0.stats.spec_steps < e0.stats.steps, \
        "scenario did not exercise a mid-wave fallback"
