"""Synthetic serving workloads with controllable distribution shift; a
copy of ``repro/data/workloads.py`` (numpy only), so that the port
imports nothing of the JAX package.

Each *domain* (the stand-in for ShareGPT / Science / EvolCodeAlpaca /
NuminaMath / the multilingual Alpaca sets) is an order-1 Markov token
process over its own vocabulary region with its own branching factor
(entropy).  Workload streams sequence domains over time with short-term
temporal locality — the non-stationarity TIDE adapts to (paper §5.2/§5.4:
language transitions are the strongest shift because vocab regions are
disjoint, exactly as modeled here).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class Domain:
    name: str
    vocab_lo: int
    vocab_hi: int
    branching: int          # next-token choices per state (entropy knob)
    seed: int
    prompt_len: Tuple[int, int] = (12, 24)

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        n = self.vocab_hi - self.vocab_lo
        self.next_tok = rng.integers(0, n, size=(n, self.branching))
        probs = rng.dirichlet(np.ones(self.branching) * 0.5, size=n)
        self.next_prob = probs

    def sample(self, rng: np.random.Generator, length: int) -> List[int]:
        n = self.vocab_hi - self.vocab_lo
        tok = int(rng.integers(0, n))
        out = [tok]
        for _ in range(length - 1):
            j = rng.choice(self.branching, p=self.next_prob[tok])
            tok = int(self.next_tok[tok, j])
            out.append(tok)
        return [t + self.vocab_lo for t in out]

    def sample_prompt(self, rng: np.random.Generator) -> List[int]:
        length = int(rng.integers(*self.prompt_len))
        return self.sample(rng, length)


def make_domains(vocab_size: int, names: Sequence[str],
                 branchings: Optional[Sequence[int]] = None,
                 seed: int = 0) -> Dict[str, Domain]:
    """Split the vocab into disjoint per-domain regions (the 'different
    languages use different token ranges' shift model)."""
    n = len(names)
    span = vocab_size // n
    if branchings is None:
        branchings = [3] * n
    return {
        name: Domain(name, i * span, (i + 1) * span, branchings[i],
                     seed + 17 * i)
        for i, name in enumerate(names)
    }


# The paper's dataset mix, with entropy ordered to match its findings:
# ShareGPT (conversational, high entropy) adapts worst; Science
# (structured) adapts best.
PAPER_DOMAINS = ["sharegpt", "science", "evolcode", "numinamath"]
PAPER_BRANCHINGS = [8, 2, 3, 4]
MULTILINGUAL = ["korean", "arabic", "chinese", "french"]


@dataclasses.dataclass
class Phase:
    domain: str
    n_requests: int


class WorkloadStream:
    """Yields request prompts phase by phase (temporal locality + shift)."""

    def __init__(self, domains: Dict[str, Domain], schedule: List[Phase],
                 seed: int = 0, max_new_tokens: int = 48):
        self.domains = domains
        self.schedule = schedule
        self.rng = np.random.default_rng(seed)
        self.max_new_tokens = max_new_tokens

    def __iter__(self) -> Iterator[Tuple[str, List[int]]]:
        for phase in self.schedule:
            dom = self.domains[phase.domain]
            for _ in range(phase.n_requests):
                yield phase.domain, dom.sample_prompt(self.rng)

    def batches(self, batch_size: int):
        """Group the stream into serving waves of ``batch_size``."""
        buf = []
        for item in self:
            buf.append(item)
            if len(buf) == batch_size:
                yield buf
                buf = []
        if buf:
            while len(buf) < batch_size:      # pad the last wave by cycling
                buf.append(buf[len(buf) % max(len(buf), 1)])
            yield buf


# ------------------------------------------------------- arrival traces
@dataclasses.dataclass
class ArrivalEvent:
    """One request of an arrival trace: when it arrives, what it asks.

    ``max_new_tokens`` is ragged by design — heterogeneous budgets are
    what makes run-to-completion waves convoy behind their longest
    member, the workload continuous batching exists for.

    ``deadline``/``priority`` are the SLO annotations consumed by the
    ``DeadlineAdmission``/``PriorityAdmission`` serving policies; the
    default FIFO policy ignores them, so annotated traces replay
    identically under it."""
    t: float                  # arrival time (seconds since trace start)
    domain: str
    prompt: List[int]
    max_new_tokens: int
    deadline: Optional[float] = None   # completion SLO (since trace start)
    priority: int = 0                  # admission preference (higher first)


def arrival_trace(domains: Dict[str, Domain], n_requests: int, *,
                  mode: str = "poisson", rate: float = 16.0,
                  burst_size: int = 4, burst_gap: float = 1.0,
                  max_new_range: Tuple[int, int] = (8, 96),
                  long_frac: float = 0.0,
                  long_range: Tuple[int, int] = (80, 96),
                  prompt_len: Optional[Tuple[int, int]] = None,
                  long_prompt_frac: float = 0.0,
                  long_prompt_range: Tuple[int, int] = (64, 96),
                  long_prompt_period: int = 0,
                  deadline_slack: Optional[Tuple[float, float]] = None,
                  tight_frac: float = 0.0,
                  tight_slack: Optional[Tuple[float, float]] = None,
                  priority_levels: int = 0,
                  shared_prefix_frac: float = 0.0,
                  prefix_len: int = 0,
                  prefix_pool: int = 4,
                  schedule: Optional[List[Phase]] = None,
                  seed: int = 0) -> List[ArrivalEvent]:
    """Generate a request arrival trace with ragged budgets and prompts.

    mode="poisson": exponential inter-arrivals at ``rate`` req/s;
    mode="bursty": bursts of ``burst_size`` simultaneous arrivals every
    ``burst_gap`` seconds (the worst case for wave scheduling: every
    burst mixes short and long requests into one convoy).

    Domains follow ``schedule`` phases (temporal locality, as in
    ``WorkloadStream``) or round-robin over ``domains`` when omitted.
    ``max_new_tokens`` is uniform over ``max_new_range`` inclusive;
    with probability ``long_frac`` it is drawn from ``long_range``
    instead — the bimodal short-chat / long-tail budget mix of real
    request streams (and the degenerate case for run-to-completion
    waves: one long member convoys the whole batch).  Prompt lengths
    come from each domain's ``prompt_len`` unless overridden; with
    probability ``long_prompt_frac`` — or deterministically every
    ``long_prompt_period``-th request (periods align long prompts with
    bursts: ``long_prompt_period == burst_size`` puts exactly one long
    prompt in every burst, the worst co-admission mix) — a prompt is
    drawn from ``long_prompt_range`` instead: the bimodal
    *prompt*-length mix (RAG contexts, pasted documents) whose long
    tail stalls resident decode lanes for the whole refill prefill
    unless the engine chunks it (``ServingConfig(prefill_chunk=...)``).
    Timestamps are bookkeeping for latency metrics — under the default
    FIFO admission policy the serving engine admits in trace order, as
    fast as slots free up.

    SLO annotation: with ``deadline_slack=(lo, hi)`` each event gets a
    completion deadline ``t + U(lo, hi)`` (seconds since trace start);
    with probability ``tight_frac`` the slack is drawn from
    ``tight_slack`` instead — the bimodal loose/tight SLO mix
    (interactive vs batch traffic) that EDF admission
    (``DeadlineAdmission``) exists for.  ``priority_levels=k`` draws a
    uniform priority in [0, k) for ``PriorityAdmission``.  All SLO
    fields are inert under FIFO.

    Shared prefixes: with probability ``shared_prefix_frac`` an event's
    prompt is *prepended* with one of ``prefix_pool`` fixed
    ``prefix_len``-token system prompts (chat templates, RAG
    boilerplate — the redundancy a paged KV cache's COW prefix sharing
    deduplicates).  The pool and the per-event choices draw from a
    derived stream, so a prefix-annotated trace is the plain trace with
    prefixes glued on — prompt tails, budgets, and timings unperturbed.
    """
    rng = np.random.default_rng(seed)
    # SLO annotations draw from a derived stream so annotating a trace
    # never perturbs its prompts/budgets/timings — the annotated trace
    # is the plain trace plus metadata (pinned in tests/test_policy.py)
    slo_rng = np.random.default_rng(seed + 0x510)
    # shared system-prompt pool on its own derived stream, same contract
    prefix_rng = np.random.default_rng(seed + 0x9A6E)
    prefixes: List[np.ndarray] = []
    if shared_prefix_frac > 0 and prefix_len > 0:
        pool_dom = domains[next(iter(domains))]
        prefixes = [pool_dom.sample(prefix_rng, prefix_len)
                    for _ in range(max(prefix_pool, 1))]
    if schedule is not None:
        doms = [p.domain for p in schedule for _ in range(p.n_requests)]
        doms = doms[:n_requests]
        while len(doms) < n_requests:
            doms.append(doms[-1] if doms else next(iter(domains)))
    else:
        names = list(domains)
        doms = [names[i % len(names)] for i in range(n_requests)]
    events = []
    t = 0.0
    for i, name in enumerate(doms):
        if mode == "poisson":
            t += float(rng.exponential(1.0 / rate))
        elif mode == "bursty":
            t = (i // burst_size) * burst_gap
        else:
            raise ValueError(f"unknown arrival mode {mode!r}")
        dom = domains[name]
        if long_prompt_period:
            is_long = i % long_prompt_period == 0
        else:
            is_long = (long_prompt_frac > 0
                       and rng.random() < long_prompt_frac)
        if is_long:
            length = int(rng.integers(long_prompt_range[0],
                                      long_prompt_range[1] + 1))
            prompt = dom.sample(rng, length)
        elif prompt_len is not None:
            length = int(rng.integers(prompt_len[0], prompt_len[1] + 1))
            prompt = dom.sample(rng, length)
        else:
            prompt = dom.sample_prompt(rng)
        if prefixes and prefix_rng.random() < shared_prefix_frac:
            pick = int(prefix_rng.integers(len(prefixes)))
            prompt = np.concatenate([prefixes[pick],
                                     np.asarray(prompt)]).astype(np.int32)
        rng_range = (long_range if long_frac > 0
                     and rng.random() < long_frac else max_new_range)
        mx = int(rng.integers(rng_range[0], rng_range[1] + 1))
        deadline = None
        if deadline_slack is not None:
            slack = deadline_slack
            if tight_slack is not None and slo_rng.random() < tight_frac:
                slack = tight_slack
            deadline = t + float(slo_rng.uniform(slack[0], slack[1]))
        prio = (int(slo_rng.integers(0, priority_levels))
                if priority_levels > 0 else 0)
        events.append(ArrivalEvent(t, name, prompt, mx,
                                   deadline=deadline, priority=prio))
    return events


def training_corpus(domain: Domain, n_seqs: int, seq_len: int,
                    seed: int = 0) -> np.ndarray:
    """Token matrix for target-model pretraining / draft offline training."""
    rng = np.random.default_rng(seed)
    return np.stack([domain.sample(rng, seq_len) for _ in range(n_seqs)]
                    ).astype(np.int32)
