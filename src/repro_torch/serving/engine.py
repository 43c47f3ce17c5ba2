"""TIDE serving engine, greedy chain or draft-tree speculation, dense or
paged KV (port of ``repro/serving/engine.py``).

Continuous batching over B resident lanes: ``serve_stream`` keeps the
target KV cache, the EAGLE draft cache and the superstep state on the
device across a whole request stream, and between supersteps refills
finished lanes from the scheduler's queue (prefill the new prompts, seed
their draft cache, and write their lanes into the live state).
``serve_wave`` is a stream holding one wave.

Decode runs as a **superstep** of K rounds (``core.speculative.
decode_superstep``): the Eq. 5 speculate-vs-plain gate, token commit with
EOS/budget masks, the acceptance EMA and per-round ``extract_pack``
signal packing.  ``superstep_rounds=0`` selects the per-step host loop,
the parity reference: both modes emit identical token streams and
SignalStore contents.  The host replays each superstep's telemetry into
``ServingStats``, the Algorithm 1 controller and the signal extractor,
one superstep behind its dispatch, as the reference does.

Differences from the JAX engine:

  * Eager PyTorch reads each round's two predicates (any lane active,
    speculate or not) with one small device-to-host copy; the engine
    counts every such copy in ``host_syncs``.
  * JAX's buffer donation becomes in-place updates: the superstep,
    refill and commit ops write into the live cache tensors.
  * Entry points run on ``cuda`` unless ``device="cpu"`` is passed; with
    no device given and no CUDA card, construction raises.
  * Paged KV (``ServingConfig(page_size=P)``): the target and draft
    caches are page pools behind a host-authoritative block table
    (``core.paging``); lanes reserve pages at admission and the
    scheduler's admission guard defers what the pool cannot cover.
    Where JAX prefills a refill into a dense staging cache and copies it
    through the table, the port's refill prefill writes each layer's
    K/V straight into the lanes' pages and attends through the table
    (``flash_attention_paged``); decode attends through the table
    (``verify_attention_paged``) without building a dense view.  Table
    snapshots and refill page rows reach the device by asynchronous
    copies from pinned memory, so paging adds no host sync.  Committed
    prompt prefixes are shared copy-on-write at commit, on the one-shot
    path.  The pools live as long as the engine, so a prefix published
    in one ``serve_stream`` stays valid in the next (the JAX engine makes
    new pools per stream but keeps its registry).
  * Tree speculation (``SpeculationPolicy(tree_width=W)``, which
    ``ServingConfig(tree_width=W)`` sets in the default policy): each
    speculative round drafts W branches of depth gamma and verifies them
    in one tree-masked target pass (``core.speculative.tree_decode_step``);
    W = 1 is the chain bit for bit.  Dense or paged KV: on a paged
    engine the verify attends through the block table in tree mode, the
    accepted branch is compacted through the table, and each lane
    reserves the tree's block of gamma * W + 1 rows (the chain reserves
    gamma + 1).
  * Only this slice is ported.  Sampled decoding, chunked refill prefill
    (and with it the paged prefix resume) and deploy re-seeding raise
    ``NotImplementedError`` naming their ROADMAP item; preemption,
    spill/restore and load shedding have no knob in the port yet.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Callable, Iterable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import eagle, paging, speculative as spec
from repro_torch.core.adaptive import AdaptiveDrafter
from repro_torch.core.controller import Decision, TrainingController
from repro_torch.core.signals import SignalExtractor
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.recorder import NULL_RECORDER
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.serving.policy import ServingConfig, ServingPolicy
from repro_torch.serving.request import Request, inert_request
from repro_torch.serving.scheduler import Scheduler
from repro_torch.serving.stats import P2Quantile, Ring

# sampling-stream id for lanes that never emit (inert padding, free slots)
INERT_SID = 0x7FFFFFFF

_STATS_COUNTERS = (
    "tokens_out", "steps", "spec_steps", "dispatches", "refills",
    "idle_supersteps", "deploys", "completed", "accept_len_n",
    "lane_rounds", "busy_lane_rounds", "prefill_row_tokens",
    "pages_peak", "prefix_hits", "prefix_tokens_saved",
    "admission_deferrals",
)
_STATS_FLOAT_COUNTERS = ("wall_s", "accept_len_sum")


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None means the current CUDA card,
    and raises when there is none (the port never falls back to the CPU
    on its own)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the port runs on the card; "
                               "pass device='cpu' to run it on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


class _CounterView:
    """Descriptor exposing the registry counter ``serving.<name>`` as a
    plain read/write attribute."""
    __slots__ = ("name",)

    def __set_name__(self, owner, name):
        self.name = name

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        return obj._counters[self.name].value

    def __set__(self, obj, value):
        obj._counters[self.name].value = value


class ServingStats:
    """Engine counters, backed by the ``serving.*`` namespace of a
    ``MetricsRegistry``.  ``tokens_out`` counts exactly the tokens that
    survive in ``Request.generated`` (the first token included)."""

    def __init__(self, retain: int = 4096, registry=None):
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self.retain = retain
        self._counters = {}
        for name in _STATS_COUNTERS:
            c = self.registry.counter(f"serving.{name}")
            c.value = 0
            self._counters[name] = c
        for name in _STATS_FLOAT_COUNTERS:
            c = self.registry.counter(f"serving.{name}")
            c.value = 0.0
            self._counters[name] = c
        self.ttfts = Ring(retain)
        self.latencies = Ring(retain)
        self.timeline = Ring(retain)
        self.prefill_op_width = self.registry.histogram(
            "serving.prefill_op_width", (0.5,), reset=True)
        self._ttft_hist = self.registry.histogram(
            "serving.ttft_s", (0.5,), reset=True)
        self._lat_hist = self.registry.histogram(
            "serving.latency_s", (0.5, 0.95), reset=True)
        for gname, prop in (
                ("serving.throughput_tok_s", "throughput"),
                ("serving.occupancy", "occupancy"),
                ("serving.accept_len", "accept_len"),
                ("serving.ttft_p50_s", "ttft_p50"),
                ("serving.latency_p50_s", "latency_p50"),
                ("serving.latency_p95_s", "latency_p95")):
            self.registry.gauge(
                gname, fn=functools.partial(getattr, self, prop))

    def record_ttft(self, x: float):
        self.ttfts.append(x)
        self._ttft_hist.add(x)

    def record_latency(self, x: float):
        self.latencies.append(x)
        self._lat_hist.add(x)

    @property
    def accept_len(self) -> float:
        return self.accept_len_sum / max(self.accept_len_n, 1)

    @property
    def throughput(self) -> float:
        return self.tokens_out / max(self.wall_s, 1e-9)

    @property
    def occupancy(self) -> float:
        return self.busy_lane_rounds / max(self.lane_rounds, 1)

    def _pct(self, xs, sketch: P2Quantile, q: float) -> float:
        if sketch.n_obs > len(xs):
            return sketch.value
        return float(np.percentile(np.asarray(xs), q)) if xs else 0.0

    @property
    def ttft_p50(self) -> float:
        return self._pct(self.ttfts, self._ttft_hist.sketches[0.5], 50)

    @property
    def latency_p50(self) -> float:
        return self._pct(self.latencies, self._lat_hist.sketches[0.5], 50)

    @property
    def latency_p95(self) -> float:
        return self._pct(self.latencies, self._lat_hist.sketches[0.95], 95)


for _name in _STATS_COUNTERS + _STATS_FLOAT_COUNTERS:
    _view = _CounterView()
    _view.__set_name__(ServingStats, _name)
    setattr(ServingStats, _name, _view)
del _name, _view


def _unported(config: ServingConfig):
    """Raise for every configuration outside this slice."""
    checks = (
        (not config.greedy, "greedy=False", "sampled decoding"),
        (config.prefill_chunk > 0, "prefill_chunk>0",
         "chunked refill prefill"),
        (config.reseed_window > 0, "reseed_window>0", "overload and reseed"),
    )
    for bad, what, item in checks:
        if bad:
            raise NotImplementedError(
                f"{what} is not ported yet (ROADMAP queue 1: {item})")


class ServingEngine:
    def __init__(self, cfg: ModelConfig, params, dcfg: ModelConfig,
                 dparams, *, gamma: int = 3, max_len: int = 160,
                 batch_size: int = 4, greedy: bool = True,
                 drafter: Optional[AdaptiveDrafter] = None,
                 controller: Optional[TrainingController] = None,
                 extractor: Optional[SignalExtractor] = None,
                 ema: float = 0.9,
                 superstep_rounds: int = 8,
                 eos_id: Optional[int] = None,
                 deploy_source: Optional[Callable[[], object]] = None,
                 reseed_window: int = 0,
                 idle_wait_s: float = 0.005,
                 config: Optional[ServingConfig] = None,
                 policy: Optional[ServingPolicy] = None,
                 tracer=None, recorder=None, metrics=None, device=None):
        knobs = dict(gamma=(gamma, 3), batch_size=(batch_size, 4),
                     max_len=(max_len, 160), greedy=(greedy, True),
                     superstep_rounds=(superstep_rounds, 8),
                     eos_id=(eos_id, None), ema=(ema, 0.9),
                     reseed_window=(reseed_window, 0),
                     idle_wait_s=(idle_wait_s, 0.005))
        if config is None:
            config = ServingConfig(**{k: v for k, (v, _) in knobs.items()})
        else:
            clash = [k for k, (v, d) in knobs.items() if v != d]
            if clash:
                raise ValueError(
                    f"ServingEngine got both config= and knob kwargs "
                    f"{clash}; set them on the ServingConfig instead")
            config = dataclasses.replace(config)
        _unported(config)
        self.device = resolve_device(device)
        pdev = params["embed"]["tok"].device
        if pdev.type != self.device.type or (
                self.device.index is not None and pdev.index != self.device.index):
            raise ValueError(f"params on {pdev}, engine on {self.device}")
        self.config = config
        self.cfg, self.dcfg = cfg, dcfg
        self.params, self.dparams = params, dparams
        self.gamma, self.max_len = config.gamma, config.max_len
        self.batch = config.batch_size
        self.greedy = config.greedy
        self.controller = controller
        self.extractor = extractor
        self.accept_ema = 1.0
        self._ema = config.ema
        self.superstep_rounds = config.superstep_rounds
        self.eos_id = config.eos_id
        if policy is None:
            policy = config.make_policy()
        elif config.tree_width not in (0, policy.speculation.tree_width):
            raise ValueError(
                f"ServingConfig.tree_width={config.tree_width} but the "
                f"policy's is {policy.speculation.tree_width}; the draft "
                f"shape is the speculation policy's")
        if drafter is not None and policy.speculation.drafter is None:
            policy.speculation.drafter = drafter
        self.policy = policy
        self.drafter = policy.speculation.drafter
        self.policy.speculation.prepare(self.batch, self.device)
        # the draft shape is the speculation policy's (the config seeds
        # the default policy)
        self.tree_width = policy.speculation.tree_width
        if self.tree_width:
            T.tree_check(cfg)
        self.deploy_source = deploy_source
        self._deploy_seq = 0
        self.gate_arrivals = config.gate_arrivals
        self.completion_sink = config.completion_sink
        self.idle_wait_s = config.idle_wait_s
        self._sleep = time.sleep
        self._clock = time.perf_counter
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.recorder = recorder if recorder is not None else NULL_RECORDER
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.stats = ServingStats(registry=self.metrics)
        # paged KV (page_size > 0): a host-side allocator over page pools
        # made at the first prologue and kept for the engine's lifetime
        self.page_size = config.page_size
        self.paged = self.page_size > 0
        self.allocator: Optional[paging.PageAllocator] = None
        self.num_pages = 0
        self._pools = None
        if self.paged:
            T.paged_check(cfg, self.max_len, self.page_size)
            self.num_pages = (config.num_pages or
                              self.batch * self.max_len // self.page_size)
            self.allocator = paging.PageAllocator(
                self.num_pages, self.page_size, self.batch, self.max_len,
                share_prefix=config.share_prefix)
        self.policy.speculation.on_transition = self._spec_transition
        self._register_obs_metrics()
        self._sid_next = 0
        # every device-to-host copy the engine makes (round predicates,
        # telemetry pulls, first tokens)
        self.host_syncs = 0

    # ------------------------------------------------------------ device ops
    def _host(self, t: torch.Tensor) -> np.ndarray:
        """Copy a device tensor to the host (one counted sync)."""
        self.host_syncs += 1
        return t.cpu().numpy()

    def _t(self, x, dtype) -> torch.Tensor:
        return torch.as_tensor(x, dtype=dtype, device=self.device)

    def _prefill(self, toks, pad, pools=None, tbl_rows=None):
        return T.prefill(self.cfg, self.params, toks, max_len=self.max_len,
                         pad=pad, pools=pools, tbl_rows=tbl_rows)

    def _ema_step(self, ema: float, ell: float) -> float:
        """The superstep's EMA op, on the engine device, from host
        values."""
        out = spec.ema_update(self._t(ema, torch.float32),
                              self._t(ell, torch.float32), self._ema)
        return float(self._host(out))

    def _refill_core(self, cache, dcache, toks, pad, mask, src,
                     tbl_rows=None):
        """Prefill a refill batch of R prompts and write their lanes into
        the live caches in place.  Paged: ``tbl_rows`` (R, n_tbl) holds
        each refill row's lane table row (all trash for a row no lane
        gathers), and the prefill writes the target K/V through it.
        Returns (cache, dcache, the R-batch prefill carry, the R first
        tokens)."""
        if self.paged:
            pre = self._prefill(toks, pad, cache, tbl_rows)
        else:
            pre = self._prefill(toks, pad)
        first = self._pick(pre["logits"])
        rdc = eagle.seed_refill_cache(self.dcfg, self.dparams,
                                      self.params["embed"], pre["captures"],
                                      toks, pad, self.max_len)
        if self.paged:
            spec.scatter_target_cache_paged(cache, pre["cache"], mask, src)
            eagle.scatter_draft_rows_paged(dcache, rdc, mask, src)
        else:
            spec.scatter_target_cache(cache, pre["cache"], mask, src)
            eagle.scatter_draft_rows(dcache, rdc, mask, src)
        carry_r = spec.init_carry(self.cfg, self.dcfg, pre, first, self.gamma)
        return cache, dcache, carry_r, first

    def _refill_superstep(self, cache, dcache, state, max_new, toks, pad,
                          mask, src, budgets, sids, tbl_rows=None):
        cache, dcache, carry_r, first = self._refill_core(
            cache, dcache, toks, pad, mask, src, tbl_rows)
        state = spec.refill_superstep_state(
            state, carry_r, first, budgets, mask, src, eos_id=self.eos_id,
            sids=sids)
        max_new = torch.where(mask, budgets[src.long()], max_new)
        return cache, dcache, state, max_new, first

    def _superstep(self, cache, dcache, state, max_new, table):
        out = spec.decode_superstep(
            self.cfg, self.dcfg, self.params, self.dparams, cache, dcache,
            state, max_new, table, rounds=self.superstep_rounds,
            gamma=self.gamma, greedy=self.greedy, ema_decay=self._ema,
            eos_id=self.eos_id, collect_signals=self.extractor is not None,
            tree_width=self.tree_width)
        self.host_syncs += out["host_syncs"]
        return out

    def _pick(self, logits):
        """Greedy token: the first maximal index, as JAX's argmax."""
        return logits.argmax(-1).to(torch.int32)

    # ------------------------------------------------------------- deploy
    def deploy_draft(self, dparams):
        """Hot-swap the draft (no target reload).  Lanes resident at swap
        time keep draft-cache K/V built by the old draft until they
        retire; token streams stay correct (the target verifies every
        draft)."""
        self.dparams = dparams

    def _poll_deploy(self, source=None):
        """Pick up a freshly published draft version, if any (one host
        attribute read per superstep)."""
        source = source or self.deploy_source
        if source is None:
            return None
        ver = source()
        if ver is None or ver.seq <= self._deploy_seq:
            return None
        self._deploy_seq = ver.seq
        self.dparams = ver.dparams
        self.stats.deploys += 1
        if self.tracer.enabled:
            self.tracer.instant("deploy", seq=ver.seq)
        if self.recorder.enabled:
            self.recorder.global_event("deploy", round_=self.stats.steps,
                                       seq=ver.seq)
        return ver

    # -------------------------------------------------- observability
    def _register_obs_metrics(self):
        reg = self.metrics
        sp = self.policy.speculation
        reg.gauge("spec.parks", fn=lambda: sp.parks)
        reg.gauge("spec.resumes", fn=lambda: sp.resumes)
        reg.gauge("spec.parked", fn=lambda: int(sp.parked))
        reg.gauge("spec.probing", fn=lambda: int(sp.probing))
        reg.gauge("spec.tree_width", fn=lambda: self.tree_width)
        reg.gauge("spec.gamma", fn=lambda: self.gamma)
        reg.gauge("spec.accept_ema", fn=lambda: self.accept_ema)
        if self.allocator is not None:
            self.allocator.register_metrics(reg)
        else:
            # dense engines expose the namespace too (all zero)
            for name in ("pages_in_use", "pages_free", "pages_peak",
                         "prefix_hits", "prefix_tokens_saved", "evictions",
                         "cow_forks"):
                reg.gauge(f"paging.{name}")

    def _spec_transition(self, kind: str, fields: dict):
        if self.tracer.enabled:
            self.tracer.instant(kind, **fields)
        if self.recorder.enabled:
            self.recorder.global_event(kind, round_=self.stats.steps,
                                       **fields)

    def _assign_sids(self, admitted):
        for _, r in admitted:
            if r.admit_round is None:
                r.admit_round = self.stats.steps
            if r.sid is None:
                r.sid = self._sid_next
                self._sid_next += 1
                if self.recorder.enabled:
                    self.recorder.admit(r, self.stats.steps)

    def _apply_capture_park(self):
        if self.extractor is None or not self.policy.speculation.park_patience:
            return
        if self.policy.speculation.blocks_capture:
            self.extractor.enabled = False
        elif self.controller is None:
            self.extractor.enabled = True

    def _idle_tick(self, wait: Optional[float]):
        self.stats.idle_supersteps += 1
        with self.tracer.span("idle"):
            self._sleep(min(max(wait or 0.0, 0.0), self.idle_wait_s))

    # -------------------------------------------------- request accounting
    def _finish(self, r: Request):
        if r.finish_t is None:
            r.finish(self._clock())
            r.finish_round = self.stats.steps
            self.stats.completed += 1
            if r.latency is not None:
                self.stats.record_latency(r.latency)
            if self.recorder.enabled:
                self.recorder.finish(r, self.stats.steps)

    def _commit_first(self, r: Request, tok: int):
        """Commit a freshly prefilled slot's first token."""
        if r.finish_t is not None:
            return
        if r.max_new_tokens < 1:
            self._finish(r)
            return
        r.generated.append(tok)
        if r.first_token_t is None:
            r.first_token_t = self._clock()
            r.first_token_round = self.stats.steps
            self.stats.record_ttft(r.ttft)
            if self.recorder.enabled:
                self.recorder.note(r.rid, "first_token",
                                   round_=self.stats.steps)
        self.stats.tokens_out += 1
        if self.eos_id is not None and tok == self.eos_id:
            self._finish(r)

    def _note_prefill_op(self, rows: int, width: int):
        self.stats.prefill_op_width.add(width)
        self.stats.prefill_row_tokens += rows * width

    # ------------------------------------------------------------- prologue
    def _prologue(self, requests: List[Request]):
        """Pad + prefill + draft seed for one full batch of B slots.
        Returns the initial device state (cache, dcache, carry, first)."""
        b = self.batch
        plen = max(len(r.prompt) for r in requests)
        toks = np.zeros((b, plen), np.int32)
        pad = np.zeros((b,), np.int32)
        for i, r in enumerate(requests):
            pad[i] = plen - len(r.prompt)
            toks[i, pad[i]:] = r.prompt
        toks_t, pad_t = self._t(toks, torch.int32), self._t(pad, torch.int32)
        self._note_prefill_op(b, plen)
        if self.paged:
            # a refill of every lane: reserve the live ones (inert slots
            # are not scheduler-owned and map nothing), write the batch
            # prefill through the tables, then publish the prefixes
            group = [(i, r) for i, r in enumerate(requests)
                     if r.finish_t is None]
            self._reserve_group(group, plen)
            cache, dcache = self._paged_caches()
            cache, dcache, carry, first = self._refill_core(
                cache, dcache, toks_t, pad_t,
                torch.ones((b,), dtype=torch.bool, device=self.device),
                torch.arange(b, dtype=torch.int32, device=self.device),
                self._tbl_rows(list(enumerate(requests)), b))
            self._publish_prefixes(self._prefix_entries(group, b, plen))
            return cache, dcache, carry, first
        pre = self._prefill(toks_t, pad_t)
        first = self._pick(pre["logits"])
        dcache = eagle.init_draft_cache(self.dcfg, b, self.max_len,
                                        device=self.device)
        dcache = eagle.seed_prompt_pairs(self.dcfg, self.dparams,
                                         self.params["embed"], dcache,
                                         pre["captures"], toks_t, pad_t)
        carry = spec.init_carry(self.cfg, self.dcfg, pre, first, self.gamma)
        return pre["cache"], dcache, carry, first

    # ------------------------------------------------------------- serving
    def serve_wave(self, requests: List[Request]) -> List[Request]:
        """Serve one wave to completion (a stream of one wave); waves
        smaller than the batch are padded with inert slots."""
        if len(requests) > self.batch:
            raise ValueError(f"wave of {len(requests)} exceeds engine batch "
                             f"{self.batch}")
        self.serve_stream(requests)
        return requests

    @staticmethod
    def _slot_sids(requests) -> np.ndarray:
        return np.asarray([INERT_SID if (r is None or r.sid is None)
                           else r.sid for r in requests], np.int32)

    def serve_stream(self, requests: Iterable[Request], *,
                     on_complete: Optional[Callable[[Request], None]] = None
                     ) -> List[Request]:
        """Serve a request stream with in-flight slot refill.  Returns the
        completed requests in completion order (empty when a
        ``completion_sink`` streams them out)."""
        sched = Scheduler(self.batch, requests,
                          policy=self.policy.admission,
                          gate_arrivals=self.gate_arrivals,
                          clock=self._clock,
                          completion_sink=self.completion_sink,
                          admission_guard=(self._admission_guard
                                           if self.paged else None),
                          tracer=self.tracer)
        t0 = self._clock()
        while not sched.has_work():
            wait = sched.next_arrival_in()
            if wait is None:
                return sched.completed
            self._idle_tick(wait)
        admitted = sched.admit()
        self._assign_sids(admitted)
        reqs0 = [r if r is not None else inert_request()
                 for r in sched.slots]
        with self.tracer.span("prefill.prologue", rows=self.batch):
            cache, dcache, carry, first = self._prologue(reqs0)
        first_np = self._host(first)
        for i, r in enumerate(reqs0):
            self._commit_first(r, int(first_np[i]))
        if self.superstep_rounds > 0:
            self._stream_superstep(sched, reqs0, cache, dcache, carry,
                                   first, t0, on_complete)
        else:
            self._stream_stepwise(sched, cache, dcache, carry, t0,
                                  on_complete)
        if self.extractor is not None:
            self.extractor.flush()
        self.stats.wall_s += self._clock() - t0
        return sched.completed

    def _retire_and_admit(self, sched: Scheduler, on_complete):
        """Release finished slots, then admit pending requests into them.
        Returns the new (slot, request) assignments to refill."""
        if self.paged:
            self._free_finished_lanes(sched)
        for r in sched.release_finished():
            if on_complete is not None:
                on_complete(r)
        admitted = sched.admit()
        self._assign_sids(admitted)
        return admitted

    def _refill_arrays(self, admitted: List[Tuple[int, Request]]):
        """Host-side packing of a refill batch: rows padded to a power of
        two (pad rows replicate row 0 and are never gathered), prompt
        width to a multiple of 8.  Returns device tensors (toks, pad,
        mask, src, budgets, sids)."""
        plen = max(len(r.prompt) for _, r in admitted)
        plen = max(8, -(-plen // 8) * 8)
        n = len(admitted)
        width = 1
        while width < n:
            width *= 2
        toks = np.zeros((width, plen), np.int32)
        pad = np.zeros((width,), np.int32)
        budgets = np.zeros((width,), np.int32)
        sids = np.full((width,), INERT_SID, np.int32)
        for row, (_, r) in enumerate(admitted):
            pad[row] = plen - len(r.prompt)
            toks[row, pad[row]:] = r.prompt
            budgets[row] = r.max_new_tokens
            sids[row] = r.sid
        toks[n:] = toks[0]
        pad[n:] = pad[0]
        mask = np.zeros((self.batch,), bool)
        src = np.zeros((self.batch,), np.int32)
        for row, (slot, _) in enumerate(admitted):
            mask[slot] = True
            src[slot] = row
        return (self._t(toks, torch.int32), self._t(pad, torch.int32),
                self._t(mask, torch.bool), self._t(src, torch.int32),
                self._t(budgets, torch.int32), self._t(sids, torch.int32))

    # ------------------------------------------------- paged KV plumbing
    def _paged_caches(self):
        """The paged target and draft caches for a new stream: the
        engine's page pools (made on first use, kept across streams so
        registry prefixes stay valid) with fresh lengths, pad and
        tables."""
        if self._pools is None:
            self._pools = (
                T.init_cache(self.cfg, self.batch, self.max_len,
                             device=self.device, page_size=self.page_size,
                             num_pages=self.num_pages),
                eagle.init_draft_cache(self.dcfg, self.batch, self.max_len,
                                       device=self.device,
                                       page_size=self.page_size,
                                       num_pages=self.num_pages))
        lanes = {k: torch.zeros((self.batch,), dtype=torch.int32,
                                device=self.device) for k in ("lengths", "pad")}
        cache = dict(self._pools[0], **lanes)
        dcache = dict(self._pools[1], **{k: v.clone() for k, v in lanes.items()})
        self.allocator.dirty = True
        return self._ship_tables(cache, dcache)

    def _ship_tables(self, cache, dcache):
        """Give the caches fresh device copies of the block table iff the
        allocator changed it since the last ship (two copies: the target
        and the draft cache each hold their own, as in the reference).
        The copies are enqueued from pinned memory (``paging.to_device``)
        behind the ops already dispatched, which keep reading the table
        they were given: no host sync.  No-op on dense engines."""
        if self.allocator is not None and self.allocator.dirty:
            cache["page_tbl"] = self.allocator.table_device(self.device)
            dcache["tbl"] = self.allocator.table_device(self.device)
            self.allocator.dirty = False
        return cache, dcache

    def _tbl_rows(self, group: List[Tuple[int, Request]], rows: int):
        """(rows, n_tbl) device page rows of a refill op: row i gets the
        table row of group[i]'s lane; rows no lane gathers map only the
        trash page (their writes land there)."""
        a = self.allocator
        tbl = np.full((rows, a.n_tbl), a.trash, np.int32)
        for row, (slot, _) in enumerate(group):
            tbl[row] = a.table[slot]
        return paging.to_device(tbl, self.device)

    def _map_refill(self, cache, dcache, admitted, rows: int, width: int):
        """Paged refill set-up: reserve the admitted lanes' pages, ship
        the tables, and build the refill's page rows.  Returns (cache,
        dcache, tbl_rows); tbl_rows is None on dense engines."""
        if not self.paged:
            return cache, dcache, None
        self._reserve_group(admitted, width)
        cache, dcache = self._ship_tables(cache, dcache)
        return cache, dcache, self._tbl_rows(admitted, rows)

    def _reservation(self, width: int, req: Request) -> int:
        """Token reservation for one lane: prompt width, decode budget,
        and the verify block that a round writes past the committed
        length before the accept masks land: gamma + 1 rows for the
        chain, gamma * W + 1 for a draft tree of width W (the tree
        commit compacts the accepted branch back into chain order, so
        only the block itself overshoots)."""
        block = self.gamma * max(self.tree_width, 1) + 1
        return width + req.max_new_tokens + block

    def _admission_guard(self, req: Request,
                         accepted: List[Request]) -> bool:
        """Scheduler veto: would this round's accepted requests plus
        ``req`` all fit the page pool?  The width charged is the widest
        bucketed refill width among them (co-admitted refills all pad to
        it), so the estimate can only over-count."""
        cands = accepted + [req]
        wmax = max(max(8, -(-len(r.prompt) // 8) * 8) for r in cands)
        need = sum(self.allocator.pages_for(self._reservation(wmax, r))
                   for r in cands)
        if self.allocator.can_fit(need):
            return True
        self.stats.admission_deferrals += 1
        if self.recorder.enabled:
            self.recorder.global_event("admission_deferral",
                                       round_=self.stats.steps,
                                       rid=req.rid, pages_needed=need)
        return False

    def _reserve_group(self, group: List[Tuple[int, Request]], width: int):
        """Map page reservations for the lanes of one refill group (the
        admission guard already sized the round, so a failure is a logic
        error, not a deferral)."""
        for slot, req in group:
            if not self.allocator.reserve(
                    slot, self._reservation(width, req)):
                raise RuntimeError(
                    f"page reservation for slot {slot} failed after "
                    "admission passed the pool guard")
        self._sync_paged_stats()

    def _free_finished_lanes(self, sched: Scheduler):
        """Release finished lanes' pages before the scheduler clears their
        slots.  Writes still queued from such a lane land in pages that a
        later owner's refill (queued behind them) rewrites before it reads
        them."""
        for i, r in enumerate(sched.slots):
            if r is not None and r.finish_t is not None:
                self.allocator.free_lane(i)

    def _sync_paged_stats(self):
        a = self.allocator
        self.stats.pages_peak = a.peak_in_use
        self.stats.prefix_hits = a.prefix_hits
        self.stats.prefix_tokens_saved = a.prefix_tokens_saved

    def _prefix_entries(self, group: List[Tuple[int, Request]], rows: int,
                        width: int):
        """Provenance keys of one refill group's shareable prompt
        prefixes: per row the first m = (width - 1) // P pages (the page
        holding the last draft pair takes the first generated token, so
        it never shares).  Built on the host from the prompts."""
        if not self.allocator.share_prefix:
            return []
        m = (width - 1) // self.page_size
        if m <= 0:
            return []
        entries = []
        for slot, req in group:
            pad = width - len(req.prompt)
            toks = [0] * pad + list(req.prompt)
            key = self.allocator.prefix_key(rows, width, pad, toks, m,
                                            salt=self._deploy_seq)
            entries.append((slot, key, m))
        return entries

    def _publish_prefixes(self, entries):
        """After a refill is enqueued: register each row's prefix pages,
        or, where an equal prefix is registered, adopt its pages and free
        the lane's private copies.  The bytes are equal by provenance.
        The freed copies are still being written by the queued refill;
        that is safe because every later op is queued behind it on the
        one stream, and the repointed table ships before the next
        dispatch."""
        for slot, key, m in entries:
            hit = self.allocator.lookup(key)
            if hit is not None:
                self.allocator.adopt(slot, hit[:m])
            else:
                self.allocator.publish(key, slot, m)
        if entries:
            self._sync_paged_stats()

    def release_prefix_cache(self):
        """Drop the shared-prefix registry (drain hygiene, leak checks).
        No-op on dense engines."""
        if self.allocator is not None:
            self.allocator.release_prefix_cache()

    # ----------------------------------------------- superstep hot path
    def _materialize(self, rounds):
        """Pull telemetry to the host; the packed signal buffers stay on
        the device until ``_unpack_superstep`` needs them."""
        keys = [k for k in rounds if not k.startswith("sig_")]
        flat = torch.cat([rounds[k].reshape(rounds[k].shape[0], -1).float()
                          for k in keys], dim=1)
        host = self._host(flat)
        out, col = {}, 0
        for k in keys:
            v = rounds[k]
            n = int(np.prod(v.shape[1:], dtype=np.int64))
            arr = host[:, col:col + n].reshape(v.shape)
            col += n
            if v.dtype == torch.bool:
                arr = arr.astype(bool)
            elif v.dtype != torch.float32:
                arr = arr.astype(np.int64)
            else:
                arr = arr.astype(np.float32)
            out[k] = arr
        out.update({k: v for k, v in rounds.items() if k.startswith("sig_")})
        return out

    def _stream_superstep(self, sched, reqs0, cache, dcache, carry, first,
                          t0, on_complete):
        max_new = self._t([r.max_new_tokens for r in reqs0], torch.int32)
        active0 = self._t([r.finish_t is None for r in reqs0], torch.bool)
        state = spec.init_superstep_state(
            carry, first, accept_ema=self.accept_ema, eos_id=self.eos_id,
            active0=active0, sids=self._t(self._slot_sids(reqs0),
                                          torch.int32))
        # one-superstep double buffer, as in the reference: superstep t+1
        # is dispatched before t's telemetry is unpacked; refills
        # scheduled from t's unpack enter behind t+1
        pending = None
        stall = 0
        while True:
            self._poll_deploy()
            dispatched = False
            if sched.has_work():
                cache, dcache = self._ship_tables(cache, dcache)
                with self.tracer.span("superstep.dispatch",
                                      rounds=self.superstep_rounds):
                    out = self._superstep(
                        cache, dcache, state, max_new,
                        self.policy.speculation.dispatch_table())
                self.stats.dispatches += 1
                cache, dcache, state = (out["cache"], out["dcache"],
                                        out["state"])
                prev, pending = pending, {"rounds": out["rounds"],
                                          "slots": list(sched.slots),
                                          "refills": []}
                dispatched = True
            else:
                prev, pending = pending, None
            if prev is None:
                if not dispatched:
                    wait = sched.next_arrival_in()
                    if wait is None and not sched.more_coming():
                        break
                    self._idle_tick(wait)
                continue
            with self.tracer.span("superstep.unpack"):
                progressed = self._drain(prev, t0)
            admitted = self._retire_and_admit(sched, on_complete)
            if admitted:
                args = self._refill_arrays(admitted)
                rows, width = args[0].shape
                self._note_prefill_op(rows, width)
                cache, dcache, tbl_rows = self._map_refill(
                    cache, dcache, admitted, rows, width)
                with self.tracer.span("refill", rows=int(rows),
                                      width=int(width)):
                    cache, dcache, state, max_new, fdev = \
                        self._refill_superstep(cache, dcache, state,
                                               max_new, *args,
                                               tbl_rows=tbl_rows)
                self.stats.refills += len(admitted)
                if self.paged:
                    self._publish_prefixes(self._prefix_entries(
                        admitted, int(rows), int(width)))
                if pending is not None:
                    pending["refills"].append((fdev, admitted))
                else:
                    first_np = self._host(fdev)
                    for row, (_, req) in enumerate(admitted):
                        self._commit_first(req, int(first_np[row]))
            stall = 0 if (progressed or admitted) else stall + 1
            if stall > 4:
                raise RuntimeError(
                    "serve_stream made no progress over 5 supersteps "
                    "(device/host slot state diverged)")

    def _drain(self, rec, t0) -> bool:
        """Unpack one superstep record, then commit the first tokens of
        the refills enqueued behind it.  Returns True if any round was
        valid."""
        ys = self._materialize(rec["rounds"])
        rids = [r.rid if r is not None else -1 for r in rec["slots"]]
        progressed = self._unpack_superstep(ys, rec["slots"], rids, t0)
        for fdev, admitted in rec["refills"]:
            first_np = self._host(fdev)
            for row, (_, req) in enumerate(admitted):
                self._commit_first(req, int(first_np[row]))
        return progressed

    def _unpack_superstep(self, ys, requests, rids, t0) -> bool:
        """Replay one superstep's host-side bookkeeping from its
        telemetry: token commit, stats/timeline, the Algorithm 1
        controller and packed-signal ingestion."""
        valid = ys["valid"]
        sig_np = None
        any_valid = False
        rec_on = self.recorder.enabled
        for r in range(valid.shape[0]):
            if not valid[r]:
                break
            any_valid = True
            use_spec = bool(ys["use_spec"][r])
            ell = float(ys["ell"][r])
            alpha = float(ys["alpha"][r])
            n_eff = ys["n_eff"][r]
            toks = ys["tokens"][r]
            active_after = ys["active_after"][r]
            for i, req in enumerate(requests):
                if req is None:
                    continue
                n = int(n_eff[i])
                if n:
                    req.generated.extend(int(t) for t in toks[i, :n])
                    if rec_on:
                        self.recorder.note(req.rid, "commit",
                                           round_=self.stats.steps,
                                           n=n, spec=use_spec)
                if (not active_after[i] and req.finish_t is None
                        and req.first_token_t is not None):
                    self._finish(req)
            busy = int((n_eff > 0).sum())
            self.stats.tokens_out += int(n_eff.sum())
            self.stats.steps += 1
            self.stats.spec_steps += int(use_spec)
            self.stats.accept_len_sum += ell
            self.stats.accept_len_n += 1
            self.stats.lane_rounds += len(requests)
            self.stats.busy_lane_rounds += busy
            self.accept_ema = float(ys["ema"][r])
            if self.drafter is not None:
                self.drafter.enabled = use_spec
            self.policy.speculation.observe_round(
                int(active_after.sum()), self.accept_ema, use_spec)
            decision = Decision.NONE
            if self.controller is not None:
                decision = self.controller.observe_gated(
                    alpha, int(ys["n_sig"][r]))
                if self.extractor is not None:
                    self.extractor.enabled = \
                        self.controller.collection_enabled
            self._apply_capture_park()
            if (self.extractor is not None and self.extractor.enabled
                    and "sig_feats" in ys):
                if sig_np is None:
                    feats = ys["sig_feats"]
                    if feats.dtype == torch.bfloat16:
                        feats = feats.float()
                    sig_np = (self._host(feats), self._host(ys["sig_tokens"]),
                              self._host(ys["sig_counts"]))
                self.extractor.ingest_packed(
                    rids, sig_np[0][r], sig_np[1][r], sig_np[2][r])
            self.stats.timeline.append({
                "t": self._clock() - t0, "spec": use_spec,
                "accept_len": ell, "alpha": alpha,
                "decision": decision.value, "busy_lanes": busy,
            })
        return any_valid

    # ------------------------------------------ per-step reference loop
    def _stream_stepwise(self, sched, cache, dcache, carry, t0,
                         on_complete):
        b = self.batch
        slots = list(sched.slots)
        active = np.array([r is not None and r.finish_t is None
                           for r in slots], bool)
        while True:
            self._poll_deploy()
            admitted = self._retire_and_admit(sched, on_complete)
            if admitted:
                toks, pad, mask, src, _, _ = self._refill_arrays(admitted)
                rows, width = toks.shape
                self._note_prefill_op(rows, width)
                cache, dcache, tbl_rows = self._map_refill(
                    cache, dcache, admitted, rows, width)
                with self.tracer.span("refill", rows=int(rows),
                                      width=int(width)):
                    cache, dcache, carry_r, fdev = self._refill_core(
                        cache, dcache, toks, pad, mask, src, tbl_rows)
                    carry = spec.scatter_carry(carry, carry_r, mask, src)
                self.stats.refills += len(admitted)
                if self.paged:
                    self._publish_prefixes(self._prefix_entries(
                        admitted, int(rows), int(width)))
                first_np = self._host(fdev)
                for row, (slot, req) in enumerate(admitted):
                    self._commit_first(req, int(first_np[row]))
                    active[slot] = req.finish_t is None
                slots = list(sched.slots)
            if not active.any():
                if sched.has_work():
                    continue
                if sched.more_coming():
                    self._idle_tick(sched.next_arrival_in())
                    continue
                break
            use_spec = self.policy.speculation.step_decision(
                int(active.sum()), self.accept_ema)
            self.stats.dispatches += 1
            cache, dcache = self._ship_tables(cache, dcache)
            if use_spec:
                with self.tracer.span("step.dispatch", spec=True):
                    if self.tree_width:
                        out = spec.tree_decode_step(
                            self.cfg, self.dcfg, self.params, self.dparams,
                            cache, dcache, carry, gamma=self.gamma,
                            width=self.tree_width, greedy=self.greedy)
                    else:
                        out = spec.spec_decode_step(
                            self.cfg, self.dcfg, self.params, self.dparams,
                            cache, dcache, carry, gamma=self.gamma,
                            greedy=self.greedy)
                cache, dcache, carry = (out["cache"], out["dcache"],
                                        out["carry"])
                n_commit = self._host(out["n_commit"])
                toks_np = self._host(out["tokens"])
                # f32 arithmetic exactly as the superstep computes it
                na = np.float32(active.sum())
                ell32 = np.float32(
                    np.float32(n_commit[active].sum()) / na)
                alpha = float(np.float32(
                    np.float32((n_commit[active] - 1).sum()) / na)
                    / np.float32(self.gamma))
                ell = float(ell32)
                self.accept_ema = self._ema_step(self.accept_ema, ell32)
                self.stats.spec_steps += 1
            else:
                with self.tracer.span("step.dispatch", spec=False):
                    out = spec.plain_step_from_carry(
                        self.cfg, self.params, cache, carry,
                        gamma=self.gamma, greedy=self.greedy)
                cache, carry = out["cache"], out["carry"]
                n_commit = np.ones((b,), np.int32)
                toks_np = self._host(out["tokens"])
                alpha = 0.0
                ell = 1.0
            n_eff = np.zeros((b,), np.int32)
            eos_hit = np.zeros((b,), bool)
            for i, r in enumerate(slots):
                if r is None or not active[i]:
                    continue
                n = min(int(n_commit[i]),
                        max(r.max_new_tokens - len(r.generated), 0))
                if self.eos_id is not None:
                    eos_pos = np.flatnonzero(toks_np[i, :n] == self.eos_id)
                    if eos_pos.size:
                        n = int(eos_pos[0]) + 1
                        eos_hit[i] = True
                n_eff[i] = n
            self.policy.speculation.observe_round(
                int(active.sum()), self.accept_ema, use_spec)
            self._apply_capture_park()
            if self.extractor is not None:
                rids = [r.rid if r is not None else -1 for r in slots]
                mask = (np.arange(toks_np.shape[1])[None, :]
                        < n_eff[:, None])
                self.extractor.offer(rids, out["captures"], out["tokens"],
                                     mask)
            rec_on = self.recorder.enabled
            for i, r in enumerate(slots):
                if r is None or not active[i]:
                    continue
                r.generated.extend(int(t) for t in toks_np[i, :n_eff[i]])
                if rec_on and n_eff[i]:
                    self.recorder.note(r.rid, "commit",
                                       round_=self.stats.steps,
                                       n=int(n_eff[i]), spec=use_spec)
                if eos_hit[i] or r.done:
                    self._finish(r)
                    active[i] = False
            self.stats.tokens_out += int(n_eff.sum())
            self.stats.steps += 1
            self.stats.accept_len_sum += ell
            self.stats.accept_len_n += 1
            self.stats.lane_rounds += b
            busy = int((n_eff > 0).sum())
            self.stats.busy_lane_rounds += busy
            n_sig = int(n_commit[active].sum()) if active.any() else 0
            decision = Decision.NONE
            if self.controller is not None:
                decision = self.controller.observe_gated(alpha, n_sig)
                if self.extractor is not None:
                    self.extractor.enabled = \
                        self.controller.collection_enabled
            self.stats.timeline.append({
                "t": self._clock() - t0, "spec": use_spec,
                "accept_len": ell, "alpha": alpha,
                "decision": decision.value, "busy_lanes": busy,
            })
