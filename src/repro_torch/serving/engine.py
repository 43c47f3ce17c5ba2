"""TIDE serving engine, chain or draft-tree speculation, greedy or
sampled, dense or paged KV (port of ``repro/serving/engine.py``).

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
    prompt prefixes are shared copy-on-write at commit.  The pools live
    as long as the engine, so a prefix published in one ``serve_stream``
    stays valid in the next (the JAX engine makes new pools per stream
    but keeps its registry).
  * Tree speculation (``SpeculationPolicy(tree_width=W)``, which
    ``ServingConfig(tree_width=W)`` sets in the default policy): each
    speculative round drafts W branches of depth gamma and verifies them
    in one tree-masked target pass (``core.speculative.tree_decode_step``);
    W = 1 is the chain bit for bit.  Dense or paged KV: on a paged
    engine the verify attends through the block table in tree mode, the
    accepted branch is compacted through the table, and each lane
    reserves the tree's block of gamma * W + 1 rows (the chain reserves
    gamma + 1).
  * ``deploy_source``: a callable the superstep loop polls once a
    superstep (a host attribute read, no device sync), returning the
    training service's latest published ``DraftVersion``; a new version
    hot-swaps ``dparams`` for the next dispatch.  The pickup records the
    serving stream on every CUDA leaf of the new draft, whose blocks the
    training thread's stream allocated.
  * ``reseed_window=W`` (raised to gamma + 2): the superstep state keeps
    a per-lane ring of the last W (feature, token) pairs the draft cache
    ingested; at a deploy picked up in the superstep loop, one enqueued
    op (``eagle.reseed_draft_rows_from_ring``, or its ``_paged`` form
    through the block table) rebuilds the resident lanes' trailing draft
    K/V under the new draft, so its acceptance gain applies at once
    instead of at lane retirement.  The stepwise loop only swaps, as in
    JAX.
  * Sampled decoding (``greedy=False``, ``ServingConfig.seed``) draws
    JAX's numbers: lane keys are ``fold_in(fold_in(key(seed), sid),
    step)`` with ``sid`` the request's admission ordinal, in threefry
    words (``core/prng``) hashed and drawn by the sampling kernels
    (``kernels/sample``), so a sampled stream is per-request and
    scheduling-invariant (stream, wave, stepwise, superstep, dense,
    paged), and equal to JAX's token for token away from near-ties.
  * Chunked refill prefill (``ServingConfig(prefill_chunk=C)``, C a
    multiple of 8): each refill group (``Scheduler.refill_groups``, per
    padded-width bucket) becomes a chunk pipeline that prefills its
    prompts into dense staging caches, a ragged first chunk (the prefill
    kernel) then chunks of exactly C (a decode step at T = C: the verify
    kernel), one chunk a gap between supersteps, so no prefill op is
    wider than C.  Every product of a chunk, the draft seed's
    (``eagle.seed_chunk_pairs``) included, runs through ``linear_rows``,
    and a continuation's LM head runs on its last position only.  The
    last chunk is fused with its commit (first tokens, the staging rows
    into the live lanes, in place or through the block tables, and the
    lanes' state reset), and the first tokens ride the next telemetry
    pull.  Under ``commit="cohort"`` (``CohortCommit``) the pipelines of
    one admission batch commit together; ``"eager"`` (``EagerCommit``)
    commits each as it finishes.  With no lane decoding (the stream's
    start, empty supersteps) chunks run back to back.  A lane
    mid-prefill is inert for decode and keeps its rows out of the live
    caches until its commit; ``prefill_lane_rounds`` counts it apart
    from occupancy, and TTFT runs from admission.  A paged pipeline
    whose rows all hit the prefix registry gathers the covered chunks'
    rows from the shared pages (``_chunk_resume``) instead of
    prefilling them.  In the stepwise loop each pipeline commits as it
    finishes, as in JAX.
  * Overload (``ServingConfig(preempt="deadline", shed=...)``,
    superstep mode only for preemption): at each superstep boundary
    (``_overload_boundary``) the shed policy drops hopeless queued
    requests, and when the admission tier holds a tighter-deadline
    candidate against a full batch the preemption policy picks a loose
    resident lane to *spill*: one enqueued gather copies its whole
    serving state (every target-cache group, through its table row on a
    paged engine, the draft K/V, lengths and pad, the carry, activity,
    step and PRNG state, the capture ring, the remaining budget) into
    tensors of its own, which a ``paging.SpillStore`` parks on the
    device.  When a lane frees, the *restore* writes them back in place
    (through the lane's new table row), so the request resumes
    mid-stream on any lane, its stream equal to a never-evicted run.
    Neither op reads anything back to the host.  Unlike JAX's, a
    victim's lane is inert from its spill until its next owner's refill
    or commit, so a chunked refill into it does not take the victim's
    tokens while it prefills.
  * ``adopt_compiled`` (a fleet replica, ``repro_torch.fleet.router``):
    the eager port has no jitted step functions to share; it keeps JAX's
    checks, the same params object among them, and shares the constant
    base sampling key.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Callable, Iterable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint import bridge
from repro_torch.core import eagle, paging, prng, speculative as spec
from repro_torch.core.adaptive import AdaptiveDrafter
from repro_torch.core.controller import Decision, TrainingController
from repro_torch.core.signals import SignalExtractor
from repro_torch.kernels.linear_rows.ops import linear_rows
from repro_torch.kernels.sample import ops as sample
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.recorder import NULL_RECORDER
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.serving.policy import ServingConfig, ServingPolicy
from repro_torch.serving.request import Request, inert_request
from repro_torch.serving.scheduler import Scheduler
from repro_torch.serving.stats import P2Quantile, Ring

# sampling-stream id for lanes that never emit (inert padding, free slots);
# their draws are discarded
INERT_SID = 0x7FFFFFFF

_STATS_COUNTERS = (
    "tokens_out", "steps", "spec_steps", "dispatches", "refills",
    "idle_supersteps", "deploys", "reseeds", "completed", "accept_len_n",
    "lane_rounds", "busy_lane_rounds", "prefill_chunks",
    "prefill_lane_rounds", "prefill_row_tokens",
    "pages_peak", "prefix_hits", "prefix_tokens_saved",
    "admission_deferrals", "preemptions", "restores", "shed_requests",
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
    survive in ``Request.generated`` (the first token included).

    Chunked refill prefill: ``prefill_chunks`` counts chunk dispatches,
    ``prefill_lane_rounds`` the lane-rounds spent mid-prefill (inert for
    decode, left out of the occupancy denominator), and the
    ``prefill_gap_tokens`` histogram the prefill row-tokens of each
    inter-superstep gap (one-shot refills and the prologue too);
    ``prefill_op_width`` holds each prefill op's width."""

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
        self.prefill_gap_tokens = self.registry.histogram(
            "serving.prefill_gap_tokens", (0.5,), reset=True)
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
        """Fraction of decode-eligible lane-rounds that committed tokens;
        lanes still chunk-prefilling their prompt are busy with
        admission work, not idle, and are left out."""
        return self.busy_lane_rounds / max(
            self.lane_rounds - self.prefill_lane_rounds, 1)

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


class _ChunkPipeline:
    """Host bookkeeping of one in-flight chunked refill group.

    Holds the (slot, request) assignments, the padded prompt and lane-map
    tensors (as ``_refill_arrays`` builds them for a one-shot refill) and
    the staging target and draft caches the chunk ops extend.  The
    prompt is prefilled left to right: the first chunk is ragged
    (``width - (n_chunks - 1) * chunk``, a multiple of 8 in [8, chunk],
    so the last chunk ends exactly at ``width``), every later one is
    ``chunk`` wide."""

    def __init__(self, admitted, args, chunk: int, cohort: int = 0,
                 order: int = 0):
        (self.toks, self.pad, self.mask, self.src, self.budgets,
         self.sids) = args
        self.admitted = admitted
        self.rows = int(self.toks.shape[0])
        self.width = int(self.toks.shape[1])
        n_chunks = -(-self.width // chunk)
        self.first_width = self.width - (n_chunks - 1) * chunk
        self.chunk = chunk
        self.pos = 0            # prompt prefix already prefilled
        # the pipelines of one admission batch form a cohort: their
        # chunks run independently, but under CohortCommit they commit
        # together when the slowest finishes, so the lanes of one
        # admission activate in one gap, as a one-shot refill's do
        self.cohort = cohort
        self.order = order
        self.ready = False      # fully prefilled, waiting on its cohort
        self.cache = None       # staging target cache (rows x width)
        self.dcache = None      # staging draft cache (rows x max_len)
        self.logits = None      # last-position logits after the last chunk
        self.caps_last = None   # last capture column after the last chunk
        # paged prefix sharing (filled at spawn)
        self.resume_q = 0       # > 0: positions [0, q) come from the
        #                         shared pages in resume_rows
        self.resume_rows = None  # (rows, ceil(q / P)) shared page ids
        self.pub_entries = []   # (slot, provenance key, n_pages) to
        #                         publish at commit
        self.deploy_seq = 0     # draft version at spawn (a deploy
        #                         mid-pipeline makes its pages unshareable)

    @property
    def next_width(self) -> int:
        return self.first_width if self.pos == 0 else self.chunk

    @property
    def done(self) -> bool:
        return self.pos >= self.width


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
        if config.prefill_chunk < 0 or config.prefill_chunk % 8:
            raise ValueError(f"prefill_chunk {config.prefill_chunk} must "
                             "be a multiple of 8 (refill shape bucket)")
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
        # > 0: the superstep state keeps the capture ring, and a deploy
        # picked up in the superstep loop re-seeds the resident lanes'
        # draft cache from it
        self.reseed_window = (max(config.reseed_window, self.gamma + 2)
                              if config.reseed_window else 0)
        self._reseed_fn = (self._reseed if self.reseed_window
                           and self.superstep_rounds > 0 else None)
        self.gate_arrivals = config.gate_arrivals
        self.completion_sink = config.completion_sink
        self.idle_wait_s = config.idle_wait_s
        # > 0: chunked refill prefill; every refill (and the stream's
        # first batch) is prefilled in chunks that interleave with the
        # resident lanes' supersteps
        self.prefill_chunk = config.prefill_chunk
        self._pipelines: List[_ChunkPipeline] = []
        self._cohort_next = 0
        # parking lot of preempted lanes: each one's serving state,
        # gathered into device tensors of its own at a superstep
        # boundary, restored when a lane frees
        self._spills = paging.SpillStore()
        if self.policy.preemption.enabled and self.superstep_rounds <= 0:
            raise ValueError(
                "preemption requires superstep mode (superstep_rounds > "
                "0): spill/restore only runs at superstep boundaries")
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
        # constant base key of the per-request sampling streams: lane keys
        # are fold_in(fold_in(base, sid), step), sid the admission ordinal
        self._base_key = prng.key(config.seed, self.device)
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

    def _refill_core(self, cache, dcache, toks, pad, mask, src, sids,
                     tbl_rows=None):
        """Prefill a refill batch of R prompts and write their lanes into
        the live caches in place.  Paged: ``tbl_rows`` (R, n_tbl) holds
        each refill row's lane table row (all trash for a row no lane
        gathers), and the prefill writes the target K/V through it.
        ``sids`` (R,) are the rows' sampling-stream ids.  Returns (cache,
        dcache, the R-batch prefill carry, the R first tokens)."""
        if self.paged:
            pre = self._prefill(toks, pad, cache, tbl_rows)
        else:
            pre = self._prefill(toks, pad)
        first = self._pick(pre["logits"], sids)
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
            cache, dcache, toks, pad, mask, src, sids, tbl_rows)
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

    def _reseed(self, dparams, dcache, state):
        """Rebuild the ring-covered draft K/V rows of every lane under
        ``dparams``, in place (dense, or through the draft cache's block
        table), gamma + 1 columns at a time: the width of serving's draft
        extend, so the rows are the serving rows bit for bit."""
        ring = (state.cap_feats, state.cap_toks, state.cap_count)
        if self.paged:
            return eagle.reseed_draft_rows_from_ring_paged(
                self.dcfg, dparams, self.params["embed"], dcache, *ring,
                self.max_len, block=self.gamma + 1)
        return eagle.reseed_draft_rows_from_ring(
            self.dcfg, dparams, self.params["embed"], dcache, *ring,
            block=self.gamma + 1)

    # ------------------------------------------ preemption spill/restore
    # The spill gathers one lane's whole serving state into tensors of
    # its own: every op that touches a live buffer writes it in place,
    # so a view would change under the next refill of the lane.  The
    # restore writes a snapshot back into a free lane, in place; on a
    # paged engine through the lane's *new* table row, so the physical
    # pages may differ while the logical rows are equal.  Both are
    # enqueued behind the in-flight superstep and read nothing back.
    _STATE_LEAVES = ("active", "gen_count", "sid", "step_idx")
    _RING_LEAVES = ("cap_feats", "cap_toks", "cap_count")

    @staticmethod
    def _cache_leaves(cache):
        """(group, pos, leaf, tensor) of every target K/V leaf."""
        for g, v in cache.items():
            if g in ("lengths", "pad", "page_tbl"):
                continue
            for pos, entry in v.items():
                for leaf, t in entry.items():
                    yield g, pos, leaf, t

    def _spill(self, cache, dcache, state, max_new, lane: int):
        """Snapshot lane ``lane``: target rows (repeats, max_len, Hk, D)
        per leaf (through the lane's table row on a paged engine), draft
        K/V (max_len, Hk, D), both caches' lengths and pad, the carry,
        the per-lane superstep state, the capture ring when present, and
        the remaining budget.  Every tensor is a copy."""
        def take(t):
            return t[lane].clone()

        if self.paged:
            trow = cache["page_tbl"][lane].long()
            dtrow = dcache["tbl"][lane].long()

            def lane_rows(pool, row):
                # (..., NP + 1, P, Hk, D) -> (..., max_len, Hk, D)
                v = pool[..., row, :, :, :]
                return v.reshape(v.shape[:-4] + (-1,) + v.shape[-2:])

            rows = {(g, p, leaf): lane_rows(t, trow)
                    for g, p, leaf, t in self._cache_leaves(cache)}
            dk = lane_rows(dcache["k"], dtrow)
            dv = lane_rows(dcache["v"], dtrow)
        else:
            rows = {(g, p, leaf): t[:, lane].clone()
                    for g, p, leaf, t in self._cache_leaves(cache)}
            dk, dv = take(dcache["k"]), take(dcache["v"])
        st = {"feats": take(state.carry.feats),
              "tokens": take(state.carry.tokens),
              "advance": take(state.carry.advance)}
        for name in self._STATE_LEAVES:
            st[name] = take(getattr(state, name))
        if state.cap_feats is not None:
            for name in self._RING_LEAVES:
                st[name] = take(getattr(state, name))
        return {"cache": rows,
                "clen": take(cache["lengths"]), "cpad": take(cache["pad"]),
                "dk": dk, "dv": dv,
                "dlen": take(dcache["lengths"]),
                "dpad": take(dcache["pad"]),
                "state": st, "budget": take(max_new)}

    def _restore(self, cache, dcache, state, max_new, lane: int, sp):
        """Write a ``_spill`` snapshot into lane ``lane``, in place.  On a
        paged engine the rows go through the lane's shipped table row:
        rows past its re-reservation map the trash page (unmapped table
        entries hold its id), as JAX's ``page_slot`` routes them.
        Returns (cache, dcache, state, max_new)."""
        if self.paged:
            pos = torch.arange(self.max_len, device=self.device)[None]
            trash = self.num_pages
            page, slot = paging.page_slot(cache["page_tbl"][lane][None],
                                          self.page_size, pos, trash)
            for g, p, leaf, t in self._cache_leaves(cache):
                t[:, page[0], slot[0]] = sp["cache"][(g, p, leaf)]
            page, slot = paging.page_slot(dcache["tbl"][lane][None],
                                          self.page_size, pos, trash)
            dcache["k"][page[0], slot[0]] = sp["dk"]
            dcache["v"][page[0], slot[0]] = sp["dv"]
        else:
            for g, p, leaf, t in self._cache_leaves(cache):
                t[:, lane] = sp["cache"][(g, p, leaf)]
            dcache["k"][lane] = sp["dk"]
            dcache["v"][lane] = sp["dv"]
        cache["lengths"][lane] = sp["clen"]
        cache["pad"][lane] = sp["cpad"]
        dcache["lengths"][lane] = sp["dlen"]
        dcache["pad"][lane] = sp["dpad"]
        st = sp["state"]
        for name in ("feats", "tokens", "advance"):
            getattr(state.carry, name)[lane] = st[name]
        for name in self._STATE_LEAVES + (
                self._RING_LEAVES if state.cap_feats is not None else ()):
            getattr(state, name)[lane] = st[name]
        max_new[lane] = sp["budget"]
        return cache, dcache, state, max_new

    def _lane_keys(self, sids, steps):
        """Per-lane keys ``fold_in(fold_in(base, sid), step)``: the
        stepwise loop's twin of the superstep's in-loop derivation, the
        same two hashes.  sids, steps: (R,) device ints."""
        base = self._base_key[None].expand(sids.shape[0], 2)
        return sample.fold_in(sample.fold_in(base, sids), steps)

    def _pick(self, logits, sids):
        """A prefill's first token: greedy, the first maximal index (JAX's
        argmax); sampled, drawn at step 0 of each row's stream."""
        if self.greedy:
            return logits.argmax(-1).to(torch.int32)
        return sample.categorical_rows(
            self._lane_keys(sids, torch.zeros_like(sids)), logits)

    # ------------------------------------------ chunked refill ops
    # A chunked refill prefills its prompt chunk by chunk into a
    # *staging* cache pair that touches the live state only at commit,
    # so the resident lanes never wait for more than one chunk of
    # prefill per gap between supersteps.  The first chunk is a prefill
    # (the prefill kernel), a continuation is a decode step at T = C
    # (the verify kernel), and every product of both runs through
    # ``linear_rows``, the draft seed's included: a prompt's rows do not
    # depend on its pipeline's other rows.  On a paged engine the
    # staging caches stay dense, as in JAX, and the commit writes them
    # through the lanes' block tables; a lane mid-prefill is inert.
    def _chunk_start_core(self, toks_c, nxt, pad, adv, width: int):
        """First (ragged) chunk: fresh staging caches.  ``nxt`` holds the
        lookahead-shifted tokens of the draft pairs, ``adv`` (R,) the
        valid pair count.  The staging target cache is ``width`` (the
        pipeline's prompt width) long, so a continuation attends over the
        key width the one-shot prefill does (``spec.pad_target_cache``
        pads it at commit).  Returns (cache_s, dcache_s, logits (R, V),
        last capture (R, 3D))."""
        pre = T.prefill(self.cfg, self.params, toks_c, max_len=width,
                        pad=pad)
        dcache_s = eagle.init_draft_cache(self.dcfg, toks_c.shape[0],
                                          self.max_len, device=self.device)
        dcache_s["pad"] = pad.to(torch.int32, copy=True)
        dcache_s = eagle.seed_chunk_pairs(self.dcfg, self.dparams,
                                          self.params["embed"], dcache_s,
                                          pre["captures"], nxt, adv)
        return (pre["cache"], dcache_s, pre["logits"],
                pre["captures"][:, -1])

    def _chunk_cont_core(self, cache_s, dcache_s, toks_c, nxt, adv):
        """Continuation chunk: extend the staging caches, in place,
        through the decode path at positions [pos, pos + C), the LM head
        on the last position only."""
        r, w = toks_c.shape
        out = T.decode_step(self.cfg, self.params, cache_s, toks_c,
                            linear=linear_rows, last_only=True)
        cache_s = T.commit_cache(self.cfg, out["cache"], torch.full(
            (r,), w, dtype=torch.int32, device=self.device))
        dcache_s = eagle.seed_chunk_pairs(self.dcfg, self.dparams,
                                          self.params["embed"], dcache_s,
                                          out["captures"], nxt, adv)
        return cache_s, dcache_s, out["logits"], out["captures"][:, -1]

    def _chunk_scatter_core(self, pl: "_ChunkPipeline", cache, dcache):
        """The commit both loops share (the chunked twin of
        ``_refill_core``'s output side): pick the pipeline's first tokens
        (``_pick``), pad its staging target cache to the live geometry
        (dense), write both staging caches into the masked live lanes in
        place (through the block tables on a paged engine) and build the
        refill carry.  Returns (cache, dcache, carry_r, first)."""
        first = self._pick(pl.logits, pl.sids)
        cache_s = spec.pad_target_cache(
            pl.cache, None if self.paged else self.max_len)
        if self.paged:
            spec.scatter_target_cache_paged(cache, cache_s, pl.mask, pl.src)
            eagle.scatter_draft_rows_paged(dcache, pl.dcache, pl.mask,
                                           pl.src)
        else:
            spec.scatter_target_cache(cache, cache_s, pl.mask, pl.src)
            eagle.scatter_draft_rows(dcache, pl.dcache, pl.mask, pl.src)
        carry_r = spec.init_carry_from_caps(pl.caps_last, first, self.gamma)
        return cache, dcache, carry_r, first

    def _chunk_commit(self, pl: "_ChunkPipeline", cache, dcache, state,
                      max_new):
        """Commit a fully prefilled pipeline into the live state and reset
        its lanes' superstep state (the chunked twin of
        ``_refill_superstep``).  Returns (cache, dcache, state, max_new,
        first)."""
        cache, dcache, carry_r, first = self._chunk_scatter_core(
            pl, cache, dcache)
        state = spec.refill_superstep_state(
            state, carry_r, first, pl.budgets, pl.mask, pl.src,
            eos_id=self.eos_id, sids=pl.sids)
        max_new = torch.where(pl.mask, pl.budgets[pl.src.long()], max_new)
        return cache, dcache, state, max_new, first

    def _chunk_commit_step(self, pl: "_ChunkPipeline", cache, dcache,
                           carry):
        """A finished pipeline's commit in the per-step reference loop,
        through the same ``_chunk_scatter_core``, so the loops cannot
        drift.  Returns (cache, dcache, carry, first)."""
        cache, dcache, carry_r, first = self._chunk_scatter_core(
            pl, cache, dcache)
        carry = spec.scatter_carry(carry, carry_r, pl.mask, pl.src)
        return cache, dcache, carry, first

    def _chunk_resume(self, width: int, q: int, cache, dcache, tbl_rows,
                      pad):
        """Staging caches whose positions [0, q) are gathered from shared
        prefix pages (``tbl_rows`` (R, ceil(q / P)) page ids, a row per
        staging row; ``paging.gather_rows_paged``): the paged engine's
        replacement for the prefix's chunks.  Returns (cache_s,
        dcache_s)."""
        r = tbl_rows.shape[0]
        cache_s = T.init_cache(self.cfg, r, width, device=self.device)
        for g, v in cache_s.items():
            if g in ("lengths", "pad"):
                continue
            for pos, entry in v.items():
                for leaf, t in entry.items():
                    pools = cache[g][pos][leaf]
                    for i in range(t.shape[0]):
                        t[i, :, :q] = paging.gather_rows_paged(
                            pools[i], tbl_rows, q)
        dcache_s = eagle.init_draft_cache(self.dcfg, r, self.max_len,
                                          device=self.device)
        for leaf in ("k", "v"):
            dcache_s[leaf][:, :q] = paging.gather_rows_paged(
                dcache[leaf], tbl_rows, q)
        for c in (cache_s, dcache_s):
            c["lengths"] = torch.full((r,), q, dtype=torch.int32,
                                      device=self.device)
            c["pad"] = pad.to(torch.int32, copy=True)
        return cache_s, dcache_s

    # ------------------------------------------------------------- fleet
    def adopt_compiled(self, donor: "ServingEngine"):
        """Share what a fleet replica (``repro_torch.fleet.router``) can
        share with ``donor``.  JAX's engine shares its jitted step
        functions here; the eager port compiles none, and derives no
        state from the params, so what it shares is the params object
        itself (checked: N glm4-9b replicas hold one 18.8 GB target) and
        the constant base sampling key.  JAX's checks stay: the same
        model and draft configs, an equal ``ServingConfig`` minus the
        per-replica ``completion_sink`` (an equal seed gives an equal
        base key, so sampled streams stay request-keyed and
        replica-invariant), and the same params object."""
        if donor is self:
            return
        mine = dataclasses.replace(self.config, completion_sink=None)
        theirs = dataclasses.replace(donor.config, completion_sink=None)
        if (self.cfg != donor.cfg or self.dcfg != donor.dcfg
                or mine != theirs):
            raise ValueError("adopt_compiled needs identically-configured "
                             "engines (model, draft, ServingConfig)")
        if self.params is not donor.params:
            raise ValueError("adopt_compiled needs the shared params "
                             "object (one copy of the target per fleet)")
        self._base_key = donor._base_key

    # ------------------------------------------------------------- deploy
    def deploy_draft(self, dparams):
        """Hot-swap the draft (no target reload, TIDE's C2).  Under
        ``serve_stream`` the swap lands between supersteps, mid-stream.

        Caveat: without a capture ring (``reseed_window=0``), lanes
        resident at swap time keep draft-cache K/V built by the *old*
        draft until they retire.  Token streams stay correct (the target
        verifies every draft), but those lanes' acceptance length may dip
        until refilled.  With ``reseed_window>0`` the engine re-seeds
        resident lanes' trailing draft K/V from the rolling capture ring
        when the superstep loop picks a deploy up, so the new draft's
        acceptance gain applies at once."""
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
        # the training thread's stream allocated these leaves: when this
        # engine drops them, their blocks must wait for the serving
        # kernels queued on this stream before the allocator reuses them
        for t in bridge.flat(ver.dparams).values():
            if t.is_cuda:
                t.record_stream(torch.cuda.current_stream(t.device))
        self.dparams = ver.dparams
        self.stats.deploys += 1
        if self.tracer.enabled:
            self.tracer.instant("deploy", seq=ver.seq)
        if self.recorder.enabled:
            self.recorder.global_event("deploy", round_=self.stats.steps,
                                       seq=ver.seq)
        return ver

    def reset_adaptation(self, dparams):
        """Back to the post-construction adaptive state: draft params,
        acceptance EMA, deploy and sid counters, the page allocator,
        stats, the chunk pipelines, the spill store and the speculation
        policy, as in JAX."""
        self.dparams = dparams
        self.accept_ema = 1.0
        self._deploy_seq = 0
        self._sid_next = 0
        self._pipelines = []
        self._cohort_next = 0
        self._spills = paging.SpillStore()
        if self.allocator is not None:
            self.allocator.reset()
        self.stats = ServingStats(registry=self.metrics)
        self.policy.speculation.reset()
        if self.drafter is not None:
            self.drafter.enabled = True

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
        reg.gauge("serving.spilled_requests", fn=lambda: len(self._spills))
        if self.allocator is not None:
            self.allocator.register_metrics(reg)
        else:
            # dense engines expose the namespace too (all zero)
            for name in ("pages_in_use", "pages_free", "pages_peak",
                         "prefix_hits", "prefix_tokens_saved", "evictions",
                         "cow_forks", "spilled_pages"):
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
        sids_t = self._t(self._slot_sids(requests), torch.int32)
        self._note_prefill_op(b, plen)
        self.stats.prefill_gap_tokens.add(b * plen)
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
                sids_t, self._tbl_rows(list(enumerate(requests)), b))
            self._publish_prefixes(self._prefix_entries(group, b, plen))
            return cache, dcache, carry, first
        pre = self._prefill(toks_t, pad_t)
        first = self._pick(pre["logits"], sids_t)
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
        cold = bool(self.prefill_chunk)
        if cold:
            # chunked: no one-shot prologue; the first batch flows
            # through the same chunk pipelines as every later refill
            cache, dcache, carry, first = self._empty_state()
            self._pipelines = []
            self._spawn_pipelines(admitted)
        else:
            with self.tracer.span("prefill.prologue", rows=self.batch):
                cache, dcache, carry, first = self._prologue(reqs0)
            first_np = self._host(first)
            for i, r in enumerate(reqs0):
                self._commit_first(r, int(first_np[i]))
        if self.superstep_rounds > 0:
            self._stream_superstep(sched, reqs0, cache, dcache, carry,
                                   first, t0, on_complete, cold=cold)
        else:
            self._stream_stepwise(sched, cache, dcache, carry, t0,
                                  on_complete, cold=cold)
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
        self._shed_queue(sched, on_complete)
        admitted = sched.admit()
        self._assign_sids(admitted)
        return admitted

    # ------------------------------------------- overload boundary
    # One host pass per superstep boundary: retire finished lanes, drop
    # spill entries that finished from in-flight telemetry, shed hopeless
    # queue entries, restore spilled requests whose effective deadline
    # beats the queue head, admit, preempt-and-admit while the admission
    # tier holds a tighter candidate against a full batch, then hand the
    # free lanes left to the remaining spilled requests.  No added host
    # sync: spills and restores are enqueued behind the in-flight
    # superstep.
    def _overload_boundary(self, sched: Scheduler, on_complete, cache,
                           dcache, state, max_new):
        """Superstep-mode twin of ``_retire_and_admit`` that also runs
        the spill/restore and preemption machinery.  Returns (cache,
        dcache, state, max_new, the new (slot, request) refills)."""
        if self.paged:
            self._free_finished_lanes(sched)
        for r in sched.release_finished():
            if on_complete is not None:
                on_complete(r)
        if self._spills:
            self._drop_finished_spills(sched, on_complete)
        self._shed_queue(sched, on_complete)
        if self._spills:
            cache, dcache, state, max_new = self._restore_spilled(
                sched, cache, dcache, state, max_new, rank_queue=True)
        admitted = sched.admit()
        if self.policy.preemption.enabled and sched.has_pending():
            admitted += self._preempt_admit(
                sched, cache, dcache, state, max_new,
                {id(r) for _, r in admitted})
        if self._spills:
            cache, dcache, state, max_new = self._restore_spilled(
                sched, cache, dcache, state, max_new, rank_queue=False)
        self._assign_sids(admitted)
        return cache, dcache, state, max_new, admitted

    def _shed_queue(self, sched: Scheduler, on_complete):
        """Load shedding: the shed policy's picks among the arrived queue
        finish at once with nothing generated, flagged ``shed``, and
        route through the completion path.  The default ``none`` policy
        never touches the scheduler."""
        pol = self.policy.preemption.shed
        if pol.name == "none":
            return
        victims = pol.pick(sched.queue_view(), self.stats.steps)
        if not victims:
            return
        for r in victims:
            r.shed = True
            self.stats.shed_requests += 1
            self._finish(r)
        sched.shed(victims)
        for r in victims:
            if on_complete is not None:
                on_complete(r)

    def _drop_finished_spills(self, sched: Scheduler, on_complete):
        """A spilled request can finish *while parked*: the superstep in
        flight at spill time still carried its lane, so its last tokens
        commit from that superstep's telemetry.  Its pages were freed at
        the spill; drop the entry and route the request to completion
        once."""
        for e in list(self._spills.pending()):
            if e.request.finish_t is not None:
                self._spills.drop(e.request.rid)
                sched.retire(e.request)
                if on_complete is not None:
                    on_complete(e.request)

    @staticmethod
    def _edl(r: Request):
        """Effective-deadline sort key (tightest first), the order the
        preemption policy victimizes in reverse."""
        return (r.deadline if r.deadline is not None else float("inf"),
                -r.priority)

    def _restore_spilled(self, sched: Scheduler, cache, dcache, state,
                         max_new, *, rank_queue: bool):
        """Move spilled requests back onto free lanes, tightest first.
        With ``rank_queue`` (the pass before admission) only entries at
        least as tight as the queue head may claim a lane, so a restore
        never starves a tighter queued candidate; the pass after
        admission hands out the lanes still free.  A restored lane
        resumes mid-stream where it left off."""
        free = [i for i, s in enumerate(sched.slots) if s is None]
        if not free or not self._spills:
            return cache, dcache, state, max_new
        entries = sorted(self._spills.pending(),
                         key=lambda e: self._edl(e.request))
        if rank_queue:
            head = sched.peek_next()
            if head is not None:
                hd = self._edl(head)
                entries = [e for e in entries if self._edl(e.request) <= hd]
        for slot in free:
            if not entries:
                break
            e = entries[0]
            if self.paged:
                if not self.allocator.reserve(slot,
                                              e.pages * self.page_size):
                    break        # pool pressure: the entry stays parked
                self._sync_paged_stats()
                # the restore writes through the lane's new table row
                cache, dcache = self._ship_tables(cache, dcache)
            entries.pop(0)
            self._spills.pop(e.request.rid)
            with self.tracer.span("preempt.restore", rid=e.request.rid,
                                  slot=slot):
                cache, dcache, state, max_new = self._restore(
                    cache, dcache, state, max_new, slot, e.slices)
            sched.slots[slot] = e.request
            self.stats.restores += 1
            if self.recorder.enabled:
                self.recorder.note(e.request.rid, "restore",
                                   round_=self.stats.steps, slot=slot)
        return cache, dcache, state, max_new

    def _victim_candidates(self, sched: Scheduler, new_ids):
        """Residents eligible for preemption: decoding lanes only, never
        this boundary's admissions (their refill is not built yet) and
        never lanes mid-chunk-prefill (their rows live in a pipeline's
        staging caches, not the live buffers)."""
        in_pipe = {id(r) for pl in self._pipelines for _, r in pl.admitted}
        out = []
        for slot, r in enumerate(sched.slots):
            if r is None or r.finish_t is not None:
                continue
            if id(r) in new_ids or id(r) in in_pipe:
                continue
            if r.first_token_t is None:
                continue
            out.append((slot, r))
        return out

    def _spill_victim(self, sched: Scheduler, slot: int, cache, dcache,
                      state, max_new):
        """Evict one resident lane into the spill store.  The gather reads
        the bindings after the in-flight superstep, whose tokens for this
        lane commit at the next drain through the pending record's
        request reference, so the snapshot and the host stream stay in
        phase."""
        req = sched.slots[slot]
        with self.tracer.span("preempt.spill", rid=req.rid, slot=slot):
            slices = self._spill(cache, dcache, state, max_new, slot)
            # the lane is inert until its next owner's refill or commit:
            # under chunked refill its new owner prefills for a few
            # supersteps, and a lane left active would go on decoding the
            # victim's stream into the new owner's (the JAX engine leaves
            # it active; ROADMAP, Reference state)
            state.active[slot] = False
        pages = 0
        if self.paged:
            pages = self.allocator.spill_lane(slot)
        self._spills.put(paging.SpilledLane(req, slices, pages))
        sched.evict(slot)
        req.evictions += 1
        self.stats.preemptions += 1
        if self.recorder.enabled:
            self.recorder.note(req.rid, "preempt",
                               round_=self.stats.steps, slot=slot)

    def _preempt_admit(self, sched: Scheduler, cache, dcache, state,
                       max_new, new_ids):
        """Deadline preemption: while the batch is full and the admission
        tier holds a candidate, ask the policy for a victim among the
        residents, spill it and admit into its slot.  Stops when the
        policy declines or the admission guard defers the candidate."""
        pol = self.policy.preemption
        out: List[Tuple[int, Request]] = []
        evicted = 0
        while (sched.has_pending() and evicted < self.batch
               and all(s is not None for s in sched.slots)):
            cand = sched.peek_next()
            if cand is None:
                break
            victim = pol.select_victim(
                cand, self._victim_candidates(sched, new_ids),
                self.stats.steps)
            if victim is None:
                break
            self._spill_victim(sched, victim, cache, dcache, state,
                               max_new)
            evicted += 1
            got = sched.admit()
            if not got:
                break       # guard deferred: the lane stays free for a restore
            out += got
            new_ids |= {id(r) for _, r in got}
        return out

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

    def _try_adopt(self, pl: _ChunkPipeline,
                   group: List[Tuple[int, Request]]):
        """Prefix-registry probe at pipeline spawn: when every row's
        provenance key hits, the pipeline skips the chunks the shared
        pages cover (``_resume_pipeline`` seeds its staging from them:
        no prefill row-tokens) and resumes at the next chunk boundary.
        The lane keeps its own reservation; page dedup happens at commit
        (``_publish_pipeline``), so decode's writes to a lane mid-prefill
        never land in shared pages."""
        pl.deploy_seq = self._deploy_seq
        pl.pub_entries = self._prefix_entries(group, pl.rows, pl.width)
        if not pl.pub_entries:
            return
        m = (pl.width - 1) // self.page_size
        hits = []
        for _, key, _ in pl.pub_entries:
            hit = self.allocator.lookup(key)
            if hit is None:
                return
            hits.append(hit[:m])
        # the last chunk boundary the shared pages cover, strictly inside
        # the prompt (one chunk always remains, to make the logits and
        # the last capture)
        q, b = 0, pl.first_width
        while b < pl.width:
            if b <= m * self.page_size:
                q = b
            b += pl.chunk
        if q <= 0:
            return
        mq = -(-q // self.page_size)
        rows = [h[:mq] for h in hits]
        rows += [rows[0]] * (pl.rows - len(rows))   # pow2 padding rows
        pl.resume_q = q
        pl.resume_rows = np.asarray(rows, np.int32)
        self.allocator.prefix_hits += len(group)
        self.allocator.prefix_tokens_saved += len(group) * q
        self._sync_paged_stats()

    def _resume_pipeline(self, pl: _ChunkPipeline, cache, dcache):
        """Seed a spawn-time registry hit's staging caches from the shared
        pages, in the spawn's gap: every op that could rewrite those
        pages is queued after it on the one stream."""
        pl.cache, pl.dcache = self._chunk_resume(
            pl.width, pl.resume_q, cache, dcache,
            paging.to_device(pl.resume_rows, self.device), pl.pad)
        pl.pos = pl.resume_q
        pl.resume_q = 0

    def _publish_pipeline(self, pl: _ChunkPipeline):
        """Commit-time publish and dedup of one pipeline's prefixes,
        skipped when a draft deploy landed mid-pipeline (its draft pages
        then mix two drafts' rows and match no provenance key)."""
        if self.allocator is None or self._deploy_seq != pl.deploy_seq:
            return
        self._publish_prefixes(pl.pub_entries)

    # ------------------------------------------- chunked refill pipeline
    def _make_pipeline(self, admitted, cohort: int = 0,
                       order: int = 0) -> _ChunkPipeline:
        return _ChunkPipeline(admitted, self._refill_arrays(admitted),
                              self.prefill_chunk, cohort, order)

    def _spawn_pipelines(self, admitted):
        """One chunk pipeline per refill group of the admission batch
        (``CommitPolicy.refill_groups``: per padded-width bucket by
        default), all of one commit cohort."""
        cohort = self._cohort_next
        self._cohort_next += 1
        for i, group in enumerate(self.policy.commit.refill_groups(
                admitted, self.prefill_chunk)):
            pl = self._make_pipeline(group, cohort, i)
            if self.paged:
                self._reserve_group(group, pl.width)
                self._try_adopt(pl, group)
            self._pipelines.append(pl)

    def _chunk_args(self, pl: _ChunkPipeline):
        """The pipeline's next chunk: (width, tokens, lookahead-shifted
        draft-pair tokens, (R,) valid pair count)."""
        w = pl.next_width
        a, b = pl.pos, pl.pos + w
        toks_c = pl.toks[:, a:b].contiguous()
        # draft pairs are (capture i, token i + 1); pair width - 1 does
        # not exist, so the last chunk ingests one fewer
        adv = min(w, pl.width - 1 - a)
        nxt = pl.toks[:, a + 1:b + 1]
        if nxt.shape[1] < w:
            nxt = torch.nn.functional.pad(nxt, (0, w - nxt.shape[1]))
        return w, toks_c, nxt.contiguous(), torch.full(
            (pl.rows,), adv, dtype=torch.int32, device=self.device)

    def _advance_pipeline(self, pl: _ChunkPipeline,
                          fused_commit: bool = False) -> int:
        """Run the next chunk of one pipeline.  ``fused_commit``: the
        pipeline's last chunk, whose commit runs right after it in the
        same gap (JAX fuses the two into one op; the trace marks the
        chunk as JAX does).  Returns its row-token cost."""
        w, toks_c, nxt, adv = self._chunk_args(pl)
        span = dict(rows=pl.rows, width=w)
        if fused_commit:
            span["fused_commit"] = True
        with self.tracer.span("prefill.chunk", **span):
            if pl.pos == 0:
                pl.cache, pl.dcache, pl.logits, pl.caps_last = \
                    self._chunk_start_core(toks_c, nxt, pl.pad, adv,
                                           pl.width)
            else:
                pl.cache, pl.dcache, pl.logits, pl.caps_last = \
                    self._chunk_cont_core(pl.cache, pl.dcache, toks_c,
                                          nxt, adv)
        pl.pos += w
        self.stats.prefill_chunks += 1
        self._note_prefill_op(pl.rows, w)
        self._obs_chunk(pl, w)
        return pl.rows * w

    def _obs_chunk(self, pl: _ChunkPipeline, w: int):
        """Flight-recorder note for one chunk (each member request
        advanced ``w`` columns)."""
        if self.recorder.enabled:
            for _, req in pl.admitted:
                self.recorder.note(req.rid, "prefill_chunk",
                                   round_=self.stats.steps, pos=pl.pos,
                                   width=w)

    def _advance_pipelines_ss(self, cache, dcache, state, max_new, pending):
        """Advance every pipeline by one chunk, with cohort commits.

        Pass 1, chunks: each pipeline not yet staged runs its next
        chunk.  A pipeline that commits alone (eager, or the only one of
        its cohort left) commits right after its last chunk; one with
        cohort siblings stages it and waits (``ready``).
        Pass 2, cohorts: a cohort whose pipelines are all staged commits
        them in admission order in this gap, so the lanes of one
        admission activate together.

        Committed first tokens ride the pending telemetry record; with
        none in flight (the stream's start) they are read at once.
        Returns (cache, dcache, state, max_new, row-token cost, commits)."""
        gap_tokens = 0
        commits = 0
        committed = []
        cache, dcache = self._ship_tables(cache, dcache)

        def emit_first(fdev, pl):
            if pending is not None:
                pending["refills"].append((fdev, pl.admitted))
            else:
                first_np = self._host(fdev)
                for row, (_, req) in enumerate(pl.admitted):
                    self._commit_first(req, int(first_np[row]))

        for pl in self._pipelines:
            if pl.ready:
                continue
            if pl.resume_q and pl.pos == 0:
                self._resume_pipeline(pl, cache, dcache)
            if pl.pos + pl.next_width < pl.width:      # interior chunk
                gap_tokens += self._advance_pipeline(pl)
                continue
            solo = (not self.policy.commit.cohort
                    or not any(q.cohort == pl.cohort and q is not pl
                               for q in self._pipelines))
            if not solo:
                # last chunk, siblings still prefilling: stage and wait
                gap_tokens += self._advance_pipeline(pl)
                pl.ready = True
                continue
            gap_tokens += self._advance_pipeline(pl, fused_commit=True)
            cache, dcache, state, max_new, fdev = self._chunk_commit(
                pl, cache, dcache, state, max_new)
            self.stats.refills += len(pl.admitted)
            commits += 1
            committed.append(pl)
            emit_first(fdev, pl)
            self._publish_pipeline(pl)

        cohorts = {}
        for pl in self._pipelines:
            if pl not in committed:
                cohorts.setdefault(pl.cohort, []).append(pl)
        for members in cohorts.values():
            if not all(q.ready for q in members):
                continue
            for q in sorted(members, key=lambda q: q.order):
                with self.tracer.span("prefill.commit", rows=q.rows):
                    cache, dcache, state, max_new, fdev = \
                        self._chunk_commit(q, cache, dcache, state, max_new)
                self.stats.refills += len(q.admitted)
                commits += 1
                committed.append(q)
                emit_first(fdev, q)
                self._publish_pipeline(q)
        self._pipelines = [pl for pl in self._pipelines
                           if pl not in committed]
        return cache, dcache, state, max_new, gap_tokens, commits

    def _advance_pipelines_step(self, cache, dcache, carry, active, sids,
                                steps):
        """The per-step reference loop's advance: one chunk a pipeline;
        a finished pipeline commits into the live carry at once and
        updates the host lane masks in place."""
        gap_tokens = 0
        live = []
        cache, dcache = self._ship_tables(cache, dcache)
        for pl in self._pipelines:
            if pl.resume_q and pl.pos == 0:
                self._resume_pipeline(pl, cache, dcache)
            gap_tokens += self._advance_pipeline(pl)
            if not pl.done:
                live.append(pl)
                continue
            cache, dcache, carry, fdev = self._chunk_commit_step(
                pl, cache, dcache, carry)
            self.stats.refills += len(pl.admitted)
            self._publish_pipeline(pl)
            first_np = self._host(fdev)
            for row, (slot, req) in enumerate(pl.admitted):
                self._commit_first(req, int(first_np[row]))
                active[slot] = req.finish_t is None
                sids[slot] = req.sid
                steps[slot] = 1
        self._pipelines = live
        return cache, dcache, carry, gap_tokens

    def _empty_state(self):
        """All-inert serving state for a chunked stream's start: zero
        caches (the engine's pools on a paged engine) and a unit carry.
        Every lane stays inactive until its pipeline's commit."""
        b = self.batch
        if self.paged:
            cache, dcache = self._paged_caches()
        else:
            cache = T.init_cache(self.cfg, b, self.max_len,
                                 device=self.device)
            dcache = eagle.init_draft_cache(self.dcfg, b, self.max_len,
                                            device=self.device)
        carry = spec.SpecCarry(
            feats=torch.zeros((b, self.gamma + 1, 3 * self.cfg.d_model),
                              dtype=self.cfg.act_dtype, device=self.device),
            tokens=torch.zeros((b, self.gamma + 1), dtype=torch.int32,
                               device=self.device),
            advance=torch.ones((b,), dtype=torch.int32, device=self.device))
        first = torch.zeros((b,), dtype=torch.int32, device=self.device)
        return cache, dcache, carry, first

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
                          t0, on_complete, cold=False):
        if cold:
            # chunked start: every lane is inert until its commit
            max_new = torch.zeros((self.batch,), dtype=torch.int32,
                                  device=self.device)
            active0 = torch.zeros((self.batch,), dtype=torch.bool,
                                  device=self.device)
        else:
            max_new = self._t([r.max_new_tokens for r in reqs0],
                              torch.int32)
            active0 = self._t([r.finish_t is None for r in reqs0],
                              torch.bool)
        state = spec.init_superstep_state(
            carry, first, self._base_key, accept_ema=self.accept_ema,
            eos_id=self.eos_id,
            active0=active0, sids=self._t(self._slot_sids(reqs0),
                                          torch.int32),
            capture_window=self.reseed_window)
        if cold and self._pipelines:
            # the first pipelines take the prologue's place; no lane
            # decodes yet, so chunks run back to back to the first commit
            gap, commits = 0, 0
            while self._pipelines and commits == 0:
                cache, dcache, state, max_new, g, commits = \
                    self._advance_pipelines_ss(cache, dcache, state,
                                               max_new, None)
                gap += g
            if gap:
                self.stats.prefill_gap_tokens.add(gap)
        # one-superstep double buffer, as in the reference: superstep t+1
        # is dispatched before t's telemetry is unpacked; refills
        # scheduled from t's unpack enter behind t+1
        pending = None
        stall = 0
        while True:
            # a deploy is a reference rebind; the re-seed is one enqueued
            # op on the resident lanes' draft cache (through the current
            # tables: a lane freed since the last ship maps only trash)
            ver = self._poll_deploy()
            if ver is not None and self._reseed_fn is not None:
                cache, dcache = self._ship_tables(cache, dcache)
                with self.tracer.span("reseed", seq=ver.seq):
                    dcache = self._reseed_fn(self.dparams, dcache, state)
                self.stats.reseeds += 1
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
                                          "n_prefill": sum(
                                              len(p.admitted)
                                              for p in self._pipelines),
                                          "refills": []}
                dispatched = True
            else:
                prev, pending = pending, None
            if prev is None:
                if not dispatched:
                    wait = sched.next_arrival_in()
                    if wait is None and not sched.more_coming():
                        if self._spills:
                            # unreachable by construction: every free
                            # lane is offered to the spill store at each
                            # boundary before the loop can go idle
                            raise RuntimeError(
                                f"{len(self._spills)} spilled requests "
                                "were never restored")
                        break
                    self._idle_tick(wait)
                continue
            with self.tracer.span("superstep.unpack"):
                progressed = self._drain(prev, t0)
            n_restores0 = self.stats.restores
            cache, dcache, state, max_new, admitted = \
                self._overload_boundary(sched, on_complete, cache, dcache,
                                        state, max_new)
            gap_tokens = 0
            if admitted and self.prefill_chunk:
                # chunked: new pipelines, whose first chunks run in the
                # advance below, in the refill op's place
                self._spawn_pipelines(admitted)
            elif admitted:
                args = self._refill_arrays(admitted)
                rows, width = args[0].shape
                self._note_prefill_op(rows, width)
                gap_tokens += int(rows) * int(width)
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
            if self._pipelines:
                cache, dcache, state, max_new, gap, commits = \
                    self._advance_pipelines_ss(cache, dcache, state,
                                               max_new, pending)
                gap_tokens += gap
                # the drained superstep was empty (no lane decoding):
                # nothing to interleave with, so run the pipelines to the
                # next commit instead of one chunk per empty dispatch
                while self._pipelines and not progressed and commits == 0:
                    cache, dcache, state, max_new, gap, commits = \
                        self._advance_pipelines_ss(cache, dcache, state,
                                                   max_new, pending)
                    gap_tokens += gap
            if gap_tokens:
                self.stats.prefill_gap_tokens.add(gap_tokens)
            stall = 0 if (progressed or admitted or gap_tokens
                          or self.stats.restores > n_restores0) \
                else stall + 1
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
        progressed = self._unpack_superstep(ys, rec["slots"], rids, t0,
                                            rec.get("n_prefill", 0))
        for fdev, admitted in rec["refills"]:
            first_np = self._host(fdev)
            for row, (_, req) in enumerate(admitted):
                self._commit_first(req, int(first_np[row]))
        return progressed

    def _unpack_superstep(self, ys, requests, rids, t0,
                          n_prefill: int = 0) -> bool:
        """Replay one superstep's host-side bookkeeping from its
        telemetry: token commit, stats/timeline, the Algorithm 1
        controller and packed-signal ingestion.  ``n_prefill``: the lanes
        mid-chunk-prefill at dispatch (inert, counted apart)."""
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
            self.stats.prefill_lane_rounds += n_prefill
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
                         on_complete, cold=False):
        b = self.batch
        slots = list(sched.slots)
        active = (np.zeros((b,), bool) if cold else
                  np.array([r is not None and r.finish_t is None
                            for r in slots], bool))
        # host twin of the superstep's (sid, step_idx) state
        sids = self._slot_sids(slots)
        steps = np.ones((b,), np.int32)
        if cold and self._pipelines:
            cache, dcache, carry, gap = self._advance_pipelines_step(
                cache, dcache, carry, active, sids, steps)
            if gap:
                self.stats.prefill_gap_tokens.add(gap)
        while True:
            self._poll_deploy()
            admitted = self._retire_and_admit(sched, on_complete)
            if admitted and self.prefill_chunk:
                self._spawn_pipelines(admitted)
                slots = list(sched.slots)
            elif admitted:
                toks, pad, mask, src, _, rsids = self._refill_arrays(admitted)
                rows, width = toks.shape
                self._note_prefill_op(rows, width)
                self.stats.prefill_gap_tokens.add(int(rows) * int(width))
                cache, dcache, tbl_rows = self._map_refill(
                    cache, dcache, admitted, rows, width)
                with self.tracer.span("refill", rows=int(rows),
                                      width=int(width)):
                    cache, dcache, carry_r, fdev = self._refill_core(
                        cache, dcache, toks, pad, mask, src, rsids, tbl_rows)
                    carry = spec.scatter_carry(carry, carry_r, mask, src)
                self.stats.refills += len(admitted)
                if self.paged:
                    self._publish_prefixes(self._prefix_entries(
                        admitted, int(rows), int(width)))
                first_np = self._host(fdev)
                for row, (slot, req) in enumerate(admitted):
                    self._commit_first(req, int(first_np[row]))
                    active[slot] = req.finish_t is None
                    sids[slot] = req.sid
                    steps[slot] = 1
                slots = list(sched.slots)
            if self._pipelines:
                cache, dcache, carry, gap = self._advance_pipelines_step(
                    cache, dcache, carry, active, sids, steps)
                if gap:
                    self.stats.prefill_gap_tokens.add(gap)
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
            keys = None
            if not self.greedy:
                keys = self._lane_keys(self._t(sids, torch.int32),
                                       self._t(steps, torch.int32))
            steps = np.where(active, steps + 1, steps)
            if use_spec:
                with self.tracer.span("step.dispatch", spec=True):
                    if self.tree_width:
                        out = spec.tree_decode_step(
                            self.cfg, self.dcfg, self.params, self.dparams,
                            cache, dcache, carry, gamma=self.gamma,
                            width=self.tree_width, greedy=self.greedy,
                            keys=keys)
                    else:
                        out = spec.spec_decode_step(
                            self.cfg, self.dcfg, self.params, self.dparams,
                            cache, dcache, carry, gamma=self.gamma,
                            greedy=self.greedy, keys=keys)
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
                        gamma=self.gamma, greedy=self.greedy, keys=keys)
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
            self.stats.prefill_lane_rounds += sum(
                len(p.admitted) for p in self._pipelines)
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
