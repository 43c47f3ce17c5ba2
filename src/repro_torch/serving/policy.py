"""Pluggable serving control plane: the ``ServingPolicy`` API.

TIDE's core claim is *adaptive runtime control*: speculation and
training activate only when beneficial.  Every host-side scheduling
decision the engine makes between supersteps is delegated to one of two
small policy objects, composed into a single ``ServingPolicy``:

  * ``AdmissionPolicy`` — which pending request enters a freed batch
    lane.  Built-ins: ``FifoAdmission`` (default; byte-parity with the
    pre-policy engine, including its lazy one-request queue pull),
    ``PriorityAdmission`` (highest ``Request.priority`` first),
    ``DeadlineAdmission`` (earliest-deadline-first over
    ``Request.deadline``, the latency-SLO admission policy) and
    ``WeightedEdfAdmission``.
  * ``SpeculationPolicy`` — the Eq. 5 adaptive gate (the per-round
    speculate-vs-plain threshold table) plus a runtime on/off control
    that can *park* speculation and signal capture when the
    acceptance-adjusted gain stays below break-even, and *resume* it via
    periodic forced-speculation acceptance probes.

All policy decisions are host-side and land between superstep
dispatches: a policy can reorder admission or swap the (fixed-shape)
threshold table, but it never adds a device-to-host round-trip.

The JAX engine's commit, shed and preemption policies belong to the
chunked-refill and overload paths, which are not ported; they come back
with those paths.

``ServingConfig`` is the unified serving configuration consumed by
``ServingEngine``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Sequence, Tuple

from repro_torch.serving.request import Request


# ===================================================== admission policies
class AdmissionPolicy:
    """Chooses which pending request enters a freed slot.

    The scheduler keeps its queue topped up to ``lookahead`` requests
    (0 = pull one lazily only when the queue is empty — the FIFO
    byte-parity behavior: an unbounded stream is never materialized),
    then asks ``select`` to pick among the *admissible* candidates
    (arrived, under arrival gating).  ``strict_order`` preserves FIFO
    gating semantics: the queue head blocks admission until it arrives,
    even if a later request already has.  Reordering policies set it
    False so any arrived request is a candidate."""

    name = "base"
    lookahead: int = 0
    strict_order: bool = True

    def select(self, candidates: Sequence[Request], now: float) -> int:
        """Index into ``candidates`` of the request to admit next."""
        raise NotImplementedError


class FifoAdmission(AdmissionPolicy):
    """Arrival order, head-of-line (the pre-policy engine, bitwise)."""

    name = "fifo"

    def select(self, candidates: Sequence[Request], now: float) -> int:
        return 0


class PriorityAdmission(AdmissionPolicy):
    """Highest ``Request.priority`` first; ties break FIFO."""

    name = "priority"
    strict_order = False

    def __init__(self, lookahead: int = 64):
        self.lookahead = lookahead

    def select(self, candidates: Sequence[Request], now: float) -> int:
        best = 0
        for i, r in enumerate(candidates):
            if r.priority > candidates[best].priority:
                best = i
        return best


class DeadlineAdmission(AdmissionPolicy):
    """Earliest-deadline-first (EDF) over ``Request.deadline``.

    Requests without a deadline sort last; among equal deadlines the
    higher ``priority`` wins, then FIFO order.  This is the
    latency-SLO admission policy: under bursty arrivals it pulls
    tight-deadline requests ahead of the backlog instead of letting
    them queue behind loose ones (``benchmarks/bench_slo.py`` gates the
    deadline-hit-rate win over FIFO)."""

    name = "deadline"
    strict_order = False

    def __init__(self, lookahead: int = 64):
        self.lookahead = lookahead

    @staticmethod
    def _key(r: Request) -> Tuple[float, int]:
        d = r.deadline if r.deadline is not None else math.inf
        return (d, -r.priority)

    def select(self, candidates: Sequence[Request], now: float) -> int:
        best = 0
        for i, r in enumerate(candidates):
            if self._key(r) < self._key(candidates[best]):
                best = i
        return best


class WeightedEdfAdmission(DeadlineAdmission):
    """Weighted earliest-deadline-first: EDF with a priority credit.

    The effective deadline is ``deadline - weight * priority``, so a
    high-priority request is treated as ``weight * priority`` service
    units tighter than its nominal deadline (units are whatever the
    workload measures deadlines in — executed rounds for the SLO/
    overload benches).  With every priority equal this is exactly EDF;
    the weight is the one tuning knob of the classic weighted-EDF
    admission tier."""

    name = "wedf"

    def __init__(self, lookahead: int = 64, weight: float = 1.0):
        super().__init__(lookahead=lookahead)
        self.weight = float(weight)

    def _key(self, r: Request) -> Tuple[float, int]:
        d = r.deadline if r.deadline is not None else math.inf
        return (d - self.weight * r.priority, -r.priority)


# =================================================== speculation policy
class SpeculationPolicy:
    """Eq. 5 adaptive gate + runtime park/resume control.

    The *gate* is the paper's per-round speculate-vs-plain decision: a
    break-even threshold table (``AdaptiveDrafter.threshold_table``)
    the fused superstep evaluates in-graph against the acceptance-EMA
    — zero host syncs.  With ``drafter=None`` the engine always
    speculates (table ``None``), exactly as before.

    The *park* control (``park_patience > 0``) handles the gate's
    latch-off failure mode: the acceptance EMA only updates on
    speculative rounds, so once the gate turns speculation off the EMA
    freezes below threshold and can never recover on its own.  After
    ``park_patience`` consecutive gated-off rounds the policy parks:
    dispatches swap in a never-speculate table (same shape/dtype — no
    retrace, no extra syncs) and signal capture is suppressed
    (``blocks_capture``), so neither drafting nor capture burns device
    work while speculation is unprofitable.  Every ``probe_interval``
    parked dispatches, one *acceptance probe* runs with a
    force-speculate table; if the probe's refreshed EMA clears the real
    Eq. 5 threshold again, the policy resumes.  Park state advances on
    host-side telemetry replay (one superstep of pipelining lag, like
    every host decision under the fused superstep).
    """

    name = "adaptive"

    def __init__(self, drafter=None, park_patience: int = 0,
                 probe_interval: int = 8):
        self.drafter = drafter
        self.park_patience = int(park_patience)
        self.probe_interval = max(int(probe_interval), 1)
        self.parked = False
        self.probing = False        # next dispatch is an acceptance probe
        self.parks = 0
        self.resumes = 0
        self._idle = 0              # consecutive gated-off rounds
        self._since_probe = 0       # parked dispatches since last probe
        self._tables = None         # (gate, park, probe) device tables
        # observability hook: called as on_transition(kind, fields) at
        # every park/probe/resume state change (kinds "spec.park",
        # "spec.probe", "spec.resume").  Host-side only — transitions
        # happen in telemetry replay / dispatch-table selection, never
        # in-graph — so the hook can never add a device sync.
        self.on_transition = None

    # ------------------------------------------------------------ setup
    def prepare(self, batch: int, device=None):
        """Build the fixed-shape threshold tables on ``device`` (called
        once by the engine)."""
        if self.park_patience and self.drafter is None:
            raise ValueError(
                "speculation park control needs an AdaptiveDrafter "
                "(Eq. 5 latency profile) to probe acceptance against")
        if self.drafter is None:
            self._tables = None
            return
        import torch
        gate = torch.as_tensor(self.drafter.threshold_table(batch),
                               device=device)
        self._tables = (gate,
                        torch.full_like(gate, float("inf")),    # park: never
                        torch.full_like(gate, float("-inf")))   # probe: always

    def reset(self):
        self.parked = False
        self.probing = False
        self.parks = 0
        self.resumes = 0
        self._idle = 0
        self._since_probe = 0

    # ------------------------------------------------------- dispatch side
    def _probe_tick(self) -> bool:
        """Advance the parked probe cadence by one dispatch; True when
        this dispatch is the forced-speculation acceptance probe (the
        single state machine both engine modes share)."""
        self._since_probe += 1
        self.probing = self._since_probe >= self.probe_interval
        if self.probing:
            self._since_probe = 0
            self._emit("spec.probe")
        return self.probing

    def _emit(self, kind: str, **fields):
        if self.on_transition is not None:
            self.on_transition(kind, fields)

    def dispatch_table(self):
        """Threshold table for the next superstep dispatch (or None =
        always speculate).  Parked, returns the never-speculate table
        except every ``probe_interval``-th dispatch, which runs a
        forced-speculation acceptance probe."""
        if self._tables is None:
            return None
        if not self.parked:
            self.probing = False
            return self._tables[0]
        return self._tables[2 if self._probe_tick() else 1]

    def step_decision(self, n_active: int, accept_ema: float) -> bool:
        """Per-round host decision for the per-step reference loop
        (the host twin of the in-graph gate + park control)."""
        if self.drafter is None:
            return True
        if self.parked:
            return self._probe_tick()
        self.probing = False
        return self.drafter.update(n_active, accept_ema)

    # ------------------------------------------------------ telemetry side
    def observe_round(self, n_active: int, accept_ema: float,
                      use_spec: bool):
        """Advance park/resume state from one round of telemetry."""
        if not self.park_patience or self.drafter is None:
            return
        if self.parked:
            # only probe rounds speculate while parked; resume when the
            # probe's refreshed EMA clears the real Eq. 5 gate
            if use_spec and self.drafter.update(max(n_active, 1),
                                                accept_ema):
                self.parked = False
                self._idle = 0
                self.resumes += 1
                self._emit("spec.resume", accept_ema=accept_ema)
            return
        if use_spec:
            self._idle = 0
        else:
            self._idle += 1
            if self._idle >= self.park_patience:
                self.parked = True
                self._since_probe = 0
                self.parks += 1
                self._emit("spec.park", idle_rounds=self._idle,
                           accept_ema=accept_ema)

    @property
    def blocks_capture(self) -> bool:
        """Parked speculation also parks signal capture: unprofitable
        drafting means training signals are not worth their host-side
        ingestion either (the paper's adaptive runtime control parks
        the whole adaptation loop, not just the draft)."""
        return self.parked


# ===================================================== composed policy
def _default_speculation() -> SpeculationPolicy:
    return SpeculationPolicy()


@dataclasses.dataclass
class ServingPolicy:
    """The composed serving control plane one engine runs under.

    The default composition (FIFO admission + bare Eq. 5 gate) is
    byte-parity with the pre-policy engine: identical streams, stats and
    SignalStore contents."""

    admission: AdmissionPolicy = dataclasses.field(
        default_factory=FifoAdmission)
    speculation: SpeculationPolicy = dataclasses.field(
        default_factory=_default_speculation)


# ====================================================== unified config
ADMISSION_POLICIES = {"fifo": FifoAdmission, "priority": PriorityAdmission,
                      "deadline": DeadlineAdmission,
                      "wedf": WeightedEdfAdmission}


@dataclasses.dataclass
class ServingConfig:
    """Unified serving configuration: every engine/scheduler knob, plus
    the policy selection, in one dataclass (``ServingEngine(config=...)``).

    ``page_size``, ``prefill_chunk``, ``tree_width``, ``reseed_window``
    and ``greedy=False`` name paths of the JAX engine that are not ported
    yet; the engine raises ``NotImplementedError`` for any value but the
    default."""

    # ---- engine geometry / decode
    gamma: int = 3
    batch_size: int = 4
    max_len: int = 160
    greedy: bool = True
    superstep_rounds: int = 8
    eos_id: Optional[int] = None
    ema: float = 0.9
    # ---- admission / scheduling
    admission: str = "fifo"            # fifo | priority | deadline | wedf
    admission_lookahead: int = 64      # reorder window (non-FIFO policies)
    gate_arrivals: bool = False
    idle_wait_s: float = 0.005
    completion_sink: Optional[Callable[[Request], None]] = \
        dataclasses.field(default=None, repr=False)
    # ---- unported: chunked refill prefill, paged KV, tree speculation
    prefill_chunk: int = 0
    page_size: int = 0
    tree_width: int = 0
    # ---- speculation runtime control (0 = gate only, never park)
    spec_park_patience: int = 0
    spec_probe_interval: int = 8
    # ---- unported: draft re-seeding after a deploy
    reseed_window: int = 0

    def make_policy(self, drafter=None) -> ServingPolicy:
        """Build the ``ServingPolicy`` this config names."""
        adm_cls = ADMISSION_POLICIES[self.admission]
        adm = (adm_cls() if adm_cls is FifoAdmission
               else adm_cls(lookahead=self.admission_lookahead))
        return ServingPolicy(
            admission=adm,
            speculation=SpeculationPolicy(
                drafter, park_patience=self.spec_park_patience,
                probe_interval=self.spec_probe_interval))
