"""Slot-level admission control for continuous batching.

The ``Scheduler`` owns the mapping between device batch lanes ("slots")
and live requests.  The serving engine asks it, between decode
supersteps, which finished slots can be refilled from the pending
queue; the engine then writes the new prompts into the resident device
state without tearing it down (``ServingEngine.serve_stream``).

Admission *order* is delegated to a ``serving.policy.AdmissionPolicy``:
the default ``FifoAdmission`` admits in arrival order with the queue
topped up lazily from the request iterator (one pull only when the
queue is empty, so an unbounded stream is never materialized — the
pre-policy byte-parity behavior); reordering policies
(``PriorityAdmission``, ``DeadlineAdmission``) declare a ``lookahead``
window the scheduler keeps materialized and pick among the admissible
candidates per freed slot.  Orthogonally, two arrival modes:

  * **backlog** (default) — arrival timestamps are bookkeeping only; a
    trace is replayed as fast as the engine can drain it (the goodput
    measurement of ``benchmarks/bench_continuous.py``).
  * **arrival gating** (``gate_arrivals=True``) — a request with
    ``arrives_at`` set (seconds since stream start) is held back until
    its arrival time; with all slots idle and the queue empty the
    engine emits *idle supersteps* instead of dispatching, which is
    exactly the slack the decoupled draft trainer consumes on
    single-device hosts.  Under strict-order policies (FIFO) the queue
    head gates later arrivals; reordering policies admit any arrived
    candidate.

Endless streams: by default every completed request is retained in
``completed`` (the engine's return value).  Pass a ``completion_sink``
callback to stream completions out instead — host retention then stays
O(batch) no matter how long the stream runs.
"""
from __future__ import annotations

import time
from collections import deque
from typing import (Callable, Deque, Dict, Iterable, Iterator, List,
                    Optional, Tuple)

from repro_torch.obs.trace import NULL_TRACER
from repro_torch.serving.policy import AdmissionPolicy, FifoAdmission
from repro_torch.serving.request import Request


class Scheduler:
    """Policy-driven admission queue + slot occupancy for one engine."""

    def __init__(self, batch_size: int,
                 requests: Optional[Iterable[Request]] = None, *,
                 policy: Optional[AdmissionPolicy] = None,
                 gate_arrivals: bool = False,
                 clock: Callable[[], float] = time.perf_counter,
                 completion_sink: Optional[Callable[[Request], None]]
                 = None,
                 admission_guard: Optional[
                     Callable[[Request, List[Request]], bool]] = None,
                 tracer=None):
        self.batch = batch_size
        self.policy = policy if policy is not None else FifoAdmission()
        # host-side observability: admission instants + queue-depth
        # counter samples (null by default — a no-op attribute check)
        self.tracer = tracer if tracer is not None else NULL_TRACER
        # resource veto consulted per candidate during ``admit`` (paged
        # serving passes the page-pool guard): guard(candidate,
        # already-accepted-this-round) -> False defers the candidate
        self.admission_guard = admission_guard
        self.slots: List[Optional[Request]] = [None] * batch_size
        self._queue: Deque[Request] = deque()
        self._iter: Optional[Iterator[Request]] = (
            iter(requests) if requests is not None else None)
        self._exhausted = requests is None
        self.gate_arrivals = gate_arrivals
        self._clock = clock
        self._t0 = clock()
        self.admitted = 0
        self.completed: List[Request] = []
        self.sink = completion_sink

    # ------------------------------------------------------------ queue
    def submit(self, req: Request):
        self._queue.append(req)

    def _now(self) -> float:
        return self._clock() - self._t0

    def _pull(self) -> bool:
        """Top the queue up with one request from the iterator."""
        if self._exhausted:
            return False
        try:
            req = next(self._iter)
        except StopIteration:
            self._exhausted = True
            return False
        if self.gate_arrivals and req.arrives_at is not None:
            # re-anchor the latency clock to the gated arrival instant
            # (materialization time would charge queueing that the
            # trace says hasn't happened yet)
            req.arrival_t = self._t0 + req.arrives_at
        self._queue.append(req)
        return True

    def _arrived(self, req: Request) -> bool:
        if not self.gate_arrivals or req.arrives_at is None:
            return True
        return req.arrives_at <= self._now()

    def _fill(self):
        """Top the queue up to the policy's lookahead window (at least
        one entry).  FIFO's lookahead of 0 keeps the pre-policy lazy
        pull: exactly one request is materialized, only when the queue
        is empty."""
        want = max(self.policy.lookahead, 1)
        while len(self._queue) < want and self._pull():
            pass

    def _admissible(self) -> List[int]:
        """Queue indices the policy may admit right now.  Strict-order
        policies expose only the head (and only once it has arrived);
        reordering policies expose every arrived entry in the window."""
        self._fill()
        if not self._queue:
            return []
        if self.policy.strict_order:
            return [0] if self._arrived(self._queue[0]) else []
        return [i for i, r in enumerate(self._queue) if self._arrived(r)]

    def has_pending(self) -> bool:
        """A request is admissible right now (per the admission policy
        and arrival gating)."""
        return bool(self._admissible())

    def more_coming(self) -> bool:
        """Requests remain that are not yet admissible (future arrivals
        or an unexhausted iterator)."""
        return bool(self._queue) or not self._exhausted

    def next_arrival_in(self) -> Optional[float]:
        """Seconds until some request becomes admissible; 0.0 if one
        already is; None if the stream is exhausted."""
        self._fill()
        if not self._queue:
            return None
        if self._admissible():
            return 0.0
        if self.policy.strict_order:
            return max(self._queue[0].arrives_at - self._now(), 0.0)
        nxt = min(r.arrives_at for r in self._queue
                  if r.arrives_at is not None)
        return max(nxt - self._now(), 0.0)

    def has_work(self) -> bool:
        """True while any slot is occupied or any request is admissible."""
        return any(s is not None for s in self.slots) or self.has_pending()

    def queue_view(self) -> List[Request]:
        """The arrived queue entries (window topped up first) — the
        read-only view shed policies rank over."""
        self._fill()
        return [r for r in self._queue if self._arrived(r)]

    def peek_next(self) -> Optional[Request]:
        """The request ``admit`` would pick next, without removing it —
        the preemption tier compares its deadline against resident
        lanes' to decide whether evicting one is worth it."""
        cands = self._admissible()
        if not cands:
            return None
        pick = cands[self.policy.select(
            [self._queue[j] for j in cands], self._now())]
        return self._queue[pick]

    # ------------------------------------------------------------ slots
    def retire(self, req: Request):
        """Route one finished request through the completion path (the
        sink when configured, else the ``completed`` list)."""
        if self.sink is not None:
            self.sink(req)
        else:
            self.completed.append(req)

    def release_finished(self) -> List[Request]:
        """Free every slot whose request has finished; returns them in
        slot order (the engine records latency stats before calling).
        With a ``completion_sink``, completions stream to the callback
        instead of accumulating in ``completed``."""
        freed = []
        for i, r in enumerate(self.slots):
            if r is not None and r.finish_t is not None:
                self.slots[i] = None
                self.retire(r)
                freed.append(r)
        return freed

    def evict(self, slot: int) -> Request:
        """Preemption: clear an *unfinished* resident from its slot
        (the engine has already spilled its device state) and return
        it.  The request stays live — it re-enters via the engine's
        SpillStore restore path, never through the admission queue."""
        req = self.slots[slot]
        assert req is not None, f"evict of empty slot {slot}"
        self.slots[slot] = None
        if self.tracer.enabled:
            self.tracer.instant("sched.evict", slot=slot, rid=req.rid)
        return req

    def shed(self, victims: List[Request]):
        """Load shedding: drop queued requests (already finished/marked
        by the engine) from the pending queue and route them through
        the completion path."""
        ids = {id(r) for r in victims}
        if not ids:
            return
        self._queue = deque(r for r in self._queue if id(r) not in ids)
        for r in victims:
            self.retire(r)
        if self.tracer.enabled:
            self.tracer.instant("sched.shed", n=len(victims),
                                rids=[r.rid for r in victims])

    def admit(self) -> List[Tuple[int, Request]]:
        """Fill free slots from the pending queue (admission order per
        the policy; gated on arrival time when enabled).  Returns the
        (slot, request) assignments made — the engine's refill batch.
        Each admitted request is stamped with ``admit_t`` (prefill
        starts now — the TTFT clock origin; the injected ``clock`` so
        latency stats never mix clock domains under a fake clock).  An
        ``admission_guard`` can veto the round's next candidate: under a
        strict-order policy the round then stops (admitting past the
        FIFO head would reorder); a reordering policy skips the vetoed
        candidate and keeps trying the rest of its lookahead window.
        Deferred requests stay queued and retry once capacity frees."""
        out = []
        now = self._clock()
        for i, r in enumerate(self.slots):
            if r is not None:
                continue
            req = self._pick_fitting(out)
            if req is None:
                break
            req.admit_t = now
            self.slots[i] = req
            self.admitted += 1
            out.append((i, req))
        return self._admit_trace(out)

    def _pick_fitting(self, accepted: List[Tuple[int, Request]]
                      ) -> Optional[Request]:
        """Policy-pick one admissible request that passes the admission
        guard, removing it from the queue (None when there is none)."""
        vetoed: set = set()
        while True:
            cands = [j for j in self._admissible() if j not in vetoed]
            if not cands:
                return None
            pick = cands[self.policy.select(
                [self._queue[j] for j in cands], self._now())]
            req = self._queue[pick]
            if (self.admission_guard is not None
                    and not self.admission_guard(
                        req, [q for _, q in accepted])):
                if self.policy.strict_order:
                    return None
                vetoed.add(pick)
                continue
            del self._queue[pick]
            return req

    def _admit_trace(self, out: List[Tuple[int, Request]]
                     ) -> List[Tuple[int, Request]]:
        if out and self.tracer.enabled:
            self.tracer.instant("sched.admit", n=len(out),
                                rids=[r.rid for _, r in out])
            self.tracer.counter("sched.queue_depth",
                                depth=len(self._queue))
        return out

    @staticmethod
    def refill_groups(admitted: List[Tuple[int, Request]],
                      prefill_chunk: int) -> List[List[Tuple[int, Request]]]:
        """Chunk-aware partition of one admission batch into refill
        pipelines.

        A one-shot refill pads every co-admitted prompt to the longest,
        so a short prompt that frees a slot beside a long one pays the
        long prompt's width (and, chunked, would ride its whole
        multi-chunk pipeline).  With chunking on, the engine runs one
        chunk pipeline per *padded-width bucket* (multiples of 8, the
        refill shape bucket): prompts of one bucket share a pipeline,
        and the buckets' chunks interleave through the same gaps.
        Admission order is kept within and across groups (the slots
        were assigned in ``admit``), so this only shapes the refill
        ops."""
        if prefill_chunk <= 0:
            return [admitted] if admitted else []
        groups: Dict[int, List[Tuple[int, Request]]] = {}
        for slot, req in admitted:
            width = max(8, -(-len(req.prompt) // 8) * 8)
            groups.setdefault(width, []).append((slot, req))
        return list(groups.values())
