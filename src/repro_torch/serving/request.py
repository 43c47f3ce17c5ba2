"""Serving request/response types."""
from __future__ import annotations

import dataclasses
import itertools
import time
from typing import List, Optional

_ids = itertools.count()


@dataclasses.dataclass
class Request:
    prompt: List[int]
    max_new_tokens: int = 48
    domain: str = ""
    rid: int = dataclasses.field(default_factory=lambda: next(_ids))
    arrival_t: float = dataclasses.field(default_factory=time.perf_counter)
    # trace arrival offset (seconds since stream start); admission is
    # held until then when the scheduler runs with gate_arrivals
    arrives_at: Optional[float] = None
    # ---- SLO annotations (consumed by admission policies; ignored by
    # the default FIFO policy, so they are free to carry everywhere)
    # admission preference: higher admits first under PriorityAdmission
    priority: int = 0
    # completion deadline for DeadlineAdmission's EDF order.  Units are
    # whatever the workload measures service in — wall seconds since
    # stream start for gated traces, or deterministic executed-round
    # units (compare ``finish_round``) for the SLO benchmarks — EDF
    # only needs a consistent total order
    deadline: Optional[float] = None
    # filled by the engine
    generated: List[int] = dataclasses.field(default_factory=list)
    # slot-admission instant (scheduler stamp): the TTFT clock starts
    # here, so a chunk-prefilled request is charged for its whole
    # multi-superstep prefill, never credited for queueing it skipped
    admit_t: Optional[float] = None
    first_token_t: Optional[float] = None
    finish_t: Optional[float] = None
    # deterministic twins of the wall-clock stamps: the engine's
    # executed-round count (``stats.steps``) at slot admission / first
    # token / completion.  Scheduling benchmarks gate on these instead
    # of wall time — the round schedule of a greedy stream is a pure
    # function of the admission order, so SLO wins (deadline hit rate,
    # eager-commit TTFT = ``first_token_round - admit_round``) are
    # reproducible on noisy shared hosts
    admit_round: Optional[int] = None
    first_token_round: Optional[int] = None
    finish_round: Optional[int] = None
    # engine-assigned sampling-stream id (admission ordinal): the
    # per-request PRNG fold-in key, identical for a given stream across
    # every scheduling policy — what makes sampled decoding
    # scheduling-invariant
    sid: Optional[int] = None

    @property
    def done(self) -> bool:
        # finish_t covers early termination (EOS) before the token budget
        return (self.finish_t is not None
                or len(self.generated) >= self.max_new_tokens)

    @property
    def ttft(self) -> Optional[float]:
        """Time to first token (seconds since slot *admission*, falling
        back to arrival when the request never went through a
        scheduler), as observed by the host — under the fused superstep
        the first token materializes with the next superstep's
        telemetry, so this includes up to one superstep of pipelining
        lag, and under chunked prefill it spans every chunk of the
        prompt (the clock starts when prefill starts, not when the last
        chunk commits)."""
        if self.first_token_t is None:
            return None
        start = self.admit_t if self.admit_t is not None else self.arrival_t
        return self.first_token_t - start

    @property
    def latency(self) -> Optional[float]:
        """End-to-end completion latency (seconds since arrival)."""
        if self.finish_t is None:
            return None
        return self.finish_t - self.arrival_t

    def finish(self, now: Optional[float] = None):
        """Mark completion.  ``now`` lets the engine stamp ``finish_t``
        from its injected clock (one clock domain for arrival/admit/
        first-token/finish — fake-clock tests and latency stats depend
        on it); bare calls fall back to the wall clock."""
        if self.finish_t is None:
            self.finish_t = time.perf_counter() if now is None else now
            del self.generated[self.max_new_tokens:]


def inert_request() -> Request:
    """A pre-finished zero-budget placeholder: pads partial waves and
    unoccupied slots so every device batch lane has a definite (masked)
    state.  Never returned to callers."""
    r = Request(prompt=[0], max_new_tokens=0)
    r.finish()
    return r
