"""Per-request flight recorder.

Reconstructs each request's lifecycle purely from events the engine
already observes host-side — admission (``_assign_sids``), prefill
chunk dispatches, the first committed token, per-round token commits
replayed during superstep unpack, speculation park/probe/resume
transitions, deploy pickups, and finish — so recording adds zero
device syncs.  Each request accumulates a timeline of
``{"kind", "round", "t", ...}`` events stamped with both the
deterministic executed-round clock (reproducible across runs) and a
host monotonic time (for wall postmortems).

Timeline schema (per request)::

    {"rid": str, "sid": int, "domain": str, "prompt_len": int,
     "budget": int, "priority": int, "deadline": float|None,
     "events": [{"kind": "admit" | "prefill_chunk" | "first_token" |
                 "commit" | "finish" | ..., "round": int, "t": s, ...}],
     "ttft_s": float|None, "latency_s": float|None}   # stamped at finish

Global (non-request) events — deploys, park/probe/resume, admission
deferrals — land in a separate bounded event ring with the same
``kind``/``round``/``t`` stamps.

Memory is bounded: at most ``capacity`` finished timelines are kept
(drop-oldest) plus the live set and ``4 * capacity`` global events.
``NULL_RECORDER`` (default) answers ``enabled == False`` so the
disabled hot path is one attribute check.
"""
from __future__ import annotations

import json
import time
from collections import deque
from typing import Optional


class NullRecorder:
    """Disabled recorder: every hook is a no-op."""
    enabled = False

    def admit(self, req, round_: int):
        pass

    def note(self, rid, kind: str, round_: int = -1, **fields):
        pass

    def finish(self, req, round_: int):
        pass

    def global_event(self, kind: str, round_: int = -1, **fields):
        pass

    def timeline(self, rid):
        return None

    def timelines(self):
        return []

    def export(self, path: Optional[str] = None):
        doc = {"requests": [], "events": []}
        if path is not None:
            with open(path, "w") as f:
                json.dump(doc, f)
        return doc


NULL_RECORDER = NullRecorder()


class FlightRecorder:
    """Bounded per-request lifecycle recorder (host clocks only).

    Single-writer by design: all hooks are called from the serving
    thread (the engine's unpack/admission path), so no lock is taken
    on the hot path.  ``export`` snapshots via list copies.
    """
    enabled = True

    def __init__(self, capacity: int = 1024):
        self.capacity = int(capacity)
        self._t0 = time.perf_counter()
        self._live: dict = {}                      # rid -> timeline dict
        self._done: deque = deque(maxlen=self.capacity)
        self._events: deque = deque(maxlen=4 * self.capacity)

    def _now(self) -> float:
        return time.perf_counter() - self._t0

    # -- hooks (engine-facing) -----------------------------------------
    def admit(self, req, round_: int):
        tl = {
            "rid": req.rid, "sid": req.sid, "domain": req.domain,
            "prompt_len": len(req.prompt), "budget": req.max_new_tokens,
            "priority": getattr(req, "priority", 0),
            "deadline": getattr(req, "deadline", None),
            "events": [{"kind": "admit", "round": round_,
                        "t": self._now()}],
        }
        self._live[req.rid] = tl

    def note(self, rid, kind: str, round_: int = -1, **fields):
        tl = self._live.get(rid)
        if tl is None:
            return
        ev = {"kind": kind, "round": round_, "t": self._now()}
        if fields:
            ev.update(fields)
        tl["events"].append(ev)

    def finish(self, req, round_: int):
        tl = self._live.pop(req.rid, None)
        if tl is None:
            return
        tl["events"].append({"kind": "finish", "round": round_,
                             "t": self._now(),
                             "tokens": len(req.generated)})
        tl["ttft_s"] = req.ttft
        tl["latency_s"] = req.latency
        self._done.append(tl)

    def global_event(self, kind: str, round_: int = -1, **fields):
        ev = {"kind": kind, "round": round_, "t": self._now()}
        if fields:
            ev.update(fields)
        self._events.append(ev)

    # -- inspection / export -------------------------------------------
    def timeline(self, rid) -> Optional[dict]:
        """The timeline for ``rid`` (live or finished), else None."""
        tl = self._live.get(rid)
        if tl is not None:
            return tl
        for tl in self._done:
            if tl["rid"] == rid:
                return tl
        return None

    def timelines(self):
        """All finished timelines (oldest first) then live ones."""
        return list(self._done) + list(self._live.values())

    def export(self, path: Optional[str] = None) -> dict:
        doc = {"requests": self.timelines(),
               "events": list(self._events)}
        if path is not None:
            with open(path, "w") as f:
                json.dump(doc, f, indent=1)
        return doc
