"""Ring-buffered span/event tracer with Chrome/Perfetto export.

The tracer records host-side *spans* (named intervals: superstep
dispatch, unpack, refill, prefill chunk, train cycle, reseed) and
*instants* (deploy pickup, admissions, park/probe/resume transitions)
into a bounded deque of tuples.  Recording is allocation-light — one
tuple append under a lock — so it is safe on the serving hot loop and
in the background ``TrainingService`` thread; timestamps come from
``time.perf_counter_ns`` (monotonic), never the device.

``export()`` converts the ring into Chrome trace-event JSON (the
format read by ``chrome://tracing`` and https://ui.perfetto.dev):
spans become ``"ph": "X"`` complete events with microsecond ``ts`` /
``dur``, instants become ``"ph": "i"``, and thread names are emitted
as ``"ph": "M"`` metadata so the serving loop and the training thread
render as separate tracks.  Spans recorded on one thread nest by
construction (begin/end are LIFO per thread).

``NULL_TRACER`` is the default collaborator: ``enabled`` is False and
``span()`` returns a shared no-op context manager, so the disabled
path costs one attribute check (or one trivially-inlined call) and
allocates nothing.
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Optional


class _NullSpan:
    """Shared no-op context manager returned by ``NullTracer.span``."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class NullTracer:
    """Disabled tracer: every operation is a cheap no-op."""
    enabled = False

    def span(self, name: str, **args):
        return _NULL_SPAN

    def instant(self, name: str, **args):
        pass

    def counter(self, name: str, **values):
        pass

    def events(self):
        return []

    def export(self, path: Optional[str] = None):
        doc = {"traceEvents": [], "displayTimeUnit": "ms"}
        if path is not None:
            with open(path, "w") as f:
                json.dump(doc, f)
        return doc


NULL_TRACER = NullTracer()


class _Span:
    """Context manager recording one complete ("X") event on exit."""
    __slots__ = ("_tr", "name", "args", "_t0")

    def __init__(self, tr: "Tracer", name: str, args: dict):
        self._tr = tr
        self.name = name
        self.args = args

    def __enter__(self):
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self._tr._complete(self.name, self._t0,
                           time.perf_counter_ns(), self.args)
        return False


class Tracer:
    """Bounded, thread-safe span/instant recorder.

    Events are stored as tuples ``(ph, name, ts_ns, dur_ns, tid,
    args)``; the deque drops the oldest events beyond ``capacity`` so
    an endless serving run keeps the trailing window.  All clocks are
    host-monotonic: recording never touches the device.
    """
    enabled = True

    def __init__(self, capacity: int = 65536):
        self.capacity = int(capacity)
        self._buf: deque = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._t0 = time.perf_counter_ns()
        self._tid_names: dict = {}

    # -- recording -----------------------------------------------------
    def span(self, name: str, **args) -> _Span:
        """Open a named span; use as ``with tracer.span("unpack"): ...``."""
        return _Span(self, name, args)

    def _complete(self, name, t0, t1, args):
        tid = threading.get_ident()
        if tid not in self._tid_names:
            self._tid_names[tid] = threading.current_thread().name
        with self._lock:
            self._buf.append(("X", name, t0, t1 - t0, tid, args))

    def instant(self, name: str, **args):
        """Record a zero-duration event (deploy pickup, admission, ...)."""
        tid = threading.get_ident()
        if tid not in self._tid_names:
            self._tid_names[tid] = threading.current_thread().name
        with self._lock:
            self._buf.append(("i", name, time.perf_counter_ns(),
                              0, tid, args))

    def counter(self, name: str, **values):
        """Record a counter sample (renders as a track in Perfetto)."""
        tid = threading.get_ident()
        with self._lock:
            self._buf.append(("C", name, time.perf_counter_ns(),
                              0, tid, values))

    # -- export --------------------------------------------------------
    def events(self):
        """Snapshot of the raw event tuples (oldest first)."""
        with self._lock:
            return list(self._buf)

    def export(self, path: Optional[str] = None) -> dict:
        """Render the ring as a Chrome trace-event JSON document.

        Returns the document (``{"traceEvents": [...]}``); when
        ``path`` is given it is also written there.
        """
        pid = os.getpid()
        out = []
        for tid, tname in sorted(self._tid_names.items()):
            out.append({"ph": "M", "name": "thread_name", "pid": pid,
                        "tid": tid, "args": {"name": tname}})
        for ph, name, ts_ns, dur_ns, tid, args in self.events():
            ev = {"ph": ph, "name": name, "pid": pid, "tid": tid,
                  "ts": (ts_ns - self._t0) / 1e3, "cat": "tide"}
            if ph == "X":
                ev["dur"] = dur_ns / 1e3
            elif ph == "i":
                ev["s"] = "t"  # thread-scoped instant
            if args:
                ev["args"] = dict(args)
            out.append(ev)
        doc = {"traceEvents": out, "displayTimeUnit": "ms"}
        if path is not None:
            with open(path, "w") as f:
                json.dump(doc, f)
        return doc
