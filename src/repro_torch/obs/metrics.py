"""Namespaced metrics registry: Counter / Gauge / Histogram.

One ``MetricsRegistry`` holds every metric the system exposes, keyed
by dotted name in four namespaces — ``serving.*`` (engine counters and
latency sketches), ``train.*`` (training service + signal channel),
``paging.*`` (page allocator), ``spec.*`` (speculation policy state).
The legacy surfaces (``ServingStats`` attributes,
``TrainingService.stats()``, ``TideSystem.summary()``) remain as thin
views over the same objects, so old and new reads always agree.

Metric kinds:

- :class:`Counter` — a monotonically-growing number (int or float).
- :class:`Gauge` — a point-in-time value; either set directly or bound
  to a zero-argument callback evaluated at snapshot time (so derived
  values like occupancy or a policy's park count need no push path).
- :class:`Histogram` — a streaming distribution built on the existing
  bounded primitives: one :class:`repro_torch.serving.stats.Peak` (max /
  mean / count) plus one :class:`repro_torch.serving.stats.P2Quantile` per
  requested quantile.  O(1) memory, no sample retention.

``snapshot()`` returns one flat ``{name: value}`` dict (histograms
expand to ``.count/.mean/.max/.pNN`` sub-keys); ``to_json()`` and
``to_prometheus()`` render it as JSON / Prometheus text exposition.
All mutation is lock-guarded so the background training thread can
register and bump metrics concurrently with serving.
"""
from __future__ import annotations

import json
import threading
from typing import Callable, Dict, Optional, Sequence

from repro_torch.serving.stats import P2Quantile, Peak


class Counter:
    """Monotonic counter.  ``value`` is plain attribute access so the
    serving loop can keep ``stats.tokens_out += n`` idioms."""
    kind = "counter"
    __slots__ = ("value",)

    def __init__(self, value: float = 0):
        self.value = value

    def inc(self, n: float = 1):
        self.value += n

    def __repr__(self):
        return f"Counter({self.value})"


class Gauge:
    """Point-in-time value: settable, or computed by a bound callback."""
    kind = "gauge"
    __slots__ = ("_value", "fn")

    def __init__(self, value: float = 0.0,
                 fn: Optional[Callable[[], float]] = None):
        self._value = value
        self.fn = fn

    def set(self, value: float):
        self._value = value

    @property
    def value(self) -> float:
        if self.fn is not None:
            return self.fn()
        return self._value

    def __repr__(self):
        return f"Gauge({self.value})"


class Histogram:
    """Streaming distribution over scalar observations.

    Composition of the bounded sketches from ``serving/stats.py``: a
    ``Peak`` for max/mean/count and one ``P2Quantile`` per requested
    quantile.  The ``add``/``max``/``mean``/``n`` surface matches
    ``Peak`` so existing ``ServingStats`` consumers (tests, benches)
    read a Histogram exactly like the Peak it replaces.
    """
    kind = "histogram"
    __slots__ = ("peak", "sketches")

    def __init__(self, quantiles: Sequence[float] = (0.5, 0.95)):
        self.peak = Peak()
        self.sketches: Dict[float, P2Quantile] = {
            float(q): P2Quantile(float(q)) for q in quantiles}

    def add(self, x: float):
        self.peak.add(x)
        for s in self.sketches.values():
            s.add(x)

    observe = add

    @property
    def n(self) -> int:
        return self.peak.n

    @property
    def total(self) -> float:
        return self.peak.total

    @property
    def mean(self) -> float:
        return self.peak.mean

    @property
    def max(self) -> float:
        return self.peak.max

    def quantile(self, q: float) -> float:
        return self.sketches[float(q)].value

    def __repr__(self):
        qs = ", ".join(f"p{int(q * 100)}={s.value:.4g}"
                       for q, s in sorted(self.sketches.items()))
        return f"Histogram(n={self.n}, max={self.max:.4g}, {qs})"


class MetricsRegistry:
    """Get-or-create registry of named metrics with one ``snapshot()``.

    Names are dotted (``serving.tokens_out``); the segment before the
    first dot is the namespace.  Re-registering an existing name
    returns the existing object (or rebinds a gauge callback), so
    components can idempotently declare their metrics at construction.
    """

    def __init__(self):
        self._metrics: Dict[str, object] = {}
        self._lock = threading.Lock()

    # -- declaration ---------------------------------------------------
    def counter(self, name: str) -> Counter:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = Counter()
            return m

    def gauge(self, name: str,
              fn: Optional[Callable[[], float]] = None) -> Gauge:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = Gauge(fn=fn)
            elif fn is not None:
                # rebind: a fresh ServingStats re-registers its derived
                # gauges against the same long-lived registry
                m.fn = fn
            return m

    def histogram(self, name: str,
                  quantiles: Sequence[float] = (0.5, 0.95),
                  reset: bool = False) -> Histogram:
        with self._lock:
            m = self._metrics.get(name)
            if m is None or reset:
                m = self._metrics[name] = Histogram(quantiles)
            return m

    def get(self, name: str):
        return self._metrics.get(name)

    def names(self):
        with self._lock:
            return sorted(self._metrics)

    def namespaces(self):
        return sorted({n.split(".", 1)[0] for n in self.names()})

    # -- exposition ----------------------------------------------------
    def snapshot(self) -> Dict[str, float]:
        """One flat dict of every metric's current value.  Histograms
        expand to ``name.count``, ``name.mean``, ``name.max`` and one
        ``name.pNN`` per quantile."""
        with self._lock:
            items = sorted(self._metrics.items())
        out: Dict[str, float] = {}
        for name, m in items:
            if m.kind == "histogram":
                out[f"{name}.count"] = m.n
                out[f"{name}.mean"] = m.mean
                out[f"{name}.max"] = m.max
                for q, s in sorted(m.sketches.items()):
                    out[f"{name}.p{int(round(q * 100))}"] = s.value
            else:
                out[name] = m.value
        return out

    def to_json(self, path: Optional[str] = None) -> str:
        text = json.dumps(self.snapshot(), indent=2, sort_keys=True)
        if path is not None:
            with open(path, "w") as f:
                f.write(text + "\n")
        return text

    def to_prometheus(self) -> str:
        """Prometheus text exposition (names flattened: dots -> ``_``)."""
        with self._lock:
            items = sorted(self._metrics.items())
        lines = []
        for name, m in items:
            flat = name.replace(".", "_").replace("-", "_")
            if m.kind == "histogram":
                lines.append(f"# TYPE {flat} summary")
                for q, s in sorted(m.sketches.items()):
                    lines.append(
                        f'{flat}{{quantile="{q:g}"}} {s.value:g}')
                lines.append(f"{flat}_count {m.n}")
                lines.append(f"{flat}_sum {m.total:g}")
                lines.append(f"{flat}_max {m.max:g}")
            else:
                lines.append(f"# TYPE {flat} {m.kind}")
                lines.append(f"{flat} {float(m.value):g}")
        return "\n".join(lines) + "\n"
