"""Zero-sync observability: tracing, metrics, per-request recording.

Three host-side instruments share one rule — they attach **only at
existing host telemetry boundaries** (superstep unpack, scheduler
admission, trainer publish, deploy poll) and therefore add **zero
device<->host synchronizations** to the serving path:

- :mod:`repro_torch.obs.trace` — a ring-buffered span/event tracer exporting
  Chrome/Perfetto trace-event JSON (``chrome://tracing`` / ui.perfetto.dev).
- :mod:`repro_torch.obs.metrics` — a namespaced Counter/Gauge/Histogram
  registry (``serving.*``, ``train.*``, ``paging.*``, ``spec.*``) with
  one ``snapshot()`` and Prometheus-style text exposition.
- :mod:`repro_torch.obs.recorder` — a per-request flight recorder that
  reconstructs each request's lifecycle (admit -> prefill chunks ->
  first token -> commits/parks/probes -> finish) from rounds the engine
  already unpacks.

The disabled path is the default: ``NULL_TRACER`` / ``NULL_RECORDER``
singletons answer ``.enabled == False`` so hot-loop guards are a single
attribute check and the off configuration stays byte-identical to a
build without this package.
"""
import dataclasses
from typing import Optional

from repro_torch.obs.metrics import (Counter, Gauge, Histogram, MetricsRegistry)
from repro_torch.obs.recorder import FlightRecorder, NullRecorder, NULL_RECORDER
from repro_torch.obs.trace import NullTracer, NULL_TRACER, Tracer

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "FlightRecorder", "NullRecorder", "NULL_RECORDER",
    "NullTracer", "NULL_TRACER", "Tracer",
    "ObsConfig",
]


@dataclasses.dataclass
class ObsConfig:
    """Observability toggles for :class:`repro_torch.core.tide.TideSystem`.

    This is a *system-layer* config (a ``TideConfig`` field), not a
    ``ServingConfig`` knob: it builds runtime instrument objects that
    are handed to the engine/trainer as collaborators.
    """
    trace: bool = False                 # enable the span tracer
    trace_capacity: int = 65536         # ring capacity (events)
    trace_path: Optional[str] = None    # export trace JSON here on close
    record: bool = False                # enable the flight recorder
    record_capacity: int = 1024         # finished-request timelines kept

    def build(self):
        """Return ``(tracer, recorder)`` per the toggles (null when off)."""
        on = self.trace or self.trace_path is not None
        tracer = Tracer(self.trace_capacity) if on else NULL_TRACER
        rec = FlightRecorder(self.record_capacity) if self.record \
            else NULL_RECORDER
        return tracer, rec
