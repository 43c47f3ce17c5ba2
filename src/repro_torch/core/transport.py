"""Signal transport between the serving and training engines (port of
``repro/core/transport.py``).

The ``SignalChannel`` is the seam between the two: the serving engine's
superstep unpack pushes packed ``SignalBatch`` windows into a bounded,
drop-oldest ring, and the training service drains the other end.
Dropping the oldest under backpressure is the right policy for online
adaptation: a slow trainer should see the freshest distribution, and
serving never blocks on training.

In this slice the channel is a host ring and the service drains it
synchronously at request-completion boundaries.  Placing batches on a
training device as they are enqueued (JAX's ``device_put`` onto the
device ``pick_training_device`` carves out) comes with the asynchronous
half of the loop, ROADMAP queue 1 item 2; until then ``device`` must be
None.
"""
from __future__ import annotations

import threading
from typing import Optional

from repro_torch.core.signals import SignalBatch, SignalStore


class SignalChannel(SignalStore):
    """Bounded drop-oldest channel from the signal extractor to the
    training service.

    Duck-types ``SignalStore`` (``add``/``drain``/``peek_count``) so the
    ``SignalExtractor`` writes into it unchanged, and adds a capacity
    bound with drop-oldest semantics and drop accounting, a condition
    variable a consumer can block on (``wait``), and ``close`` to wake
    blocked consumers at shutdown."""

    def __init__(self, capacity: int = 512, device=None,
                 spill_dir: Optional[str] = None):
        if device is not None:
            raise NotImplementedError(
                "SignalChannel(device=...) is not ported yet (ROADMAP "
                "queue 1 item 2: asynchronous adaptation loop)")
        super().__init__(spill_dir=spill_dir, max_samples=capacity)
        self.capacity = capacity
        self.dropped = 0
        self.rejected_after_close = 0
        self.closed = False
        self._cond = threading.Condition(self._lock)

    # ------------------------------------------------------------- produce
    def add(self, batch: SignalBatch):
        with self._cond:
            if self.closed:
                # a closed channel has no consumer left: drop and count a
                # straggling producer's batch instead of buffering it
                self.rejected_after_close += 1
                return
            self._buf.append(batch)
            self.total_added += 1
            self.total_bytes += batch.feats.nbytes + batch.tokens.nbytes
            while len(self._buf) > self.capacity:
                self._buf.pop(0)
                self.dropped += 1
            self._cond.notify_all()

    # ------------------------------------------------------------- consume
    def wait(self, min_count: int = 1,
             timeout: Optional[float] = None) -> int:
        """Block until at least ``min_count`` batches are buffered, the
        channel is closed, or ``timeout`` elapses.  Returns the buffered
        count at wake-up."""
        with self._cond:
            self._cond.wait_for(
                lambda: self.closed or len(self._buf) >= min_count,
                timeout=timeout)
            return len(self._buf)

    def close(self):
        """Wake every waiter and reject later adds; what is buffered
        stays drainable, so one final drain empties the channel."""
        with self._cond:
            self.closed = True
            self._cond.notify_all()

    def reset(self):
        """Back to the post-construction state: empty buffer, zeroed
        push/drop/byte counters (``closed`` is preserved)."""
        with self._cond:
            self._buf.clear()
            self.total_added = 0
            self.total_bytes = 0
            self.dropped = 0
            self.rejected_after_close = 0

    # --------------------------------------------------------------- stats
    @property
    def depth(self) -> int:
        return self.peek_count()

    def stats(self) -> dict:
        return {"pushed": self.total_added, "dropped": self.dropped,
                "depth": self.peek_count(), "bytes": self.total_bytes,
                "rejected_after_close": self.rejected_after_close}

    def register_metrics(self, registry):
        """The channel as ``train.*`` callback gauges (read at snapshot
        time only: recording adds nothing to push or drain)."""
        registry.gauge("train.signals_pushed", fn=lambda: self.total_added)
        registry.gauge("train.signals_dropped", fn=lambda: self.dropped)
        registry.gauge("train.signals_rejected",
                       fn=lambda: self.rejected_after_close)
        registry.gauge("train.signal_bytes", fn=lambda: self.total_bytes)
        registry.gauge("train.channel_depth", fn=self.peek_count)
