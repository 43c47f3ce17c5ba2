"""Signal transport between the serving and training engines (port of
``repro/core/transport.py``).

The ``SignalChannel`` is the seam between the two: the serving engine's
superstep unpack pushes packed ``SignalBatch`` windows into a bounded,
drop-oldest ring, and the training service drains the other end.
Dropping the oldest under backpressure is the right policy for online
adaptation: a slow trainer should see the freshest distribution, and
serving never blocks on training.

Placement: on a one-card host the channel is a host ring and the trainer
runs on a background thread of the serving process, on a CUDA stream of
its own (``training/service.py``).  On a host with more cards,
``pick_training_device`` picks a training card with the ``core/hetero``
allocation model, and the channel puts each batch on it as it is
enqueued (``_prepare``): from pinned host memory, without blocking, on a
copy stream of that card, never on the serving thread's stream.  The
trainer waits for the copy on its own stream (``wait_ready``).
"""
from __future__ import annotations

import dataclasses
import threading
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core.signals import SignalBatch, SignalStore


def pick_training_device(s: float = 1.2) -> Optional[torch.device]:
    """Place the draft trainer: carve training cards out of the host's
    CUDA cards with the paper's allocation model
    (``hetero.plan_tpu_submesh``), or return None below two cards (the
    trainer then runs on a background thread beside serving).  ``s`` is
    the speculative speedup assumed unlocked by online training (paper
    Fig. 12).  The trainer gets the first of the last ``train_chips``
    cards (at least one), as JAX picks from its device list."""
    from repro_torch.core.hetero import plan_tpu_submesh

    n = torch.cuda.device_count()
    if n < 2:
        return None
    plan = plan_tpu_submesh(n, s)
    return torch.device("cuda", n - max(plan.train_chips, 1))


@dataclasses.dataclass
class PlacedBatch(SignalBatch):
    """A ``SignalBatch`` whose tensors were put on a CUDA card by a copy
    stream; ``ready`` is the event after the copies, which a consumer's
    stream waits on before it reads them (``wait_ready``)."""
    ready: Optional[torch.cuda.Event] = None


def wait_ready(batches: List[SignalBatch]):
    """Order the current stream after the copies of every ``PlacedBatch``
    in ``batches``, and tell the caching allocator that this stream reads
    their tensors (their blocks belong to the copy stream, which must not
    reuse them while this stream's reads are queued).  A no-op for host
    batches and CPU tensors."""
    for b in batches:
        if getattr(b, "ready", None) is None:
            continue
        stream = torch.cuda.current_stream(b.feats.device)
        stream.wait_event(b.ready)
        b.feats.record_stream(stream)
        b.tokens.record_stream(stream)


class SignalChannel(SignalStore):
    """Bounded drop-oldest channel from the signal extractor to the
    training service.

    Duck-types ``SignalStore`` (``add``/``drain``/``peek_count``) so the
    ``SignalExtractor`` writes into it unchanged, and adds a capacity
    bound with drop-oldest semantics and drop accounting, a condition
    variable a consumer can block on (``wait``), producer-side placement
    on the trainer's device (``device``), and ``close`` to wake blocked
    consumers at shutdown."""

    def __init__(self, capacity: int = 512, device=None,
                 spill_dir: Optional[str] = None):
        super().__init__(spill_dir=spill_dir, max_samples=capacity)
        self.capacity = capacity
        self.device = None if device is None else torch.device(device)
        self._copy_stream = None          # made at the first CUDA copy
        self.dropped = 0
        self.rejected_after_close = 0
        self.closed = False
        self._cond = threading.Condition(self._lock)

    # ------------------------------------------------------------- produce
    def _prepare(self, batch: SignalBatch) -> SignalBatch:
        """Producer-side placement hook, run outside the lock.  With a
        ``device`` the batch's arrays become tensors there, dtypes kept.
        On a CUDA card the host arrays are pinned and copied without
        blocking on the channel's own copy stream of that card (never the
        caller's stream), and the batch carries the event after the
        copies (``PlacedBatch.ready``)."""
        if self.device is None:
            return batch
        feats = torch.from_numpy(np.ascontiguousarray(batch.feats))
        tokens = torch.from_numpy(np.ascontiguousarray(batch.tokens))
        if self.device.type != "cuda":
            return SignalBatch(feats=feats.to(self.device),
                               tokens=tokens.to(self.device))
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(device=self.device)
        with torch.cuda.stream(self._copy_stream):
            feats = feats.pin_memory().to(self.device, non_blocking=True)
            tokens = tokens.pin_memory().to(self.device, non_blocking=True)
            ready = self._copy_stream.record_event()
        return PlacedBatch(feats=feats, tokens=tokens, ready=ready)

    def add(self, batch: SignalBatch):
        if self.closed:
            # a closed channel has no consumer left: drop and count a
            # straggling producer's batch instead of buffering it
            with self._cond:
                self.rejected_after_close += 1
            return
        batch = self._prepare(batch)
        with self._cond:
            if self.closed:   # close() raced the placement above
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
