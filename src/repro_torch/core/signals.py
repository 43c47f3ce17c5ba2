"""Zero-overhead training-signal extraction (paper §3.2 + Fig. 3); port
of ``repro/core/signals.py`` (host side: batches, store, extractor).

The target's capture features (concatenated low/mid/high hidden states)
are produced *inside* the already-running prefill/verify step — zero extra
forward passes (TIDE's C2 contribution).  This module is the host side:
a double-buffered ring that receives (features, tokens, mask) for accepted
positions, collecting one step late so the device→host copy of step t
can overlap step t+1, and spills full buffers to the shared store
consumed by the training engine.  The device arrays are torch tensors,
copied out with ``.cpu().numpy()`` when collected.
"""
from __future__ import annotations

import dataclasses
import os
import threading
from typing import Dict, List, Optional

import numpy as np
import torch


@dataclasses.dataclass
class SignalBatch:
    """One training sample: a contiguous token window with its features."""
    feats: np.ndarray       # (S, 3D)
    tokens: np.ndarray      # (S,)


def _host(x) -> np.ndarray:
    """A device tensor (or host array) as a host numpy array; bf16 is
    widened to fp32 (numpy has no bf16)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.numpy()
    return np.asarray(x)


# One schema for every serialized signal container: the offline .npz
# spill shards (``SignalStore.spill``/``load_shard``) and the fleet wire
# frames (the fleet's wire frames) both carry exactly this
# key layout, so a spilled shard can be replayed over the wire and a
# captured wire payload can be written down as a shard.  Per-batch keys
# (instead of one stacked array) keep the round trip lossless: window
# lengths may be ragged (residual windows at stream end) and dtypes are
# preserved exactly as captured.
SIGNAL_SCHEMA = "tide-signals/v1"


def pack_batches(batches: List[SignalBatch]) -> Dict[str, np.ndarray]:
    """Serialize batches into a flat ``{key: array}`` dict (the shared
    shard/wire schema).  Lossless: per-batch arrays keep their own
    shapes and dtypes; ``__schema__``/``__n__`` tag and count them."""
    out: Dict[str, np.ndarray] = {
        "__schema__": np.asarray(SIGNAL_SCHEMA),
        "__n__": np.asarray(len(batches), np.int64),
    }
    for i, b in enumerate(batches):
        out[f"feats_{i:06d}"] = np.asarray(b.feats)
        out[f"tokens_{i:06d}"] = np.asarray(b.tokens)
    return out


def unpack_batches(arrays) -> List[SignalBatch]:
    """Inverse of ``pack_batches`` (accepts any mapping of arrays — an
    open .npz file or a plain dict).  Validates the schema tag and that
    every counted batch is present; also accepts the legacy pre-schema
    stacked-shard layout (``feats``/``tokens`` only) for old shards."""
    keys = set(getattr(arrays, "files", None) or arrays.keys())
    if "__schema__" not in keys:
        if not {"feats", "tokens"} <= keys:
            raise ValueError(f"not a signal shard (keys {sorted(keys)})")
        feats, tokens = arrays["feats"], arrays["tokens"]   # legacy stack
        return [SignalBatch(feats=np.asarray(feats[i]),
                            tokens=np.asarray(tokens[i]))
                for i in range(feats.shape[0])]
    schema = str(np.asarray(arrays["__schema__"]))
    if schema != SIGNAL_SCHEMA:
        raise ValueError(f"unknown signal schema {schema!r} "
                         f"(expected {SIGNAL_SCHEMA!r})")
    n = int(np.asarray(arrays["__n__"]))
    out = []
    for i in range(n):
        fk, tk = f"feats_{i:06d}", f"tokens_{i:06d}"
        if fk not in keys or tk not in keys:
            raise ValueError(f"truncated signal shard: batch {i}/{n} "
                             "missing")
        out.append(SignalBatch(feats=np.asarray(arrays[fk]),
                               tokens=np.asarray(arrays[tk])))
    return out


def load_shard(path: str) -> List[SignalBatch]:
    """Load one spilled .npz shard back into batches (lossless inverse
    of ``SignalStore.spill``; legacy stacked shards still load)."""
    with np.load(path, allow_pickle=False) as data:
        return unpack_batches(data)


class SignalStore:
    """The 'shared storage' between the serving and training engines.

    In-memory FIFO with an optional .npz spill directory; the training
    engine polls ``drain``/``peek_count``.  Thread-safe (the serving loop
    and trainer may run in different threads in the live demo).
    """

    def __init__(self, spill_dir: Optional[str] = None,
                 max_samples: int = 100_000):
        self._lock = threading.Lock()
        self._buf: List[SignalBatch] = []
        self.spill_dir = spill_dir
        self.max_samples = max_samples
        self.total_added = 0
        self.total_bytes = 0
        if spill_dir:
            os.makedirs(spill_dir, exist_ok=True)

    def add(self, batch: SignalBatch):
        with self._lock:
            self._buf.append(batch)
            self.total_added += 1
            self.total_bytes += batch.feats.nbytes + batch.tokens.nbytes
            if len(self._buf) > self.max_samples:
                self._buf.pop(0)

    def peek_count(self) -> int:
        with self._lock:
            return len(self._buf)

    def drain(self, n: Optional[int] = None) -> List[SignalBatch]:
        with self._lock:
            if n is None:
                out, self._buf = self._buf, []
            else:
                out, self._buf = self._buf[:n], self._buf[n:]
            return out

    def spill(self, tag: str):
        """Flush the buffer to a schema-tagged .npz shard
        (offline-training parity).  Lossless and versioned: the shard
        uses the ``pack_batches`` schema (per-batch keys, exact shapes
        and dtypes, ``__schema__`` tag), so ragged residual windows
        survive and ``load_shard``/``load`` restore the batches
        bit-exactly."""
        if not self.spill_dir:
            return None
        batches = self.drain()
        if not batches:
            return None
        path = os.path.join(self.spill_dir, f"signals_{tag}.npz")
        np.savez_compressed(path, **pack_batches(batches))
        return path

    def load(self, path: str) -> int:
        """Re-ingest a spilled shard (inverse of ``spill``).  Returns
        the number of batches added."""
        batches = load_shard(path)
        for b in batches:
            self.add(b)
        return len(batches)


class SignalExtractor:
    """Per-request sliding windows of accepted-position signals.

    The serving engine calls ``offer`` each step with the step outputs
    (still on device — retrieval is deferred one step so the D2H copy of
    step t overlaps with the compute of step t+1, the paper's Fig. 3
    overlap, expressed through asynchronous dispatch).
    """

    def __init__(self, store: SignalStore, window: int = 64,
                 feat_dim: int = 0):
        self.store = store
        self.window = window
        self._pending = None     # device arrays from the previous step
        self._acc: Dict[int, List] = {}   # rid -> [(feat, tok), ...]
        self.enabled = True

    def reset(self):
        """Drop pending device arrays and partial windows (fresh run)."""
        self._pending = None
        self._acc = {}
        self.enabled = True

    def offer(self, rids, feats, tokens, mask):
        """feats (B,T,3D), tokens (B,T), mask (B,T) — device arrays for the
        just-dispatched step; the previous step's arrays are collected now
        (collected after this step is enqueued)."""
        prev, self._pending = self._pending, (list(rids), feats, tokens, mask)
        if prev is not None:
            self._collect(*prev)

    # ------------------------------------------------- superstep path
    def ingest_packed(self, rids, feats, tokens, counts):
        """Ingest one round of kernel-packed signals (host arrays).

        Row layout per the ``extract_pack`` kernel: accepted entries
        compacted to the front — ``counts[i]`` valid rows of
        ``feats[i]``/``tokens[i]`` for request ``rids[i]``, in original
        step order, so windows match the per-step ``offer`` path
        byte-for-byte.  Rows are copied out: a view would pin the whole
        superstep telemetry buffer until the window fills."""
        if not self.enabled:
            return
        for i, rid in enumerate(rids):
            n = int(counts[i])
            if n == 0:
                continue
            acc = self._acc.setdefault(rid, [])
            acc.extend(zip(np.array(feats[i, :n]), np.array(tokens[i, :n])))
            if len(acc) >= self.window:
                self._emit(rid)

    def flush(self):
        if self._pending is not None:
            prev, self._pending = self._pending, None
            self._collect(*prev)
        # emit all residual windows (end of workload)
        for rid in list(self._acc):
            self._emit(rid, force=True)

    def _collect(self, rids, feats, tokens, mask):
        if not self.enabled:
            return
        f = _host(feats)
        t = _host(tokens)
        m = _host(mask)
        for i, rid in enumerate(rids):
            sel = m[i].astype(bool)
            if not sel.any():
                continue
            acc = self._acc.setdefault(rid, [])
            acc.extend(zip(f[i][sel], t[i][sel]))
            if len(acc) >= self.window:
                self._emit(rid)

    def _emit(self, rid, force: bool = False):
        acc = self._acc.get(rid, [])
        while len(acc) >= self.window:
            chunk, acc = acc[:self.window], acc[self.window:]
            self.store.add(SignalBatch(
                feats=np.stack([c[0] for c in chunk]),
                tokens=np.array([c[1] for c in chunk], np.int32)))
        if force and len(acc) >= 8:   # short residual windows still usable
            self.store.add(SignalBatch(
                feats=np.stack([c[0] for c in acc]),
                tokens=np.array([c[1] for c in acc], np.int32)))
            acc = []
        self._acc[rid] = acc
        if force:
            self._acc.pop(rid, None)
