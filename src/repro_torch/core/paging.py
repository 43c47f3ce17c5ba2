"""Paged KV cache: block-table allocator and copy-on-write prefix sharing
(port of ``repro/core/paging.py``; ``SpillStore`` is not ported yet).

  * **Page pools.**  Each attention K/V leaf is a pool of ``num_pages + 1``
    pages ``(num_pages + 1, P, Hk, D)``; page ``num_pages`` is the *trash
    page*, where every write goes that dense decoding would drop
    (positions past ``max_len``, masked refill lanes, unreserved table
    entries), so an inactive lane can never clobber a mapped page.
  * **One block table per lane.**  A host-authoritative ``(batch,
    max_len // P)`` int32 numpy table maps token ranges to pages; the
    same table serves every target layer's pools and the draft's.
  * **Admission by pages.**  Lanes reserve ``ceil(tokens / P)`` pages at
    admission; the scheduler's admission guard defers what the pool
    cannot cover.
  * **Refcounted COW prefix sharing.**  Committed prompt-prefix pages are
    published to a registry keyed by provenance ``(rows, width, pad,
    token prefix, draft deploy seq)``: two lanes with equal keys hold
    equal page bytes, so a borrower adopts the donor's pages with no
    device compare.

Differences from the JAX module: the device helpers update the pools
**in place** (JAX returns new arrays that XLA writes into donated
buffers), and ``table_device`` is an asynchronous host-to-device copy
from pinned memory.  Several lanes may route a write to the trash page
in one call; which one lands there is undefined, which is harmless
because nothing reads the trash page as a visible key.  A real page never
receives two writes in one call: each lane's table maps its own pages,
and shared prefix pages lie below every position a lane writes.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch


# ===================================================== device helpers
def gather_view(pool: torch.Tensor, tbl: torch.Tensor) -> torch.Tensor:
    """The dense per-lane view of a page pool: pool (NP + 1, P, ...),
    tbl (B, n_tbl) -> (B, n_tbl * P, ...), a new tensor."""
    b, n_tbl = tbl.shape
    view = pool[tbl.long()]                       # (B, n_tbl, P, ...)
    return view.reshape((b, n_tbl * pool.shape[1]) + tuple(pool.shape[2:]))


def page_slot(tbl: torch.Tensor, page_size: int, pos: torch.Tensor,
              trash: int, valid: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Map (B, T) token positions to (page, slot) through the block
    table.  Positions ``>= n_tbl * P`` and positions with ``valid``
    False go to the trash page."""
    n_tbl = tbl.shape[1]
    pos = pos.long()
    idx = torch.clamp(pos // page_size, 0, n_tbl - 1)
    page = torch.gather(tbl.long(), 1, idx)
    ok = pos < n_tbl * page_size
    if valid is not None:
        ok = ok & valid
    page = torch.where(ok, page, torch.full_like(page, trash))
    return page, pos % page_size


def scatter_kv_paged(pool: torch.Tensor, tbl: torch.Tensor,
                     new: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Write the decode block's K/V rows ``new`` (B, T, Hk, D) at
    positions ``lengths + [0, T)`` through the block table, in place.
    pool: (NP + 1, P, Hk, D).  Returns ``pool``."""
    t = new.shape[1]
    pos = lengths[:, None].long() + torch.arange(t, device=pool.device)[None]
    page, slot = page_slot(tbl, pool.shape[1], pos, pool.shape[0] - 1)
    pool[page, slot] = new.to(pool.dtype)
    return pool


def write_rows_paged(pool: torch.Tensor, tbl: torch.Tensor,
                     rows: torch.Tensor,
                     mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Write whole per-lane rows ``rows`` (B, W, Hk, D) at positions
    [0, W) through the table, in place; lanes with ``mask`` False (and
    positions past the table) write to the trash page.  Returns
    ``pool``."""
    b, w = rows.shape[:2]
    pos = torch.arange(w, device=pool.device)[None].expand(b, w)
    valid = None if mask is None else mask[:, None].expand(b, w)
    page, slot = page_slot(tbl, pool.shape[1], pos, pool.shape[0] - 1,
                           valid=valid)
    pool[page, slot] = rows.to(pool.dtype)
    return pool


def gather_rows_paged(pool: torch.Tensor, tbl_rows: torch.Tensor,
                      width: int) -> torch.Tensor:
    """The first ``width`` positions of each table row as a dense
    (R, width, ...) block; tbl_rows: (R, m) with m * P >= width."""
    m = -(-width // pool.shape[1])
    return gather_view(pool, tbl_rows[:, :m])[:, :width]


def copy_page(pool: torch.Tensor, src: int, dst: int) -> torch.Tensor:
    """The device half of a COW fork: duplicate one page's bytes, in
    place."""
    pool[dst] = pool[src]
    return pool


# ================================================== host-side allocator
class PageAllocator:
    """Free-list page allocator and refcounted prefix registry.

    All state is host-side numpy and ints; the device sees copies of
    ``table`` that the engine ships between dispatches.  A lane's table
    row holds one reference per mapped page and every registry entry one
    per published page, so a shared prefix page outlives its donor lane
    until the registry evicts it."""

    def __init__(self, num_pages: int, page_size: int, batch: int,
                 max_len: int, *, share_prefix: bool = True,
                 registry_cap: int = 256):
        if max_len % page_size:
            raise ValueError(
                f"max_len {max_len} must be a multiple of page_size "
                f"{page_size} (block tables cover exact token ranges)")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self.batch = int(batch)
        self.max_len = int(max_len)
        self.n_tbl = max_len // page_size
        self.trash = self.num_pages
        self.share_prefix = bool(share_prefix)
        self.registry_cap = int(registry_cap)
        self.reset()

    def reset(self):
        self.table = np.full((self.batch, self.n_tbl), self.trash,
                             dtype=np.int32)
        self.ref = np.zeros((self.num_pages,), dtype=np.int64)
        self._free: List[int] = list(range(self.num_pages - 1, -1, -1))
        # provenance key -> (page ids, n_pages); insertion order = LRU
        self._registry: "OrderedDict[bytes, Tuple[Tuple[int, ...], int]]" \
            = OrderedDict()
        self.dirty = True          # table changed since the last ship
        self.peak_in_use = 0
        self.prefix_hits = 0
        self.prefix_tokens_saved = 0
        self.evictions = 0
        self.cow_forks = 0

    # ------------------------------------------------------------ stats
    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        return self.num_pages - len(self._free)

    def register_metrics(self, registry):
        """Allocator telemetry as ``paging.*`` callback gauges (read only
        at snapshot time)."""
        for name, fn in (
                ("pages_in_use", lambda: self.pages_in_use),
                ("pages_free", lambda: self.free_pages),
                ("pages_peak", lambda: self.peak_in_use),
                ("prefix_hits", lambda: self.prefix_hits),
                ("prefix_tokens_saved", lambda: self.prefix_tokens_saved),
                ("evictions", lambda: self.evictions),
                ("cow_forks", lambda: self.cow_forks)):
            registry.gauge(f"paging.{name}", fn=fn)

    def _note_use(self):
        self.peak_in_use = max(self.peak_in_use, self.pages_in_use)

    # ---------------------------------------------------------- refcount
    def _incref(self, page: int):
        self.ref[page] += 1

    def _decref(self, page: int):
        self.ref[page] -= 1
        if self.ref[page] < 0:
            raise AssertionError(f"page {page} double-freed")
        if self.ref[page] == 0:
            self._free.append(page)

    def _alloc(self, n: int) -> List[int]:
        pages = [self._free.pop() for _ in range(n)]
        for pg in pages:
            self._incref(pg)
        self._note_use()
        return pages

    # -------------------------------------------------------- reservations
    def pages_for(self, tokens: int) -> int:
        """Pages covering a ``tokens``-position reservation (clamped to
        the lane window)."""
        return -(-min(tokens, self.max_len) // self.page_size)

    def can_reserve(self, tokens: int) -> bool:
        return self.can_fit(self.pages_for(tokens))

    def can_fit(self, pages: int) -> bool:
        """Could ``pages`` fresh pages be allocated now, counting idle
        registry prefixes an eviction sweep would free?"""
        return len(self._free) + self._evictable() >= pages

    def reserve(self, lane: int, tokens: int) -> bool:
        """Map fresh pages over positions [0, tokens) of ``lane``.
        Returns False, with the lane untouched, when the pool cannot
        cover it."""
        if (self.table[lane] != self.trash).any():
            raise AssertionError(f"lane {lane} already holds pages")
        need = self.pages_for(tokens)
        if len(self._free) < need:
            self._evict(need - len(self._free))
        if len(self._free) < need:
            return False
        self.table[lane, :need] = self._alloc(need)
        self.dirty = True
        return True

    def free_lane(self, lane: int):
        """Release every page the lane maps (idempotent)."""
        row = self.table[lane]
        for i in range(self.n_tbl):
            if row[i] != self.trash:
                self._decref(int(row[i]))
                row[i] = self.trash
                self.dirty = True

    def lane_pages(self, lane: int) -> int:
        return int((self.table[lane] != self.trash).sum())

    # ------------------------------------------------------------- sharing
    def prefix_key(self, rows: int, width: int, pad: int,
                   tokens: Sequence[int], n_pages: int,
                   salt: int = 0) -> bytes:
        """Provenance key of one lane's first ``n_pages`` prompt pages:
        the refill op's row count and width, the lane's left pad, the
        token columns [0, n_pages * P + 1) (one past the pages: the
        draft cache stores (capture_i, token_{i+1}) pairs), and ``salt``
        (the engine's draft deploy sequence number).  The same bytes as
        the JAX allocator's key."""
        n_tok = n_pages * self.page_size + 1
        h = hashlib.sha256()
        h.update(np.asarray([rows, width, pad, n_pages, self.page_size,
                             salt], dtype=np.int64).tobytes())
        h.update(np.asarray(list(tokens[:n_tok]), dtype=np.int64).tobytes())
        return h.digest()

    def publish(self, key: bytes, lane: int, n_pages: int):
        """Register the lane's first ``n_pages`` pages under ``key`` (one
        registry reference per page).  First writer wins."""
        if not self.share_prefix or n_pages <= 0:
            return
        if key in self._registry:
            self._registry.move_to_end(key)
            return
        pages = tuple(int(p) for p in self.table[lane, :n_pages])
        if any(p == self.trash for p in pages):
            raise AssertionError("publishing unmapped pages")
        for pg in pages:
            self._incref(pg)
        self._registry[key] = (pages, n_pages)
        if len(self._registry) > self.registry_cap:
            self._evict(0, force_one=True)

    def lookup(self, key: bytes) -> Optional[Tuple[int, ...]]:
        """Shared pages for ``key`` (LRU-touched), or None."""
        if not self.share_prefix:
            return None
        hit = self._registry.get(key)
        if hit is None:
            return None
        self._registry.move_to_end(key)
        return hit[0]

    def adopt(self, lane: int, pages: Sequence[int]):
        """Repoint the lane's leading table entries at shared pages,
        releasing the lane's own pages for that range."""
        for i, pg in enumerate(pages):
            old = int(self.table[lane, i])
            if old == int(pg):
                continue
            self._incref(int(pg))
            if old != self.trash:
                self._decref(old)
            self.table[lane, i] = int(pg)
            self.dirty = True
        self.prefix_hits += 1
        self.prefix_tokens_saved += len(pages) * self.page_size
        self._note_use()

    def fork_for_write(self, lane: int, idx: int
                       ) -> Optional[Tuple[int, int]]:
        """Copy-on-write fork: make ``table[lane, idx]`` exclusive before
        a divergent write.  Returns (src, dst) for ``copy_page``, or None
        when the page was already exclusive."""
        page = int(self.table[lane, idx])
        if page == self.trash:
            raise AssertionError("forking an unmapped table entry")
        if self.ref[page] == 1:
            return None
        if not self._free:
            self._evict(1)
        if not self._free:
            raise RuntimeError("page pool exhausted during COW fork")
        (new,) = self._alloc(1)
        self._decref(page)
        self.table[lane, idx] = new
        self.dirty = True
        self.cow_forks += 1
        return page, new

    # ------------------------------------------------------------ eviction
    def _evictable(self) -> int:
        """Pages an LRU registry sweep could free now (entries no lane
        maps)."""
        n = 0
        for pages, _ in self._registry.values():
            if all(self.ref[pg] == 1 for pg in pages):
                n += len(pages)
        return n

    def _evict(self, want_free: int, force_one: bool = False):
        """Drop LRU registry entries until ``want_free`` pages could be
        freed (entries a lane still maps free nothing and are kept)."""
        freed = 0
        dropped = False
        for key in list(self._registry):
            if freed >= want_free and not (force_one and not dropped):
                break
            pages, _ = self._registry[key]
            if not all(self.ref[pg] == 1 for pg in pages):
                continue
            del self._registry[key]
            for pg in pages:
                self._decref(pg)
            freed += len(pages)
            dropped = True
            self.evictions += 1

    def release_prefix_cache(self):
        """Drop every registry entry (stream drain, leak check)."""
        for key in list(self._registry):
            pages, _ = self._registry.pop(key)
            for pg in pages:
                self._decref(pg)

    # ---------------------------------------------------------- invariants
    def assert_clean(self):
        """Leak check: every lane released, registry empty, every page
        free with refcount zero."""
        if self._registry:
            raise AssertionError(
                f"{len(self._registry)} prefix registry entries leaked")
        if (self.table != self.trash).any():
            held = int((self.table != self.trash).sum())
            raise AssertionError(f"{held} table entries still mapped")
        if (self.ref != 0).any():
            raise AssertionError(
                f"nonzero refcounts: {np.nonzero(self.ref)[0].tolist()}")
        if len(self._free) != self.num_pages:
            raise AssertionError(
                f"free list holds {len(self._free)}/{self.num_pages} pages")

    def table_device(self, device) -> torch.Tensor:
        """A new device copy of the block table (see ``to_device``)."""
        return to_device(self.table, device)


def to_device(arr: np.ndarray, device) -> torch.Tensor:
    """A new device tensor holding a copy of the host array ``arr``.

    On a CUDA device the copy goes through pinned memory and is enqueued
    on the current stream with ``non_blocking=True``: the host never
    waits for it.  The pinned block comes from PyTorch's caching host
    allocator, which records an event on the stream for each such copy
    and reuses the block only after that event has passed, so the host
    may drop its reference (and change ``arr``) at once.  On the CPU it
    is a plain copy."""
    host = torch.from_numpy(np.array(arr, copy=True))
    device = torch.device(device)
    if device.type != "cuda":
        return host.to(device)
    return host.pin_memory().to(device, non_blocking=True)
