"""Page-granular KV memory for the continuous-batching engine — a copy of
the JAX package's ``serving/paging.py`` (pure numpy; the port imports
nothing of that package, and page ids must come out in the same order).

The dense engine backs every slot with a full ``(max_seq, ...)`` cache
row, so one long-budget request reserves worst-case memory for its whole
lifetime.  Here the cache is a pool of fixed-size pages shared by all
slots of a decode group; each slot owns an ordered list of page ids (its
page table) that grows as decode advances and is returned to the free
list when the slot retires.  The device side sees only a dense
``(n_rows, max_pages_per_slot)`` int32 page-map array (``-1`` marks an
unmapped logical page), so the jitted decode/prefill programs stay one
fixed-shape lowering regardless of which pages any slot holds.

Allocation policy: admission RESERVES the request's worst-case page count
(prompt + its own decode budget, page-rounded) so decode-time extension
can never fail mid-stream, but pages are HANDED OUT lazily as positions
are actually written — live-byte accounting (``live_pages``) therefore
reflects tokens resident, not tokens reserved, which is exactly the
number the migration cost model prices.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np


class PageExhaustedError(RuntimeError):
    """Raised when an admission asks for more pages than the pool can
    ever reserve — typed so the engine (and tests) can distinguish
    capacity pressure from programming errors."""


class PagedKVAllocator:
    """Host-side page bookkeeping for ONE decode group's page pool.

    The allocator never touches device memory: it hands out page ids from
    a free list and the engine mirrors them into the device page map.
    """

    def __init__(self, n_pages: int, page_size: int, n_rows: int,
                 max_pages_per_slot: int):
        if n_pages <= 0 or page_size <= 0:
            raise ValueError(f"need positive pool: n_pages={n_pages}, "
                             f"page_size={page_size}")
        self.n_pages = int(n_pages)
        self.page_size = int(page_size)
        self.n_rows = int(n_rows)
        self.max_pages_per_slot = int(max_pages_per_slot)
        # LIFO free list: retired pages are recycled hottest-first
        self._free: List[int] = list(range(self.n_pages - 1, -1, -1))
        self._pages: Dict[int, List[int]] = {}     # row -> live page ids
        self._reserved: Dict[int, int] = {}        # row -> reserved count

    # ------------------------------------------------------------ queries
    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def live_pages(self) -> int:
        """Pages actually holding tokens (not reservations)."""
        return sum(len(p) for p in self._pages.values())

    @property
    def reserved_pages(self) -> int:
        return sum(self._reserved.values())

    def pages_of(self, row: int) -> List[int]:
        return list(self._pages.get(row, ()))

    def pages_for(self, row: int) -> int:
        return len(self._pages.get(row, ()))

    def _need(self, n_tokens: int) -> int:
        return -(-int(n_tokens) // self.page_size)

    def can_admit(self, n_tokens: int, horizon: int) -> bool:
        """True when the pool can reserve ``horizon`` tokens' worth of
        pages right now (the admission gate — head-of-line blocking, the
        request waits for retires rather than failing mid-decode).  Other
        rows' outstanding reservations stay untouchable: they are entitled
        to extend without ever hitting the pool limit."""
        need = max(self._need(n_tokens), 1)
        reserve = max(self._need(horizon), need)
        return reserve <= self.max_pages_per_slot and \
            reserve + self.reserved_pages <= self.free_pages

    def admit(self, row: int, n_tokens: int, horizon: int) -> List[int]:
        """Reserve ``horizon`` tokens of pages for ``row`` and allocate
        the first ``n_tokens`` worth.  Returns the allocated page ids (in
        logical order)."""
        if row in self._pages:
            raise ValueError(f"row {row} already admitted")
        need = max(self._need(n_tokens), 1)
        reserve = max(self._need(horizon), need)
        if reserve > self.max_pages_per_slot:
            raise PageExhaustedError(
                f"request needs {reserve} pages > max_pages_per_slot="
                f"{self.max_pages_per_slot}")
        if reserve + self.reserved_pages > self.free_pages:
            raise PageExhaustedError(
                f"pool exhausted: need {reserve} pages, "
                f"{self.free_pages} free of which "
                f"{self.reserved_pages} already reserved "
                f"(pool {self.n_pages})")
        pages = [self._free.pop() for _ in range(need)]
        self._pages[row] = pages
        self._reserved[row] = reserve - need
        return list(pages)

    def extend(self, row: int, n_tokens: int) -> List[int]:
        """Grow ``row`` to cover ``n_tokens`` written positions, drawing
        from its admission reservation (admission guarantees the pages
        exist, so a live stream can never see exhaustion here).  Returns
        the FULL page list."""
        if row not in self._pages:
            raise ValueError(f"row {row} not admitted")
        need = self._need(n_tokens)
        grow = need - len(self._pages[row])
        if grow > 0:
            unreserved_free = self.free_pages - self.reserved_pages
            if need > self.max_pages_per_slot or \
                    grow > self._reserved[row] + max(unreserved_free, 0):
                raise PageExhaustedError(
                    f"row {row}: cannot extend to {need} pages "
                    f"({self._reserved[row]} reserved, "
                    f"{self.free_pages} free)")
            self._pages[row].extend(self._free.pop() for _ in range(grow))
            self._reserved[row] = max(self._reserved[row] - grow, 0)
        return list(self._pages[row])

    def release(self, row: int) -> int:
        """Return all of ``row``'s pages (and reservation) to the free
        list; returns how many live pages were freed."""
        pages = self._pages.pop(row, [])
        self._reserved.pop(row, None)
        self._free.extend(reversed(pages))
        return len(pages)

    # ------------------------------------------------------ device mirror
    def page_map_row(self, row: int) -> np.ndarray:
        """``row``'s device page-map row: live page ids right-padded with
        ``-1`` sentinels to the fixed per-slot width."""
        out = np.full((self.max_pages_per_slot,), -1, np.int32)
        pages = self._pages.get(row, ())
        out[:len(pages)] = pages
        return out

    def check_invariants(self):
        """Free + live == total, no page owned twice, no page both free
        and live (the property tests call this after every op)."""
        live = [p for pages in self._pages.values() for p in pages]
        assert len(live) == len(set(live)), "page aliased between slots"
        assert not (set(live) & set(self._free)), "page both live and free"
        assert len(live) + len(self._free) == self.n_pages, \
            f"leak: {len(live)} live + {len(self._free)} free != " \
            f"{self.n_pages}"
