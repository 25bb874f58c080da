"""Refcounted page allocator over the engine's device-resident KV pool.

Copied from ``tpu_air/engine/kvpool/allocator.py`` (host bookkeeping, no
device work; the port imports nothing of ``tpu_air``).

The device side is a set of per-layer arrays ``[num_pages, page_len, h*d]``
owned (and written in place by every step) by the engine; this class is
the host-side authority over which of those ``num_pages`` rows are free,
and how many holders each allocated row has.  Holders are block-table
entries of live slots plus (at most) one residency reference from the
:class:`~tpu_air_torch.engine.kvpool.prefix.PrefixCache`.

Page 0 is the NULL page: permanently pinned, never handed out.  Block
table entries of free slots and not-yet-reached positions all point at it,
so the fixed-shape decode step always has a legal (masked, don't-care)
gather/scatter target without per-step host fixups.
"""

from __future__ import annotations

from typing import List

from tpu_air_torch.core.runtime import TpuAirError

NULL_PAGE = 0


class KVPoolOOMError(TpuAirError):
    """No free page in the KV pool.  The engine never lets this escape to
    callers — admission capacity-checks (with prefix-cache eviction
    headroom) before allocating — so reaching it means an accounting bug
    or direct allocator misuse."""


class BlockAllocator:
    """Free-list + refcounts over ``num_pages`` physical KV pages."""

    def __init__(self, num_pages: int, page_len: int):
        if num_pages < 2:
            raise ValueError(
                f"num_pages must be >= 2 (page 0 is the null page), "
                f"got {num_pages}"
            )
        if page_len < 1:
            raise ValueError(f"page_len must be >= 1, got {page_len}")
        self.num_pages = num_pages
        self.page_len = page_len
        self._ref: List[int] = [0] * num_pages
        self._ref[NULL_PAGE] = 1  # pinned forever
        # pop() takes from the end: keep descending so alloc hands out the
        # lowest free id first (deterministic page placement, mirroring the
        # slot manager's lowest-row-first discipline)
        self._free: List[int] = list(range(1, num_pages))[::-1]

    # -- capacity ------------------------------------------------------------
    def free_count(self) -> int:
        return len(self._free)

    def used_count(self) -> int:
        """Allocated pages, excluding the pinned null page."""
        return self.num_pages - 1 - len(self._free)

    # -- lifecycle -----------------------------------------------------------
    def alloc(self) -> int:
        """Hand out a free page with refcount 1."""
        if not self._free:
            raise KVPoolOOMError(
                f"KV pool exhausted ({self.num_pages - 1} pages, 0 free)"
            )
        page = self._free.pop()
        assert self._ref[page] == 0, "free-list page with live refs"
        self._ref[page] = 1
        return page

    def incref(self, page: int) -> None:
        if not 0 < page < self.num_pages:
            raise ValueError(f"bad page id {page}")
        if self._ref[page] == 0:
            raise ValueError(f"incref on free page {page}")
        self._ref[page] += 1

    def decref(self, page: int) -> bool:
        """Drop one reference; returns True when the page went back to the
        free list.  No device-side zeroing — stale bytes in a reused page
        are masked until overwritten (the slab engine's r5 discipline)."""
        if not 0 < page < self.num_pages:
            raise ValueError(f"bad page id {page}")
        if self._ref[page] <= 0:
            raise ValueError(f"decref on free page {page}")
        self._ref[page] -= 1
        if self._ref[page] == 0:
            # keep descending so the next alloc still hands out lowest-first
            self._free.append(page)
            self._free.sort(reverse=True)
            return True
        return False

    def refcount(self, page: int) -> int:
        return self._ref[page]
