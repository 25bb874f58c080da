"""PagedKVPool — host-side orchestration of block tables over the pool.

Copied from ``tpu_air/engine/kvpool/pool.py`` (host bookkeeping, no
device work; the port imports nothing of ``tpu_air``).

One instance per paged engine.  Owns the :class:`BlockAllocator`, the
optional :class:`PrefixCache`, and the authoritative block table
``[num_slots, pages_per_slot]`` (int32 page ids; NULL_PAGE marks entries
not yet reached — the fixed-shape decode step masks them).  The device
tensors themselves live in the engine's cache; everything here is
numpy/host bookkeeping decided BETWEEN device steps.

Admission policy (worst-case reservation): a request's pages — uncovered
prompt chunks plus its whole decode budget — are allocated up front, so a
request that admits can never hit OOM mid-flight; there is no preemption
path to need.  Prefix-shared pages are referenced, not copied, so a hit
admits with only the uncovered suffix's pages.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

# chunk-content hashes remembered for reprefill detection (bounded: the
# set answers "was this page's content ever resident?", not residency)
_SEEN_CHUNK_CAP = 4096

import numpy as np

from .allocator import NULL_PAGE, BlockAllocator
from .prefix import PrefixCache


@dataclass
class AdmitPlan:
    """What is left to compute for an admitted request.

    ``chunk_starts`` — page-aligned positions whose chunk still needs a
    prefill pass, in order.  For a fully-covered prompt this is just the
    final chunk (its pass only produces the first token's logits), run
    with ``null_target=True``: the chunk K/V is written to the null page —
    a scratch target — because every real page is shared; the gather
    inside the same chunk call reads the freshly written null page, so
    the logits are exact while the shared pages stay untouched.
    """

    prompt_len: int
    budget: int
    chunk_starts: List[int] = field(default_factory=list)
    null_target: bool = False
    prefix_tokens: int = 0       # tokens covered by the prefix cache
    shared_tail: bool = False    # tail page shared -> CoW before 1st append
    chunks_done: int = 0
    # tokens in chunk_starts whose content the prefix cache HELD at some
    # point and has since evicted: prefill work the machine repeats (the
    # perf ledger's "reprefill_cache_miss" goodput category)
    reprefill_tokens: int = 0

    @property
    def done(self) -> bool:
        return self.chunks_done >= len(self.chunk_starts)

    @property
    def chunks_left(self) -> int:
        return len(self.chunk_starts) - self.chunks_done

    @property
    def next_start(self) -> int:
        return self.chunk_starts[self.chunks_done]


class PagedKVPool:
    """Block tables + refcounts + prefix residency for one engine."""

    def __init__(self, num_pages: int, page_len: int, num_slots: int,
                 pages_per_slot: int, prefix_cache: bool = True):
        self.page_len = page_len
        self.pages_per_slot = pages_per_slot
        self.allocator = BlockAllocator(num_pages, page_len)
        self.prefix: Optional[PrefixCache] = (
            PrefixCache(self.allocator, page_len) if prefix_cache else None
        )
        self.block_table = np.zeros((num_slots, pages_per_slot), np.int32)
        # pages each slot holds a reference on (table entries + CoW reserve)
        self._held: List[List[int]] = [[] for _ in range(num_slots)]
        self._cow_reserve: List[Optional[int]] = [None] * num_slots
        self._plans: List[Optional[AdmitPlan]] = [None] * num_slots
        self.cow_copies = 0
        # LRU set of page-content hashes ever published to the prefix cache
        # (register); admit consults it to flag re-prefilled chunks
        self._seen_chunks: "OrderedDict[int, None]" = OrderedDict()
        self.reprefill_tokens = 0

    # -- capacity ------------------------------------------------------------
    def _total_pages(self, prompt_len: int, budget: int) -> int:
        # last written position: prompt end (prefill) plus budget-1 decode
        # scatters (the final emitted token is computed, never written)
        last_write = prompt_len + budget - 2 if budget > 1 else prompt_len - 1
        return last_write // self.page_len + 1

    def worst_case_pages(self, prompt_len: int, budget: int) -> int:
        """Pages the request needs with ZERO prefix sharing — the engine's
        admission reservation (a prior admit in the same round can both
        evict a probe-time match and pin previously evictable pages, so
        the no-sharing bound is exactly what one round can consume)."""
        return self._total_pages(prompt_len, budget)

    def pages_needed(self, prompt, budget: int) -> int:
        """Private pages a request would allocate NOW (read-only probe —
        no LRU/stat side effects)."""
        total = self._total_pages(len(prompt), budget)
        covered = 0
        if self.prefix is not None:
            covered = len(self.prefix.match(prompt, touch=False).pages)
        return max(0, total - covered)

    def capacity(self) -> int:
        """Pages obtainable right now: free + immediately evictable."""
        cap = self.allocator.free_count()
        if self.prefix is not None:
            cap += self.prefix.evictable_count()
        return cap

    # -- admission -----------------------------------------------------------
    def admit(self, slot: int, prompt, budget: int,
              share: bool = True) -> AdmitPlan:
        """Reserve every page the request can touch, share what the prefix
        cache covers, and return the chunk work list.

        ``share=False`` skips prefix matching and allocates every page
        fresh — the disaggregated handoff path (engine/dist/): shipped KV
        pages are about to be WRITTEN into this slot's pages, and a write
        must never land on a page other holders read."""
        C = self.page_len
        n = len(prompt)
        total = self._total_pages(n, budget)
        assert total <= self.pages_per_slot, (total, self.pages_per_slot)

        match = (self.prefix.match(prompt)
                 if share and self.prefix is not None else None)
        shared = list(match.pages) if match else []
        tail_page = match.tail_page if match else None
        prefix_tokens = match.matched_tokens if match else 0

        need = total - len(shared)
        free = self.allocator.free_count()
        if need > free and self.prefix is not None:
            self.prefix.evict(need - free)
        fresh = [self.allocator.alloc() for _ in range(need)]

        row = self.block_table[slot]
        held = self._held[slot]
        k = len(shared)
        for idx, page in enumerate(shared):
            self.allocator.incref(page)
            row[idx] = page
            held.append(page)
        if tail_page is not None:
            # partial-tail share: the tail entry points at the shared page;
            # one fresh page is set aside as the copy-on-write destination
            # for the first divergent append (never placed until then)
            self.allocator.incref(tail_page)
            row[k] = tail_page
            held.append(tail_page)
            self._cow_reserve[slot] = fresh[0]
            held.append(fresh[0])
            rest = fresh[1:]
            start = k + 1
        else:
            rest = fresh
            start = k
        for off, page in enumerate(rest):
            row[start + off] = page
            held.append(page)

        full_cover = prefix_tokens >= n or (k * C >= n)
        if full_cover:
            chunk_starts = [((n - 1) // C) * C]
        else:
            chunk_starts = list(range(k * C, n, C))
        # reprefill detection: a full chunk about to be computed whose
        # content hash register() once published means the cache HAD this
        # K/V and evicted it — repeated work, not a cold miss.  (full_cover
        # plans re-run one chunk for logits only; that is inherent, not
        # waste.  share=False is the disagg handoff — no local compute.)
        reprefill = 0
        if share and self.prefix is not None and not full_cover:
            for start in chunk_starts:
                if (start + C <= n
                        and self._chunk_key(prompt, start)
                        in self._seen_chunks):
                    reprefill += C
        self.reprefill_tokens += reprefill
        plan = AdmitPlan(
            prompt_len=n, budget=budget, chunk_starts=chunk_starts,
            null_target=full_cover, prefix_tokens=prefix_tokens,
            shared_tail=tail_page is not None, reprefill_tokens=reprefill,
        )
        self._plans[slot] = plan
        return plan

    def _chunk_key(self, prompt, start: int) -> int:
        """Content key for the page-aligned chunk at ``start``: the hash
        covers the WHOLE prefix through the chunk's end, because a chunk's
        K/V depends on everything before it."""
        return hash(tuple(prompt[:start + self.page_len]))

    # -- prefill support -----------------------------------------------------
    def chunk_row(self, slot: int, start: int, null_target: bool) -> np.ndarray:
        """The block-table row a prefill chunk call should see.  With
        ``null_target`` the chunk's own entry is redirected to the null
        page (scratch write; shared pages stay pristine) — a COPY, the
        authoritative table is untouched."""
        row = self.block_table[slot]
        if not null_target:
            return row.copy()
        tmp = row.copy()
        tmp[start // self.page_len] = NULL_PAGE
        return tmp

    def prompt_page_ids(self, slot: int, n_tokens: int) -> List[int]:
        """The page ids holding the first ``n_tokens`` positions of the
        slot's context — the pages a disaggregated KV handoff ships/fills
        (engine/dist/kv_transfer.py)."""
        n_pages = -(-n_tokens // self.page_len)
        return [int(p) for p in self.block_table[slot][:n_pages]]

    def register(self, slot: int, prompt) -> int:
        """Publish the slot's full prompt chunks to the prefix cache (after
        its prefill completed — the pages now hold the prompt's K/V)."""
        if self.prefix is None:
            return 0
        C = self.page_len
        full = len(prompt) // C
        for i in range(full):
            key = self._chunk_key(prompt, i * C)
            self._seen_chunks[key] = None
            self._seen_chunks.move_to_end(key)
        while len(self._seen_chunks) > _SEEN_CHUNK_CAP:
            self._seen_chunks.popitem(last=False)
        return self.prefix.insert(prompt, list(self.block_table[slot][:full]))

    def resolve_cow(self, slot: int) -> Optional[Tuple[int, int]]:
        """Copy-on-write before the slot's first decode append: if the tail
        page is shared, repoint the table at the reserved private page and
        return ``(dst, src)`` for the device-side page copy (caller runs
        it).  The shared source keeps its other holders."""
        plan = self._plans[slot]
        if plan is None or not plan.shared_tail:
            return None
        tail_idx = plan.prompt_len // self.page_len
        src = int(self.block_table[slot][tail_idx])
        dst = self._cow_reserve[slot]
        assert dst is not None
        self.block_table[slot][tail_idx] = dst
        self._cow_reserve[slot] = None
        # the slot no longer references the shared source
        self._held[slot].remove(src)
        self.allocator.decref(src)
        plan.shared_tail = False
        self.cow_copies += 1
        return dst, src

    # -- retirement ----------------------------------------------------------
    def release(self, slot: int) -> None:
        for page in self._held[slot]:
            self.allocator.decref(page)
        self._held[slot] = []
        self._cow_reserve[slot] = None
        self._plans[slot] = None
        self.block_table[slot].fill(NULL_PAGE)

    # -- observability -------------------------------------------------------
    def stats(self) -> dict:
        out = {
            "pages_total": self.allocator.num_pages - 1,
            "pages_free": self.allocator.free_count(),
            "pages_used": self.allocator.used_count(),
            "page_len": self.page_len,
            "cow_copies": self.cow_copies,
            "reprefill_tokens": self.reprefill_tokens,
        }
        if self.prefix is not None:
            p = self.prefix
            looked = p.hits + p.misses
            out.update(
                prefix_resident_pages=p.resident_pages(),
                prefix_hits=p.hits,
                prefix_misses=p.misses,
                prefix_partial_hits=p.partial_hits,
                prefix_tokens_reused=p.tokens_reused,
                prefix_evictions=p.evictions,
                prefix_hit_rate=(p.hits / looked) if looked else 0.0,
            )
        return out
