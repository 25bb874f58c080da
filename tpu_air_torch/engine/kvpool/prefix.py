"""Prefix cache: radix tree over page-sized token chunks → physical pages.

Copied from ``tpu_air/engine/kvpool/prefix.py`` (host bookkeeping, no
device work; the port imports nothing of ``tpu_air``).

Prompts are split into ``page_len``-token chunks; each radix edge is one
chunk labelled by its exact token ids and carrying the physical page that
holds that chunk's K/V.  A lookup walks full chunks from the root, so two
prompts sharing a system-prompt prefix resolve their leading block-table
entries to the SAME pages — admission then prefills only the uncovered
suffix.

Sharing granularity:

* **full chunks** — an edge matches iff all ``page_len`` tokens match.
* **partial tail** — when every full chunk matched and the prompt's final
  partial chunk is a PREFIX of some child edge's tokens, that edge's page
  is shared too (the extra positions are masked by the per-slot validity
  mask, so they are invisible).  The first append into such a page — the
  request's first decode token — diverges from the cached content, so the
  engine copies the page first: copy-on-write, resolved host-side by
  :class:`~tpu_air_torch.engine.kvpool.pool.PagedKVPool`.

Residency: the cache holds ONE allocator reference per resident page, so
pages of retired requests survive for future hits.  When the pool runs
dry, :meth:`evict` drops least-recently-used *leaf* edges whose page has
no other holder (refcount 1 — the cache itself); interior edges only
become evictable once their subtree is gone, keeping every cached path
walkable from the root.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .allocator import BlockAllocator


class _Node:
    __slots__ = ("children",)

    def __init__(self):
        # chunk token-tuple -> _Edge; insertion-ordered (dict), LRU decided
        # by edge ticks, not ordering
        self.children: Dict[Tuple[int, ...], "_Edge"] = {}


class _Edge:
    __slots__ = ("page", "child", "tick")

    def __init__(self, page: int, tick: int):
        self.page = page
        self.child = _Node()
        self.tick = tick


@dataclass
class PrefixMatch:
    """Result of one lookup.

    ``pages`` — physical pages for the matched FULL chunks, in block-table
    order.  ``tail_page`` — a shared partial-tail page (or None); when set,
    the whole prompt is covered and the engine owes a copy-on-write before
    the first decode append.  ``matched_tokens`` counts full-chunk tokens
    plus the partial tail.  The caller owns taking refs (via
    ``BlockAllocator.incref``) on any page it actually uses.
    """

    pages: List[int] = field(default_factory=list)
    matched_tokens: int = 0
    tail_page: Optional[int] = None


class PrefixCache:
    """Radix-over-chunks prefix index bound to one :class:`BlockAllocator`."""

    def __init__(self, allocator: BlockAllocator, page_len: int):
        self.allocator = allocator
        self.page_len = page_len
        self._root = _Node()
        self._tick = 0
        self._resident = 0  # edges (== cache-held pages)
        # stats (host counters; surfaced through EngineMetrics)
        self.hits = 0
        self.misses = 0
        self.partial_hits = 0
        self.tokens_reused = 0
        self.evictions = 0

    # -- lookup --------------------------------------------------------------
    def match(self, tokens, touch: bool = True) -> PrefixMatch:
        """Longest shared prefix of ``tokens``; read-only when ``touch`` is
        False (admission capacity probes must not bump LRU or stats)."""
        C = self.page_len
        tokens = list(tokens)
        n = len(tokens)
        out = PrefixMatch()
        if touch:
            self._tick += 1
        node = self._root
        full = n // C
        i = 0
        while i < full:
            chunk = tuple(tokens[i * C:(i + 1) * C])
            edge = node.children.get(chunk)
            if edge is None:
                break
            out.pages.append(edge.page)
            if touch:
                edge.tick = self._tick
            node = edge.child
            i += 1
        out.matched_tokens = i * C
        # partial tail: only meaningful when it covers the prompt's end —
        # every full chunk matched and the remainder is shorter than a page
        rem = tokens[i * C:]
        if i == full and 0 < len(rem) < C:
            rt = tuple(rem)
            for chunk, edge in node.children.items():
                if chunk[: len(rt)] == rt:
                    out.tail_page = edge.page
                    out.matched_tokens += len(rem)
                    if touch:
                        edge.tick = self._tick
                    break
        if touch:
            if out.matched_tokens:
                self.hits += 1
                self.tokens_reused += out.matched_tokens
                if out.tail_page is not None:
                    self.partial_hits += 1
            else:
                self.misses += 1
        return out

    # -- residency -----------------------------------------------------------
    def insert(self, tokens, pages: List[int]) -> int:
        """Register ``tokens``'s full chunks as resident, chunk ``k`` held
        by ``pages[k]``.  Existing edges win (first writer published; the
        duplicate page stays private to its slot and is freed at
        retirement).  Takes one allocator ref per NEWLY inserted page;
        returns how many were inserted."""
        C = self.page_len
        tokens = list(tokens)
        full = len(tokens) // C
        if len(pages) < full:
            raise ValueError(
                f"need {full} pages for {len(tokens)} tokens, got {len(pages)}"
            )
        self._tick += 1
        node, added = self._root, 0
        for k in range(full):
            chunk = tuple(tokens[k * C:(k + 1) * C])
            edge = node.children.get(chunk)
            if edge is None:
                edge = _Edge(pages[k], self._tick)
                self.allocator.incref(pages[k])
                node.children[chunk] = edge
                self._resident += 1
                added += 1
            else:
                edge.tick = self._tick
            node = edge.child
        return added

    def resident_pages(self) -> int:
        return self._resident

    # -- eviction ------------------------------------------------------------
    def _evictable(self, node: _Node, out: List[Tuple[int, _Node, Tuple]]):
        for chunk, edge in node.children.items():
            if edge.child.children:
                self._evictable(edge.child, out)
            elif self.allocator.refcount(edge.page) == 1:
                # leaf + only the cache holds it -> reclaimable
                out.append((edge.tick, node, chunk))

    def evictable_count(self) -> int:
        """Pages reclaimable RIGHT NOW (unreferenced leaves).  A lower
        bound on total reclaimable: evicting leaves exposes parents."""
        out: List[Tuple[int, _Node, Tuple]] = []
        self._evictable(self._root, out)
        return len(out)

    def evict(self, need: int) -> int:
        """Free at least ``need`` pages by dropping LRU unreferenced leaf
        edges, re-scanning as parents become leaves.  Returns pages freed
        (may be < ``need`` when live references pin the rest)."""
        freed = 0
        while freed < need:
            cands: List[Tuple[int, _Node, Tuple]] = []
            self._evictable(self._root, cands)
            if not cands:
                break
            cands.sort(key=lambda t: t[0])
            for tick, parent, chunk in cands:
                if freed >= need:
                    break
                edge = parent.children.pop(chunk)
                self.allocator.decref(edge.page)
                self._resident -= 1
                self.evictions += 1
                freed += 1
        return freed
