"""ShardedPagedPool — dp independent PagedKVPools behind one global view,
copied from ``tpu_air/engine/dist/pool.py`` (host bookkeeping, no device
work; the port imports nothing of ``tpu_air``).

The :class:`~tpu_air_torch.engine.dist.mesh_engine.MeshEngine` keeps each
dp replica's page pools on that replica's devices, and the global page id
``r * pages_per_replica + local`` names replica ``r``'s page ``local``.
This class keeps the host bookkeeping consistent with that layout: slots
are split evenly across replicas (slot ``s`` lives on replica ``s //
(S/dp)``), each replica runs its OWN single-card :class:`PagedKVPool` over
local page ids, and every id crossing the engine boundary is offset into
the global range — including the null page, so replica ``r``'s masked
rides scatter into ``r * pages_per_replica`` (its own pinned null page) and
never cross a replica.  Prefix sharing therefore happens PER REPLICA: two
slots on the same replica share pages, slots on different replicas each
keep their own copy.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..kvpool import PagedKVPool
from ..kvpool.pool import AdmitPlan


class ShardedPagedPool:
    """Per-dp-replica block tables + refcounts presenting the single-pool
    interface the engine host loop drives."""

    def __init__(self, dp: int, pages_per_replica: int, page_len: int,
                 num_slots: int, pages_per_slot: int,
                 prefix_cache: bool = True):
        if num_slots % dp != 0:
            raise ValueError(
                f"num_slots {num_slots} not divisible by dp {dp}")
        self.dp = dp
        self.page_len = page_len
        self.pages_per_slot = pages_per_slot
        self.num_slots = num_slots
        self.slots_per_replica = num_slots // dp
        self.pages_per_replica = pages_per_replica
        self.replicas: List[PagedKVPool] = [
            PagedKVPool(pages_per_replica, page_len, self.slots_per_replica,
                        pages_per_slot, prefix_cache=prefix_cache)
            for _ in range(dp)
        ]

    # -- id routing ----------------------------------------------------------
    def replica_of(self, slot: int) -> int:
        return slot // self.slots_per_replica

    def _local(self, slot: int) -> Tuple[PagedKVPool, int]:
        r, s = divmod(slot, self.slots_per_replica)
        return self.replicas[r], s

    def _offset(self, slot: int) -> int:
        return self.replica_of(slot) * self.pages_per_replica

    def null_page_of(self, slot: int) -> int:
        """The GLOBAL id of the null page in the slot's own shard (the
        MeshEngine masks non-decoding rows with this, not global 0)."""
        return self._offset(slot)

    # -- engine-facing surface (PagedKVPool contract, global ids) ------------
    @property
    def block_table(self) -> np.ndarray:
        out = np.empty((self.num_slots, self.pages_per_slot), np.int32)
        spr = self.slots_per_replica
        for r, pool in enumerate(self.replicas):
            out[r * spr:(r + 1) * spr] = (
                pool.block_table + r * self.pages_per_replica)
        return out

    def worst_case_pages(self, prompt_len: int, budget: int) -> int:
        return self.replicas[0].worst_case_pages(prompt_len, budget)

    def capacity(self) -> int:
        """Aggregate obtainable pages — for gauges only; admission gates on
        :meth:`replica_capacity` (a full replica can't borrow from another)."""
        return sum(p.capacity() for p in self.replicas)

    def replica_capacity(self, replica: int) -> int:
        return self.replicas[replica].capacity()

    def admit(self, slot: int, prompt, budget: int,
              share: bool = True) -> AdmitPlan:
        pool, s = self._local(slot)
        return pool.admit(s, prompt, budget, share=share)

    def chunk_row(self, slot: int, start: int, null_target: bool):
        pool, s = self._local(slot)
        # local row ids (null included) shift into the replica's page range
        return pool.chunk_row(s, start, null_target) + self._offset(slot)

    def register(self, slot: int, prompt) -> int:
        pool, s = self._local(slot)
        return pool.register(s, prompt)

    def resolve_cow(self, slot: int) -> Optional[Tuple[int, int]]:
        pool, s = self._local(slot)
        cow = pool.resolve_cow(s)
        if cow is None:
            return None
        dst, src = cow
        return dst + self._offset(slot), src + self._offset(slot)

    def prompt_page_ids(self, slot: int, n_tokens: int) -> List[int]:
        pool, s = self._local(slot)
        off = self._offset(slot)
        return [p + off for p in pool.prompt_page_ids(s, n_tokens)]

    def release(self, slot: int) -> None:
        pool, s = self._local(slot)
        pool.release(s)

    # -- observability -------------------------------------------------------
    def stats(self) -> dict:
        per = [p.stats() for p in self.replicas]
        out = {"dp_replicas": self.dp, "page_len": self.page_len}
        for key in per[0]:
            if key == "page_len":
                continue
            vals = [s.get(key, 0) for s in per]
            if key == "prefix_hit_rate":
                looked = sum(s.get("prefix_hits", 0) + s.get("prefix_misses", 0)
                             for s in per)
                hits = sum(s.get("prefix_hits", 0) for s in per)
                out[key] = (hits / looked) if looked else 0.0
            else:
                out[key] = sum(vals)
        return out
