"""Slot table + KV-slab insertion for the continuous-batching engine,
copied from ``tpu_air/engine/slots.py``.

A *slot* is one row of the engine's fixed decode batch: row ``s`` of every
per-layer flat KV slab ``[S, L_slot, h*d]``.  The host-side
:class:`SlotManager` tracks which request occupies each row and where its
context ends; the device side is one in-place slice copy per admission that
grafts a prefilled cache segment into the free row.

Lifecycle of a slot::

    free -> [admit] occupied(pos=len(prompt)) -> [decode steps] pos+1 each
         -> [EOS or budget] free again -- no slab zeroing on retirement:
    stale K/V beyond the next occupant's written positions are masked by
    the per-row validity mask (arange <= index[row]) and progressively
    overwritten, so retirement costs exactly one host-side list append.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional

import torch

from .types import Request


@dataclass
class Slot:
    """Host bookkeeping for one slab row (or paged block-table row)."""

    index: int
    request: Optional[Request] = None
    pos: int = 0            # cache write position == tokens in context
    budget_left: int = 0    # decode steps remaining before forced retirement
    # paged engine only: mid-chunked-prefill flag + the pool's AdmitPlan
    # (remaining chunk starts, prefix coverage).  A prefilling slot holds
    # pages and a request but does NOT ride the decode step yet.
    prefilling: bool = False
    plan: Any = None

    @property
    def active(self) -> bool:
        return self.request is not None


class SlotManager:
    """Free-list over the ``S`` slab rows."""

    def __init__(self, num_slots: int):
        self.slots: List[Slot] = [Slot(i) for i in range(num_slots)]
        # pop() takes from the end: keep it ascending-last so admission
        # fills row 0 first (deterministic slot assignment for the parity
        # tests — FIFO arrival k lands in the lowest free row)
        self._free: List[int] = list(range(num_slots))[::-1]

    def free_count(self) -> int:
        return len(self._free)

    def free_indices(self) -> List[int]:
        """Free rows in ACQUIRE order (lowest first) — what an admission
        predicate that must know which row each admit will land in (the
        MeshEngine's per-replica capacity gate) simulates against."""
        return sorted(self._free)

    def active_slots(self) -> List[Slot]:
        return [s for s in self.slots if s.active]

    def occupancy(self) -> int:
        return len(self.slots) - len(self._free)

    def acquire(self) -> Slot:
        slot = self.slots[self._free.pop()]
        assert not slot.active, "acquired an occupied slot"
        return slot

    def release(self, slot: Slot) -> None:
        slot.request = None
        slot.pos = 0
        slot.budget_left = 0
        slot.prefilling = False
        slot.plan = None
        # keep the free list sorted descending so the next acquire still
        # hands out the lowest free row
        self._free.append(slot.index)
        self._free.sort(reverse=True)


def make_insert_fn():
    """Segment insertion: copy a prefilled cache segment (per-layer
    ``[1, Lb, h*d]`` slabs, ``make_lm_prefill_fn``'s) into slab row ``slot``
    of the engine cache, in place (the JAX package's donated
    ``dynamic_update_slice``).  The index passes through: the decode step
    sets it from the host-authoritative ``pos`` vector every call."""

    def insert(cache: List[Any], segment: List[Any], slot: int) -> List[Any]:
        with torch.inference_mode():
            for c, s in zip(cache, segment):
                n = s.cached_key.shape[1]
                c.cached_key[slot, :n].copy_(s.cached_key[0])
                c.cached_value[slot, :n].copy_(s.cached_value[0])
        return cache

    return insert
