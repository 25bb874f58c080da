"""tpu_air_torch.engine.kvpool — block-table-paged KV cache for the engine,
copied from ``tpu_air/engine/kvpool`` (host bookkeeping only).

Replaces the per-slot slab pool (one ``[S, slot_len, h*d]`` row per slot)
with a pool of fixed-size KV *pages* ``[P, page_len, h*d]`` per layer plus a
host-side block table mapping each slot's logical positions onto physical
pages.  Three pieces:

* :class:`BlockAllocator` — refcounted page ids over the device pool, with
  free-list reuse (the device tensors live in the engine's cache and never
  move).
* :class:`PrefixCache` — a radix-over-page-chunks index so prompts sharing
  a prefix map their leading block-table entries to the SAME physical
  pages; copy-on-write on the first divergent append into a shared page.
* :class:`PagedKVPool` — the per-engine orchestration: block tables,
  admission planning (which chunks still need prefill after prefix hits),
  CoW resolution and retirement refcounting.

The device side (the paged cache, the paged decode step, the chunked
prefill, the CoW page copy) is in ``tpu_air_torch/models/lm/generate.py``.
"""

from .allocator import BlockAllocator, KVPoolOOMError
from .pool import AdmitPlan, PagedKVPool
from .prefix import PrefixCache, PrefixMatch

__all__ = [
    "AdmitPlan",
    "BlockAllocator",
    "KVPoolOOMError",
    "PagedKVPool",
    "PrefixCache",
    "PrefixMatch",
]
