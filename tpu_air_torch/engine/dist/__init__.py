"""tpu_air_torch.engine.dist — sharded decode and prefill/decode
disaggregation, the counterpart of ``tpu_air.engine.dist``.

Two pieces that compose:

* :class:`MeshEngine` — the paged engine's host loop over a ``(dp, tp)``
  device mesh: weights split Megatron-style over the ``model`` axis, each
  dp replica with its own slots and page pools (:class:`ShardedPagedPool`,
  ``sharded.py``), the mesh leased through the port's runtime when it is up.
  One card can hold the whole mesh.
* :class:`DisaggRouter` + :class:`PrefillWorker` — chunked prefill on
  separate actor replicas, the finished KV pages shipped to the decode
  engine through the object store and admitted with ``submit_prefilled``
  (``engine.prefill`` → ``engine.kv_transfer`` → decode under one trace
  id).

``kv_transfer.py`` is the flat KV-page payload both preemption migration
and the handoff carry, in either package's form.
"""

from .kv_transfer import (
    KVTransferError,
    extract_kv_pages,
    insert_kv_pages,
    payload_nbytes,
    payload_pages,
    validate_kv_payload,
)
from .mesh_engine import MeshEngine
from .pool import ShardedPagedPool
from .prefill_worker import PrefillWorker
from .router import DisaggRouter
from .sharded import (
    make_sharded_page_copy_fn,
    make_sharded_paged_decode_step_fn,
    make_sharded_prefill_chunk_fn,
    paged_cache_shardings,
)

__all__ = [
    "DisaggRouter",
    "KVTransferError",
    "MeshEngine",
    "PrefillWorker",
    "ShardedPagedPool",
    "extract_kv_pages",
    "insert_kv_pages",
    "make_sharded_page_copy_fn",
    "make_sharded_paged_decode_step_fn",
    "make_sharded_prefill_chunk_fn",
    "paged_cache_shardings",
    "payload_nbytes",
    "payload_pages",
    "validate_kv_payload",
]
