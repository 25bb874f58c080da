"""tpu_air_torch.engine.dist — the counterpart of ``tpu_air.engine.dist``.

Ported: the KV-page payload (``kv_transfer.py``) that preemption migration
carries between two paged engines.  Not ported: the sharded engine
(``MeshEngine``, ``ShardedPagedPool``; ROADMAP Queue 1 item 9) and
prefill/decode disaggregation (``DisaggRouter``, ``PrefillWorker``; items 6b
and 9); asking this package for one of them raises ``NotImplementedError``
naming its item.
"""

from .kv_transfer import (
    KVTransferError,
    extract_kv_pages,
    insert_kv_pages,
    payload_nbytes,
    payload_pages,
    validate_kv_payload,
)

_ITEM_9 = "ROADMAP Queue 1 item 9: mesh, tensor parallelism and multi-host"
_ITEM_6B_9 = ("ROADMAP Queue 1 items 6b and 9: engine/dist/, its KV transfer "
              "with the LM engine")
UNPORTED = {
    **dict.fromkeys(("MeshEngine", "ShardedPagedPool"), _ITEM_9),
    **dict.fromkeys(("DisaggRouter", "PrefillWorker"), _ITEM_6B_9),
}


def __getattr__(name):
    if name in UNPORTED:
        raise NotImplementedError(
            f"tpu_air_torch.engine.dist.{name} is not ported yet ({UNPORTED[name]})")
    raise AttributeError(f"module 'tpu_air_torch.engine.dist' has no attribute '{name}'")


__all__ = [
    "KVTransferError",
    "extract_kv_pages",
    "insert_kv_pages",
    "payload_nbytes",
    "payload_pages",
    "validate_kv_payload",
]
