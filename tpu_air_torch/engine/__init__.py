"""tpu_air_torch.engine — online inference, the counterpart of
``tpu_air.engine``.

The T5 family runs through :class:`T5Engine`, a window engine over the
batch-synchronized T5 decode entry points, on the model's device: its
prefill runs the flash-attention kernel in the encoder, and every decode
step the decode-attention kernel.  The causal-LM slot engine with its paged
KV pool (ROADMAP Queue 1 item 6b) and the distributed engines (items 6b
and 9) are not ported: asking this package for one of them raises
``NotImplementedError`` naming its item.
"""

from .metrics import EngineMetrics, snapshot_all
from .scheduler import Scheduler
from .t5_engine import T5Engine, T5EngineConfig
from .types import (
    EngineClosedError,
    EngineConfig,
    EngineDrainingError,
    EngineOverloadedError,
    Request,
    RequestValidationError,
    ResponseStream,
)

_ITEM_6B = ("ROADMAP Queue 1 item 6b: the LM decode path, InferenceEngine, "
            "slots.py and kvpool/")
_ITEM_9 = "ROADMAP Queue 1 item 9: mesh, tensor parallelism and multi-host"
_ITEM_6B_9 = ("ROADMAP Queue 1 items 6b and 9: engine/dist/, its KV transfer "
              "with the LM engine")
_UNPORTED = {
    **dict.fromkeys(("InferenceEngine", "Slot", "SlotManager", "make_insert_fn",
                     "PagedKVPool", "AdmitPlan", "BlockAllocator", "KVPoolOOMError",
                     "PrefixCache", "PrefixMatch"), _ITEM_6B),
    **dict.fromkeys(("MeshEngine", "ShardedPagedPool"), _ITEM_9),
    **dict.fromkeys(("DisaggRouter", "PrefillWorker"), _ITEM_6B_9),
}


def __getattr__(name):
    if name in _UNPORTED:
        raise NotImplementedError(
            f"tpu_air_torch.engine.{name} is not ported yet ({_UNPORTED[name]})")
    raise AttributeError(f"module 'tpu_air_torch.engine' has no attribute '{name}'")


__all__ = [
    "EngineClosedError",
    "EngineConfig",
    "EngineDrainingError",
    "EngineMetrics",
    "EngineOverloadedError",
    "Request",
    "RequestValidationError",
    "ResponseStream",
    "Scheduler",
    "T5Engine",
    "T5EngineConfig",
    "snapshot_all",
]
