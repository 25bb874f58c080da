"""tpu_air_torch.engine — online inference, the counterpart of
``tpu_air.engine``.

The causal LM runs through :class:`InferenceEngine`: a fixed pool of
sequence slots over per-layer KV storage, block-table PAGED pools with
prefix sharing and chunked prefill by default (``kvpool/``) or flat slabs
(``kv_mode="slab"``), one decode step over the pool, admission and
retirement between steps, and per-token streaming.  The T5 family runs
through :class:`T5Engine`, a window engine over the batch-synchronized T5
decode entry points.  Both run on the model's device, where every decode
step runs the decode-attention kernel (T5's prefill the flash-attention
kernel too).  The LM engine also serves multi-tenant LoRA head-delta
adapters, swaps its weights live and migrates its decoding streams' KV
pages to another engine (``dist/kv_transfer.py``).  The distributed engines
(ROADMAP Queue 1 items 6b and 9) are not ported: asking this package for one
of them raises ``NotImplementedError`` naming its item.
"""

from .dist import UNPORTED, KVTransferError
from .engine import InferenceEngine
from .kvpool import (
    AdmitPlan,
    BlockAllocator,
    KVPoolOOMError,
    PagedKVPool,
    PrefixCache,
    PrefixMatch,
)
from .metrics import EngineMetrics, snapshot_all
from .scheduler import Scheduler
from .slots import Slot, SlotManager, make_insert_fn
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


def __getattr__(name):
    if name in UNPORTED:
        raise NotImplementedError(
            f"tpu_air_torch.engine.{name} is not ported yet ({UNPORTED[name]})")
    raise AttributeError(f"module 'tpu_air_torch.engine' has no attribute '{name}'")


__all__ = [
    "AdmitPlan",
    "BlockAllocator",
    "EngineClosedError",
    "EngineConfig",
    "EngineDrainingError",
    "EngineMetrics",
    "EngineOverloadedError",
    "InferenceEngine",
    "KVPoolOOMError",
    "KVTransferError",
    "PagedKVPool",
    "PrefixCache",
    "PrefixMatch",
    "Request",
    "RequestValidationError",
    "ResponseStream",
    "Scheduler",
    "Slot",
    "SlotManager",
    "T5Engine",
    "T5EngineConfig",
    "make_insert_fn",
    "snapshot_all",
]
