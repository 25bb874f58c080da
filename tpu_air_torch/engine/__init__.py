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
pages to another engine (``dist/kv_transfer.py``).  ``dist/`` holds the
distributed engines: :class:`MeshEngine` over a ``(dp, tp)`` device mesh and
:class:`DisaggRouter` with its :class:`PrefillWorker` replicas.
"""

from .dist import (
    DisaggRouter,
    KVTransferError,
    MeshEngine,
    PrefillWorker,
    ShardedPagedPool,
)
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


__all__ = [
    "AdmitPlan",
    "BlockAllocator",
    "DisaggRouter",
    "EngineClosedError",
    "EngineConfig",
    "EngineDrainingError",
    "EngineMetrics",
    "EngineOverloadedError",
    "InferenceEngine",
    "KVPoolOOMError",
    "KVTransferError",
    "MeshEngine",
    "PagedKVPool",
    "PrefillWorker",
    "PrefixCache",
    "PrefixMatch",
    "Request",
    "RequestValidationError",
    "ResponseStream",
    "Scheduler",
    "ShardedPagedPool",
    "Slot",
    "SlotManager",
    "T5Engine",
    "T5EngineConfig",
    "make_insert_fn",
    "snapshot_all",
]
