"""Module-level object-plane API of the port: put / get / wait, copied
from ``tpu_air/core/api.py``.

Parity surface (SURVEY.md §1-L1): ``ray.put`` (Overview_of_Ray.ipynb:cc-34),
``ray.get`` (cc-44), ``ray.wait`` (Scaling_batch_inference.ipynb:cc-115).
Works from both driver and worker processes — the store is shared memory, so
both sides read/write it directly.
"""

from __future__ import annotations

import time
from typing import Any, List, Optional

from . import runtime as rt
from .object_store import ObjectRef


def put(value: Any) -> ObjectRef:
    ctx = rt.current_worker()
    if ctx is not None:
        return ctx.store.put(value)
    return rt.get_runtime().put(value)


def get(ref, timeout: Optional[float] = None):
    ctx = rt.current_worker()
    if ctx is not None:
        if isinstance(ref, list):
            return [get(r, timeout) for r in ref]
        if not isinstance(ref, ObjectRef):
            raise TypeError(f"get() expects ObjectRef(s), got {type(ref)}")
        return rt._resolve_if_error(ctx.store.get(ref.id, timeout=timeout))
    return rt.get_runtime().get(ref, timeout=timeout)


def nodes() -> List[dict]:
    """Cluster membership with heartbeat liveness, from the GCS control
    plane (``ray.nodes()`` analog): ``[{"node_id", "address", "num_chips",
    "alive"}, ...]``; ``[]`` when the GCS is off or unavailable."""
    return rt.get_runtime().nodes()


def wait(refs: List[ObjectRef], num_returns: int = 1, timeout: Optional[float] = None):
    ctx = rt.current_worker()
    if ctx is None:
        return rt.get_runtime().wait(refs, num_returns=num_returns, timeout=timeout)
    if not isinstance(refs, list):
        raise TypeError("wait() expects a list of ObjectRefs")
    if num_returns > len(refs):
        raise ValueError("num_returns may not exceed len(refs)")
    deadline = None if timeout is None else time.monotonic() + timeout
    ready, pending = [], list(refs)
    while len(ready) < num_returns:
        still = []
        for r in pending:
            (ready if ctx.store.contains(r.id) else still).append(r)
        pending = still
        if len(ready) >= num_returns:
            break
        if deadline is not None and time.monotonic() >= deadline:
            break
        time.sleep(0.001)
    return ready, pending
