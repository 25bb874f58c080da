"""Host-side collectives over the port's object store, copied from
``tpu_air/parallel/collectives.py``.

The device plane's collectives are ``torch.distributed``'s
(``parallel/distributed.py``).  These host-side ``Barrier`` / ``broadcast``
/ ``allreduce`` / ``gather`` coordinate actors of the port's runtime — the
distributed GBDT workers' histogram allreduce — by sealing and waiting for
named objects in the store, from the driver or from any worker.
"""

from __future__ import annotations

import time
from typing import Any, Callable, List, Optional

from tpu_air_torch.core import runtime as _rt


class Barrier:
    """Reusable N-party barrier over the object store.

    Each arrival seals a marker object; a party leaves once all N markers for
    the current generation exist.
    """

    def __init__(self, name: str, world_size: int):
        self.name = name
        self.world_size = world_size
        self.generation = 0

    def _store(self):
        ctx = _rt.current_worker()
        return ctx.store if ctx is not None else _rt.get_runtime().store

    def wait(self, rank: int, timeout: Optional[float] = 60.0):
        store = self._store()
        gen = self.generation
        store.put(True, f"barrier-{self.name}-{gen}-{rank}")
        deadline = None if timeout is None else time.monotonic() + timeout
        for r in range(self.world_size):
            remain = None if deadline is None else max(0.0, deadline - time.monotonic())
            if not store.wait_for(f"barrier-{self.name}-{gen}-{r}", timeout=remain):
                raise TimeoutError(
                    f"barrier {self.name} gen {gen}: rank {r} missing after {timeout}s"
                )
        self.generation += 1


def broadcast(value: Any = None, *, name: str, rank: int, src: int = 0,
              timeout: Optional[float] = 60.0) -> Any:
    """Rank ``src`` publishes ``value``; every rank returns it."""
    store = Barrier(name, 0)._store()
    key = f"bcast-{name}"
    if rank == src:
        store.put(value, key)
        return value
    if not store.wait_for(key, timeout=timeout):
        raise TimeoutError(f"broadcast {name}: src value missing after {timeout}s")
    return store.get(key)


def allreduce(value: Any, *, name: str, rank: int, world_size: int,
              reduce_fn: Callable[[List[Any]], Any] = sum,
              timeout: Optional[float] = 60.0) -> Any:
    """All ranks contribute; all ranks get ``reduce_fn(contributions)``.

    Host-plane only (metrics aggregation, histogram merges) — device
    gradients use ``torch.distributed`` inside the train step instead.
    """
    store = Barrier(name, 0)._store()
    store.put(value, f"ar-{name}-{rank}")
    vals = []
    deadline = None if timeout is None else time.monotonic() + timeout
    for r in range(world_size):
        remain = None if deadline is None else max(0.0, deadline - time.monotonic())
        if not store.wait_for(f"ar-{name}-{r}", timeout=remain):
            raise TimeoutError(f"allreduce {name}: rank {r} missing")
        vals.append(store.get(f"ar-{name}-{r}"))
    return reduce_fn(vals)


def gather(value: Any, *, name: str, rank: int, world_size: int, dst: int = 0,
           timeout: Optional[float] = 60.0) -> Optional[List[Any]]:
    """Every rank contributes; rank ``dst`` returns the rank-ordered list,
    all other ranks return None immediately.

    Use instead of :func:`allreduce` when only one rank consumes the result
    and the payloads are large (e.g. per-rank validation predictions): N
    ranks each reading N arrays is O(N^2) store traffic, a gather is O(N)."""
    store = Barrier(name, 0)._store()
    store.put(value, f"g-{name}-{rank}")
    if rank != dst:
        return None
    vals = []
    deadline = None if timeout is None else time.monotonic() + timeout
    for r in range(world_size):
        remain = None if deadline is None else max(0.0, deadline - time.monotonic())
        if not store.wait_for(f"g-{name}-{r}", timeout=remain):
            raise TimeoutError(f"gather {name}: rank {r} missing")
        vals.append(store.get(f"g-{name}-{r}"))
    return vals
