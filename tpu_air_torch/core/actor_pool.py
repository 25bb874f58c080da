"""ActorPool — load-balanced fan-out over a fixed set of actors, copied
from ``tpu_air/core/actor_pool.py``.

Parity target: ``ray.util.actor_pool.ActorPool`` with ``map``/``map_unordered``
(Scaling_batch_inference.ipynb:cc-124,127,129) plus the submit/get_next
protocol.  Internally this is the same idle-actor/``wait`` recycling loop the
reference teaches by hand at Scaling_batch_inference.ipynb:cc-115.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, Iterator, List

from .api import get, wait
from .object_store import ObjectRef
from .remote import ActorHandle


class ActorPool:
    def __init__(self, actors: List[ActorHandle]):
        if not actors:
            raise ValueError("ActorPool requires at least one actor")
        self._idle: List[ActorHandle] = list(actors)
        self._future_to_actor: Dict[ObjectRef, ActorHandle] = {}
        self._index_to_future: Dict[int, ObjectRef] = {}
        self._next_task_index = 0
        self._next_return_index = 0

    # -- low-level protocol -------------------------------------------------
    def has_free(self) -> bool:
        return bool(self._idle)

    def has_next(self) -> bool:
        return bool(self._future_to_actor)

    def submit(self, fn: Callable[[ActorHandle, Any], ObjectRef], value: Any):
        if not self._idle:
            raise RuntimeError("no idle actors; call get_next first")
        actor = self._idle.pop(0)
        future = fn(actor, value)
        self._future_to_actor[future] = actor
        self._index_to_future[self._next_task_index] = future
        self._next_task_index += 1

    def get_next(self, timeout=None):
        """Next result in submission order."""
        if self._next_return_index >= self._next_task_index:
            raise StopIteration("no pending results")
        future = self._index_to_future.pop(self._next_return_index)
        self._next_return_index += 1
        result = get(future, timeout=timeout)
        self._return_actor(future)
        return result

    def get_next_unordered(self, timeout=None):
        """Next result to complete, any order."""
        if not self._future_to_actor:
            raise StopIteration("no pending results")
        ready, _ = wait(list(self._future_to_actor), num_returns=1, timeout=timeout)
        if not ready:
            raise TimeoutError("get_next_unordered timed out")
        future = ready[0]
        for idx, fut in list(self._index_to_future.items()):
            if fut == future:
                del self._index_to_future[idx]
                break
        result = get(future)
        self._return_actor(future)
        return result

    def _return_actor(self, future: ObjectRef):
        actor = self._future_to_actor.pop(future)
        self._idle.append(actor)

    def push(self, actor: ActorHandle):
        """Add an idle actor to the pool (autoscaling hook — the data plane
        grows a map_batches pool under backlog, Scaling_batch_inference.
        ipynb:cc-4 'autoscaling the actor pool')."""
        self._idle.append(actor)

    def size(self) -> int:
        return len(self._idle) + len(self._future_to_actor)

    # -- high-level map -----------------------------------------------------
    def map(self, fn, values: Iterable[Any]) -> Iterator[Any]:
        values = list(values)
        sent = 0
        while sent < len(values) and self.has_free():
            self.submit(fn, values[sent])
            sent += 1
        for _ in range(len(values)):
            result = self.get_next()
            if sent < len(values):
                self.submit(fn, values[sent])
                sent += 1
            yield result

    def map_unordered(self, fn, values: Iterable[Any]) -> Iterator[Any]:
        values = list(values)
        sent = 0
        while sent < len(values) and self.has_free():
            self.submit(fn, values[sent])
            sent += 1
        for _ in range(len(values)):
            result = self.get_next_unordered()
            if sent < len(values):
                self.submit(fn, values[sent])
                sent += 1
            yield result
