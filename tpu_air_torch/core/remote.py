"""``@tpu_air_torch.remote`` — remote functions and actor classes, copied
from ``tpu_air/core/remote.py``.

API parity targets (SURVEY.md §1-L1): ``@ray.remote`` on functions
(Overview_of_Ray.ipynb:cc-41) and classes (Scaling_batch_inference.ipynb:cc-105),
``.remote(...)`` invocation, ``.options(...)`` resource overrides
(``num_gpus_per_worker`` analog is ``num_chips``), and actor handles whose
methods are invoked as ``handle.method.remote(...)``.

Both the driver and worker processes may call ``.remote`` — nested submission
from a worker is routed to the driver scheduler over the worker's control pipe
(runtime.py).
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional

from . import runtime as rt
from . import serialization
from .object_store import ObjectRef, new_object_id
from tpu_air_torch.faults import plan as _faults
from tpu_air_torch.observability import tracing as _tracing


def _normalize_resources(
    num_cpus=None, num_chips=None, resources=None, is_actor=False
) -> Dict[str, float]:
    # Like the reference runtime: tasks default to 1 CPU; *actors* default to
    # 0 CPUs for their lifetime (otherwise long-lived actors starve the task
    # pool).  Chip leases are always explicit.
    default_cpu = 0.0 if is_actor else 1.0
    res = dict(resources or {})
    res["cpu"] = float(num_cpus if num_cpus is not None else res.get("cpu", default_cpu))
    if num_chips is not None:
        res["chip"] = float(num_chips)
    else:
        res.setdefault("chip", 0.0)
    return res


def _pack_payload_local(store, payload_tuple):
    blob = serialization.dumps(payload_tuple)
    if len(blob) <= rt._INLINE_LIMIT:
        return blob, None
    return None, store.put(blob).id


def _submit_task(fn, args, kwargs, resources) -> ObjectRef:
    # capture the ambient span context at the submit call-site — None when
    # tracing is off or no span is active, so the common path ships nothing
    trace_ctx = _tracing.current_propagation()
    ctx = rt.current_worker()
    if ctx is not None:
        task_id = new_object_id()
        payload, payload_ref = _pack_payload_local(ctx.store, (fn, list(args), kwargs))
        ctx.send(
            (
                "submit",
                {
                    "task_id": task_id,
                    "payload": payload,
                    "payload_ref": payload_ref,
                    "resources": resources,
                    "trace_ctx": trace_ctx,
                },
            )
        )
        return ObjectRef(task_id)
    return rt.get_runtime().submit_task(fn, list(args), kwargs, resources,
                                        trace_ctx=trace_ctx)


def _create_actor(cls, args, kwargs, resources, name=None, chip_ids=None) -> "ActorHandle":
    trace_ctx = _tracing.current_propagation()
    ctx = rt.current_worker()
    if chip_ids is not None and ctx is None:
        raise ValueError("chip_ids= places an actor on a part of its creating actor's "
                         "lease: only an actor of the runtime can pass it")
    if ctx is not None:
        actor_id = new_object_id()
        ready_id = new_object_id()
        payload, payload_ref = _pack_payload_local(ctx.store, (cls, list(args), kwargs))
        ctx.send(
            (
                "create_actor",
                {
                    "actor_id": actor_id,
                    "ready_id": ready_id,
                    "payload": payload,
                    "payload_ref": payload_ref,
                    "resources": resources,
                    "name": name,
                    "trace_ctx": trace_ctx,
                    "sublease": None if chip_ids is None else [int(c) for c in chip_ids],
                },
            )
        )
        return ActorHandle(actor_id, cls.__name__, ObjectRef(ready_id))
    r = rt.get_runtime()
    actor_id, ready_ref = r.create_actor(cls, list(args), kwargs, resources,
                                         name=name, trace_ctx=trace_ctx)
    return ActorHandle(actor_id, cls.__name__, ready_ref)


def _submit_actor_task(actor_id, method, args, kwargs) -> ObjectRef:
    trace_ctx = _tracing.current_propagation()
    ctx = rt.current_worker()
    if _faults.enabled():
        spec = _faults.perturb("actor.call", key=f"{actor_id}:{method}")
        if spec is not None and spec.action == "kill" and ctx is None:
            # crash the TARGET actor's process (no graceful shutdown) so the
            # caller exercises the real pipe-EOF death path
            rt.get_runtime().crash_actor(actor_id)
    if ctx is not None:
        task_id = new_object_id()
        payload, payload_ref = _pack_payload_local(ctx.store, (None, list(args), kwargs))
        ctx.send(
            (
                "actor_call",
                {
                    "task_id": task_id,
                    "payload": payload,
                    "payload_ref": payload_ref,
                    "resources": {},
                    "kind": "actor_task",
                    "actor_id": actor_id,
                    "method": method,
                    "trace_ctx": trace_ctx,
                },
            )
        )
        return ObjectRef(task_id)
    return rt.get_runtime().submit_actor_task(actor_id, method, list(args), kwargs,
                                              trace_ctx=trace_ctx)


class RemoteFunction:
    def __init__(self, fn, resources: Dict[str, float]):
        self._fn = fn
        self._resources = resources
        functools.update_wrapper(self, fn)

    def remote(self, *args, **kwargs) -> ObjectRef:
        return _submit_task(self._fn, args, kwargs, dict(self._resources))

    def options(self, num_cpus=None, num_chips=None, resources=None, **_ignored):
        merged = dict(self._resources)
        if num_cpus is not None:
            merged["cpu"] = float(num_cpus)
        if num_chips is not None:
            merged["chip"] = float(num_chips)
        if resources:
            merged.update(resources)
        return RemoteFunction(self._fn, merged)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Remote function '{getattr(self._fn, '__name__', self._fn)}' cannot be "
            "called directly; use '.remote()'."
        )


class ActorMethod:
    def __init__(self, handle: "ActorHandle", name: str):
        self._handle = handle
        self._name = name

    def remote(self, *args, **kwargs) -> ObjectRef:
        return _submit_actor_task(self._handle._actor_id, self._name, args, kwargs)


class ActorHandle:
    """Serializable handle to a live actor (``ray.actor.ActorHandle`` analog)."""

    def __init__(self, actor_id: str, class_name: str, ready_ref: Optional[ObjectRef]):
        self._actor_id = actor_id
        self._class_name = class_name
        self._ready_ref = ready_ref

    def __getattr__(self, name: str) -> ActorMethod:
        if name.startswith("_"):
            raise AttributeError(name)
        return ActorMethod(self, name)

    def __repr__(self) -> str:
        return f"ActorHandle({self._class_name}, {self._actor_id})"

    def __reduce__(self):
        return (ActorHandle, (self._actor_id, self._class_name, self._ready_ref))


class ActorClass:
    def __init__(self, cls, resources: Dict[str, float], name: Optional[str] = None,
                 chip_ids: Optional[List[int]] = None):
        self._cls = cls
        self._resources = resources
        self._name = name
        self._chip_ids = chip_ids

    def remote(self, *args, **kwargs) -> ActorHandle:
        return _create_actor(self._cls, args, kwargs, dict(self._resources), self._name,
                             self._chip_ids)

    def options(self, num_cpus=None, num_chips=None, resources=None, name=None,
                chip_ids=None, **_ig):
        """``chip_ids``: inside an actor, place the new actor on these ids of
        the creating actor's own lease (``[]`` for none) instead of
        claiming from the pool; it dies with its creator."""
        merged = dict(self._resources)
        if num_cpus is not None:
            merged["cpu"] = float(num_cpus)
        if num_chips is not None:
            merged["chip"] = float(num_chips)
        if resources:
            merged.update(resources)
        return ActorClass(self._cls, merged, name=name or self._name,
                          chip_ids=self._chip_ids if chip_ids is None else list(chip_ids))

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Actor class '{self._cls.__name__}' cannot be instantiated directly; "
            "use '.remote()'."
        )


def remote(*args, **kwargs):
    """Decorator: turn a function into a RemoteFunction or a class into an
    ActorClass.  Supports bare ``@remote`` and parameterized
    ``@remote(num_cpus=..., num_chips=...)``."""

    def make(obj):
        res = _normalize_resources(
            kwargs.get("num_cpus"),
            kwargs.get("num_chips"),
            kwargs.get("resources"),
            is_actor=isinstance(obj, type),
        )
        if isinstance(obj, type):
            return ActorClass(obj, res)
        return RemoteFunction(obj, res)

    if len(args) == 1 and not kwargs and (callable(args[0]) or isinstance(args[0], type)):
        return make(args[0])
    if args:
        raise TypeError("@remote accepts only keyword arguments")
    return make


def kill(handle: ActorHandle, no_restart: bool = True):
    ctx = rt.current_worker()
    if ctx is not None:
        ctx.send(("kill_actor", handle._actor_id))
        return
    rt.get_runtime().kill_actor(handle._actor_id, no_restart=no_restart)
