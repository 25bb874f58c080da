"""tpu_air_torch.core — the port's task/actor/object runtime, copied from
``tpu_air/core``."""

from .actor_pool import ActorPool
from .api import get, nodes, put, wait
from .object_store import ObjectRef
from .remote import ActorClass, ActorHandle, ActorMethod, RemoteFunction, kill, remote
from .runtime import (
    ActorDiedError,
    RemoteError,
    Runtime,
    TpuAirError,
    get_runtime,
    init,
    is_initialized,
    shutdown,
)

__all__ = [
    "ActorClass",
    "ActorDiedError",
    "ActorHandle",
    "ActorMethod",
    "ActorPool",
    "ObjectRef",
    "RemoteError",
    "RemoteFunction",
    "Runtime",
    "TpuAirError",
    "get",
    "get_runtime",
    "init",
    "is_initialized",
    "kill",
    "nodes",
    "put",
    "remote",
    "shutdown",
    "wait",
]
