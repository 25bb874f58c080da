"""Device meshes over leased devices, the counterpart of
``tpu_air/parallel/mesh.py``.

The JAX package builds a ``jax.sharding.Mesh`` and lets XLA's SPMD
partitioner place the work.  The port runs one controller over
``torch.device``s: :class:`Mesh` is an array of devices in the mesh's shape
with its axis names, and the code that uses it (``engine/dist``) places
every shard itself.  A mesh may name one device more than once: on one card
every (replica, shard) of a ``(data, model)`` mesh can sit on ``cuda:0``,
as the JAX package wraps lease ids onto the devices there are.

Axis convention, as in the JAX package: ``data`` is the batch axis (dp),
``model`` the tensor-parallel axis (tp).  A process holding a chip lease
(``TPU_AIR_CHIP_IDS``) sees only its leased devices.  This module makes no
process group: ``torch.distributed.DeviceMesh`` needs a process a rank,
and the engines that mesh here are single controllers, as the JAX
package's are.
"""

from __future__ import annotations

import math
import os
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch


def leased_chip_ids() -> Optional[List[int]]:
    """Chip ids granted to this process by the scheduler, or None (all)."""
    raw = os.environ.get("TPU_AIR_CHIP_IDS")
    if not raw:
        return None
    return [int(x) for x in raw.split(",") if x != ""]


def platform_devices() -> List[torch.device]:
    """Every CUDA device of this process, in index order.  Raises where there
    is no CUDA device: a mesh of CPU devices is built by naming them
    (``make_mesh(..., devices=[...])``), as the tests do."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "tpu_air_torch meshes run over CUDA devices and none is available; "
            "pass devices=[...] to mesh CPU devices")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def visible_devices() -> List[torch.device]:
    """Devices this process may use: the leased subset, else all devices."""
    devs = platform_devices()
    lease = leased_chip_ids()
    if lease is None:
        return list(devs)
    # Lease ids index the global device list; a lease larger than the local
    # platform (a runtime with more chip slots than cards) wraps.
    n = len(devs)
    return [devs[i % n] for i in lease]


def topology() -> dict:
    """The local topology: platform, device count, visible count, the
    card's name and the process count (the ranks of an initialized
    ``torch.distributed`` group, else 1)."""
    import torch.distributed as dist

    devs = platform_devices()
    first = devs[0]
    return {
        "platform": "gpu" if first.type == "cuda" else first.type,
        "num_devices": len(devs),
        "num_visible": len(visible_devices()),
        "device_kind": (torch.cuda.get_device_name(first) if first.type == "cuda"
                        else first.type),
        "process_count": dist.get_world_size() if dist.is_initialized() else 1,
    }


class Mesh:
    """Devices laid out in a named grid: ``devices`` is an object array of
    ``torch.device`` in the mesh's shape, ``axis_names`` names its axes, and
    ``shape`` maps each name to its size (``mesh.shape["data"]``, as on a
    JAX mesh)."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"mesh of {devices.ndim} dims needs as many axis names, "
                             f"got {tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        return OrderedDict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __repr__(self) -> str:
        axes = ", ".join(f"{n}={s}" for n, s in self.shape.items())
        return f"Mesh({axes}; {[str(d) for d in self.devices.flat]})"


def _device_array(devs: Sequence[torch.device]) -> np.ndarray:
    arr = np.empty(len(devs), dtype=object)
    arr[:] = [torch.device(d) for d in devs]
    return arr


def make_mesh(axis_names: Sequence[str] = ("data",), shape: Optional[Sequence[int]] = None,
              devices=None) -> Mesh:
    """A :class:`Mesh` over the visible (leased) devices, or over
    ``devices`` (repeats allowed).

    ``shape`` may contain one ``-1`` (inferred).  Default: all devices on
    the first axis (pure data parallelism)."""
    devs = list(devices) if devices is not None else visible_devices()
    n = len(devs)
    if shape is None:
        shape = [n] + [1] * (len(axis_names) - 1)
    shape = list(shape)
    if -1 in shape:
        i = shape.index(-1)
        known = math.prod(s for s in shape if s != -1)
        if n % known != 0:
            raise ValueError(f"cannot infer axis: {n} devices, shape {shape}")
        shape[i] = n // known
    if math.prod(shape) != n:
        raise ValueError(
            f"mesh shape {tuple(shape)} needs {math.prod(shape)} devices, "
            f"have {n} visible"
        )
    return Mesh(_device_array(devs).reshape(shape), axis_names)


def data_parallel_mesh(num_devices: Optional[int] = None) -> Mesh:
    devs = visible_devices()
    if num_devices is not None:
        if num_devices > len(devs):
            raise ValueError(
                f"requested {num_devices} devices, only {len(devs)} visible"
            )
        devs = devs[:num_devices]
    return make_mesh(("data",), (len(devs),), devices=devs)


def worker_devices(worker: int, chips_per_worker: int, device: torch.device
                   ) -> List[torch.device]:
    """The devices of data-parallel worker ``worker``: its
    ``chips_per_worker`` consecutive entries of :func:`visible_devices`
    (fewer when the lease runs out, which the loops refuse with the JAX
    package's text).  A CPU worker's devices are the CPU, named
    ``chips_per_worker`` times."""
    device = torch.device(device)
    if device.type != "cuda":
        return [device] * chips_per_worker
    return visible_devices()[worker * chips_per_worker:(worker + 1) * chips_per_worker]


def worker_mesh(devices: Sequence[torch.device], model_parallel: int) -> Mesh:
    """A worker's ``(data, model)`` mesh: ``model_parallel`` devices a
    replica, the rest of ``devices`` as the in-worker data axis (the JAX
    loops' mesh over their lease)."""
    devs = list(devices)
    if model_parallel > len(devs):
        raise ValueError(
            f"model_parallel={model_parallel} exceeds the {len(devs)} visible devices of "
            f"this run's chip lease")
    dp = max(1, len(devs) // model_parallel)
    return make_mesh(("data", "model"), (dp, model_parallel),
                     devices=devs[:dp * model_parallel])


def batch_sharding(x, mesh: Mesh, axis: str = "data"):
    """``x`` (a tensor, or a dict of them, ``[batch, ...]``) split into
    contiguous row blocks over ``axis``, block ``r`` on the first device of
    replica ``r``: the port's ``NamedSharding(mesh, P("data"))``."""
    n = mesh.shape[axis]
    homes = [mesh.devices[(r,) + (0,) * (mesh.devices.ndim - 1)] for r in range(n)]
    if isinstance(x, dict):
        parts = {k: batch_sharding(v, mesh, axis) for k, v in x.items()}
        return [{k: v[r] for k, v in parts.items()} for r in range(n)]
    if x.shape[0] % n:
        raise ValueError(f"a batch of {x.shape[0]} rows does not split over {axis}={n}")
    return [part.to(home) for part, home in zip(x.chunk(n), homes)]


def replicated_sharding(x: torch.Tensor, mesh: Mesh) -> np.ndarray:
    """``x`` on every device of the mesh (an object array in its shape): the
    port's ``NamedSharding(mesh, P())``.  Entries on one device share one
    tensor."""
    out = np.empty(mesh.devices.shape, dtype=object)
    placed: Dict[torch.device, torch.Tensor] = {}
    for idx in np.ndindex(mesh.devices.shape):
        dev = mesh.devices[idx]
        if dev not in placed:
            placed[dev] = x.to(dev)
        out[idx] = placed[dev]
    return out
