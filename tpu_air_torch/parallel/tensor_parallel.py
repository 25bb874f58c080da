"""Tensor parallelism in one controller: the Megatron split of a model over
the ``model`` axis of a worker's mesh, differentiable.

The JAX package has no such module: it shards the parameters with
``parallel/sharding.py``'s rules and XLA's SPMD partitioner inserts the
collectives.  The port places every shard itself, as the sharded engine
(``engine/dist/sharded.py``) does, and both share the pieces here:

* :func:`broadcast` copies a replicated activation to each shard's device;
* :func:`column_linear` is one shard of a layer split by its output dim
  (q/k/v and gate/up: whole heads or whole ff columns; T5's ``wi`` and its
  vocab-split ``lm_head``);
* :func:`row_partial` is one shard's part of a layer split by its input dim
  (o and down; T5's ``wo``): with several shards, an f32 product of the
  model-type operands, left unrounded;
* :func:`reduce_partials` sums those parts on the replica's first device,
  in f32 and in shard order, and rounds once to the model's type, as the
  single-device layer rounds its one product.

Each is plain autograd: a cross-device copy's backward copies the
cotangent back, and a tensor handed to several shards gets the sum of
their cotangents.  So a replicated parameter exists once, on the replica's
first device, and needs no all-reduce over the model axis.

:class:`ShardedDense` holds one ``nn.Parameter`` a shard.  A model whose
Dense layers :func:`~tpu_air_torch.parallel.sharding.shard_module` has
replaced by it runs its attention and feed-forward per shard
(``models/lm/modeling.py``, ``models/t5/modeling.py``).

In-worker data replicas: replica ``r`` of a ``(data, model)`` mesh runs
the same parameters copied onto its devices (:func:`call_replica`); the
copies are differentiable, so the replicas' gradients sum into the one set
of parameters.  Where replica ``r`` sits on replica 0's devices (the CPU,
or one card named several times) it runs the model as it is.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from .mesh import Mesh


def broadcast(x: torch.Tensor, devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """``x`` on every device of ``devices`` (one tensor where a device repeats
    the first's: no copy)."""
    return [x.to(d) for d in devices]


def column_linear(x: torch.Tensor, w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """One shard of an output-split layer: ``x @ w.T`` in ``dtype``."""
    return F.linear(x.to(dtype), w.to(dtype))


def row_partial(x: torch.Tensor, w: torch.Tensor, dtype: torch.dtype,
                shards: int) -> torch.Tensor:
    """One shard's part of an input-split layer: with one shard the
    single-device product in ``dtype``; with several, f32 from the
    ``dtype``-rounded operands (exact products, f32 sums), left for
    :func:`reduce_partials` to round once."""
    if shards == 1:
        return column_linear(x, w, dtype)
    return F.linear(x.to(dtype).float(), w.to(dtype).float())


def reduce_partials(parts: Sequence[torch.Tensor], device: torch.device,
                    dtype: torch.dtype) -> torch.Tensor:
    """The shards' parts on ``device``, summed in f32 in shard order and
    rounded once to ``dtype`` (one part: that part)."""
    if len(parts) == 1:
        return parts[0].to(device)
    acc = parts[0].to(device)
    for p in parts[1:]:
        acc = acc + p.to(device)
    return acc.to(dtype)


class ShardedDense(nn.Module):
    """A bias-free ``Dense`` split over the model axis: ``shards[i]`` is
    shard i's slice of the f32 weight (``[out, in]``) along ``dim`` (0:
    by output, 1: by input), an ``nn.Parameter`` on that shard's device.

    ``forward(xs)`` of an output split takes the input (one tensor, copied
    to every shard, or one a shard) and returns one output a shard, on its
    device; of an input split it takes one input a shard and returns the
    reduced output on ``home``."""

    def __init__(self, weight: torch.Tensor, dim: int, devices: Sequence[torch.device],
                 compute_dtype: torch.dtype):
        super().__init__()
        n = len(devices)
        if weight.shape[dim] % n:
            raise ValueError(f"dim {dim} of a {tuple(weight.shape)} weight does not split "
                             f"over {n} shards")
        size = weight.shape[dim] // n
        w = weight.detach()
        self.shards = nn.ParameterList(
            nn.Parameter(w.narrow(dim, i * size, size).to(d, copy=True).contiguous())
            for i, d in enumerate(devices))
        self.dim = dim
        self.compute_dtype = compute_dtype

    @property
    def devices(self) -> List[torch.device]:
        return [p.device for p in self.shards]

    def forward(self, xs: Union[torch.Tensor, Sequence[torch.Tensor]],
                home: Optional[torch.device] = None):
        dt = self.compute_dtype
        if isinstance(xs, torch.Tensor):
            xs = broadcast(xs, self.devices)
        if self.dim == 0:
            return [column_linear(x, w, dt) for x, w in zip(xs, self.shards)]
        n = len(self.shards)
        parts = [row_partial(x, w, dt, n) for x, w in zip(xs, self.shards)]
        return reduce_partials(parts, home if home is not None else xs[0].device, dt)


_SHARD = re.compile(r"(.*)\.shards\.(\d+)$")


def shard_index(name: str) -> int:
    """The model-axis shard a parameter of a sharded model belongs to (0 for
    a replicated one, which lives on the replica's first device)."""
    m = _SHARD.fullmatch(name)
    return int(m.group(2)) if m else 0


def replica_parameters(model: nn.Module, mesh: Mesh, r: int
                       ) -> Optional[Dict[str, torch.Tensor]]:
    """The model's parameters on the devices of data replica ``r`` of
    ``mesh`` (differentiable copies), or None where replica ``r`` sits on
    replica 0's devices and runs the model as it is."""
    if all(mesh.devices[r, s] == mesh.devices[0, s] for s in range(mesh.devices.shape[1])):
        return None
    return {name: p.to(mesh.devices[r, shard_index(name)])
            for name, p in model.named_parameters()}


class _Apply(nn.Module):
    """``fn(model, *args)`` as a module's forward, so that
    ``torch.func.functional_call`` can run it on other parameters."""

    def __init__(self, model: nn.Module, fn):
        super().__init__()
        self.model = model
        self.fn = fn

    def forward(self, *args):
        return self.fn(self.model, *args)


def call_replica(model: nn.Module, mesh: Mesh, r: int, fn, *args) -> Any:
    """``fn(model, *args)`` with the model's parameters on data replica
    ``r``'s devices."""
    params = replica_parameters(model, mesh, r)
    if params is None:
        return fn(model, *args)
    return torch.func.functional_call(
        _Apply(model, fn), {f"model.{k}": v for k, v in params.items()}, args)
