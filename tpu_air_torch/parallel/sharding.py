"""Parameter partitioning rules over a ``(data, model)`` mesh, the
counterpart of ``tpu_air/parallel/sharding.py``.

The rules are the JAX package's, per Flax parameter path: attention q/k/v
and the SwiGLU gate/up shard their OUTPUT dim over ``model``, o/down their
INPUT dim, and embeddings and norms replicate (the tied head reads the
replicated embedding).  A spec is a tuple of axis names or ``None``, one a
dim, in the Flax kernel's layout (``()`` replicates).  With no ``model``
axis, or tp = 1, everything replicates.

The port's ``nn.Linear`` weights are ``[out, in]`` where Flax kernels are
``[in, out]``, so a Dense kernel's spec is reversed on the port's weight:
q's ``(None, "model")`` splits the port's dim 0.  :data:`LM_PARAM_PATHS`
states which port parameter each Flax path is.  A dim the axis does not
divide replicates, as ``_param_shardings`` drops it.

:func:`shard_params` and :func:`replicate` place a state dict on every
device of a mesh, each device's tensors its slice; the JAX package's
multi-host ``_place`` branch comes with multi-host rendezvous.

For training, :func:`shard_module` splits a model in place over a
replica's devices: each Dense layer the rules split becomes a
:class:`~tpu_air_torch.parallel.tensor_parallel.ShardedDense`, one
``nn.Parameter`` a shard, and the rest stays whole on the first device.
:func:`logical_parameters` lists the model's parameters as the JAX tree
holds them (a shard list each), :func:`gather_state_dict` puts the logical
state dict back together, and :func:`params_bytes` counts what the JAX
loops report.
"""

from __future__ import annotations

import math
import re
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from torch import nn

from .mesh import Mesh

Spec = Tuple[Optional[str], ...]


def t5_param_spec(path_names, leaf=None) -> Spec:
    """Spec of one T5 parameter, by its Flax tree path."""
    names = [str(p) for p in path_names]
    leafname = names[-1]
    parent = names[-2] if len(names) >= 2 else ""
    if leafname == "kernel":
        if parent in ("wi", "wi_0", "wi_1"):
            return (None, "model")            # [d_model, d_ff]
        if parent == "wo":
            return ("model", None)            # [d_ff, d_model]
        if parent in ("q", "k", "v"):
            return (None, "model", None)      # [d_model, heads, d_kv]
        if parent == "o":
            return ("model", None, None)      # [heads, d_kv, d_model]
        if parent == "lm_head":
            return (None, "model")            # [d_model, vocab]
    return ()  # embeddings, norms, rel-bias: replicated


def lm_param_spec(path_names, leaf=None) -> Spec:
    """Spec of one causal-LM parameter, by its Flax tree path: q/k/v and
    gate/up shard their output (heads / ff) dim over ``model``; o/down
    their input dim; embeddings and norms replicate."""
    names = [str(p) for p in path_names]
    leafname = names[-1]
    parent = names[-2] if len(names) >= 2 else ""
    if leafname == "kernel":
        if parent in ("q", "k", "v", "gate", "up"):
            return (None, "model")
        if parent in ("o", "down"):
            return ("model", None)
    return ()


# The LM's port parameters and their Flax paths ({i}: layer, {n}: module):
#   port parameter                Flax path                         Dense kernel (transposed)
#   embedding                     embedding                         no
#   layers.{i}.attn.{q,k,v,o}.weight   layer_{i}/attn/{n}/kernel    yes
#   layers.{i}.mlp.{gate,up,down}.weight  layer_{i}/mlp/{n}/kernel  yes
#   layers.{i}.{attn,mlp}_norm.weight  layer_{i}/{n}/weight         no
#   final_norm.weight             final_norm/weight                 no
#   lm_head.weight                lm_head/kernel                    yes
LM_PARAM_PATHS = (
    (r"embedding", "embedding", False),
    (r"layers\.(\d+)\.attn\.(q|k|v|o)\.weight", "layer_{0}/attn/{1}/kernel", True),
    (r"layers\.(\d+)\.mlp\.(gate|up|down)\.weight", "layer_{0}/mlp/{1}/kernel", True),
    (r"layers\.(\d+)\.(attn_norm|mlp_norm)\.weight", "layer_{0}/{1}/weight", False),
    (r"final_norm\.weight", "final_norm/weight", False),
    (r"lm_head\.weight", "lm_head/kernel", True),
)


def lm_flax_path(name: str) -> Tuple[Tuple[str, ...], bool]:
    """The Flax path of an LM port parameter and whether the port's tensor
    is the Flax kernel transposed (:data:`LM_PARAM_PATHS`)."""
    for pattern, path, transposed in LM_PARAM_PATHS:
        m = re.fullmatch(pattern, name)
        if m:
            return tuple(path.format(*m.groups()).split("/")), transposed
    raise KeyError(f"{name!r} is not a parameter of the causal LM")


def param_spec(name: str, shape: Sequence[int], mesh: Mesh,
               spec_fn: Callable = lm_param_spec,
               path_fn: Callable = lm_flax_path) -> Spec:
    """The spec of one port parameter over ``mesh``, in the port's layout:
    the Flax rule for its path, reversed for a transposed kernel, padded to
    the tensor's rank, and with every axis that does not divide its dim
    dropped (``_param_shardings``).  Without a ``model`` axis: ``()``."""
    if "model" not in mesh.axis_names:
        return ()
    path, transposed = path_fn(name)
    spec = tuple(spec_fn(path, None))
    if transposed:
        spec = spec[::-1]
    spec = spec + (None,) * (len(shape) - len(spec))
    sizes = mesh.shape
    ok = tuple(None if axis is None or shape[dim] % sizes.get(axis, 1) else axis
               for dim, axis in enumerate(spec))
    return () if all(a is None for a in ok) else ok


def param_specs(state_dict: Dict[str, torch.Tensor], mesh: Mesh,
                spec_fn: Callable = lm_param_spec,
                path_fn: Callable = lm_flax_path) -> Dict[str, Spec]:
    """:func:`param_spec` of every parameter of a state dict."""
    return {name: param_spec(name, tuple(t.shape), mesh, spec_fn, path_fn)
            for name, t in state_dict.items()}


def _slice(t: torch.Tensor, spec: Spec, coords: Dict[str, int],
           sizes: Dict[str, int]) -> torch.Tensor:
    for dim, axis in enumerate(spec):
        if axis is not None:
            n = t.shape[dim] // sizes[axis]
            t = t.narrow(dim, coords[axis] * n, n)
    return t


def shard_params(state_dict: Dict[str, torch.Tensor], mesh: Mesh,
                 spec_fn: Callable = lm_param_spec,
                 path_fn: Callable = lm_flax_path) -> np.ndarray:
    """Every device's slice of ``state_dict``: an object array in the
    mesh's shape whose entry at a device's coordinates is a state dict of
    that device's tensors (its contiguous slice along each sharded dim, the
    whole tensor where the spec replicates).  Tensors already on their
    device and whole are shared, not copied."""
    specs = param_specs(state_dict, mesh, spec_fn, path_fn)
    sizes = mesh.shape
    out = np.empty(mesh.devices.shape, dtype=object)
    for idx in np.ndindex(mesh.devices.shape):
        coords = dict(zip(mesh.axis_names, idx))
        dev = mesh.devices[idx]
        out[idx] = {name: _slice(t, specs[name], coords, sizes).contiguous().to(dev)
                    for name, t in state_dict.items()}
    return out


def replicate(state_dict: Dict[str, torch.Tensor], mesh: Mesh) -> np.ndarray:
    """The whole ``state_dict`` on every device of the mesh, in the layout
    of :func:`shard_params`."""
    out = np.empty(mesh.devices.shape, dtype=object)
    for idx in np.ndindex(mesh.devices.shape):
        out[idx] = {name: t.to(mesh.devices[idx]) for name, t in state_dict.items()}
    return out


def lm_attention_shards(config, tp: int) -> int:
    """Shards the LM's attention heads are split over: tp when it divides
    them, else 1 (the attention stays whole)."""
    return tp if config.n_heads % tp == 0 else 1


def lm_mlp_shards(config, tp: int) -> int:
    """Shards the LM's SwiGLU is split over: tp when it divides d_ff, else 1."""
    return tp if config.d_ff % tp == 0 else 1


def lm_unit_spec(config, tp: int) -> Callable:
    """``lm_param_spec`` over whole units: a part whose heads (or ff
    columns) tp does not divide replicates."""
    def spec(path, leaf=None):
        parent = str(path[-2]) if len(path) >= 2 else ""
        if parent in ("q", "k", "v", "o") and lm_attention_shards(config, tp) == 1:
            return ()
        if parent in ("gate", "up", "down") and lm_mlp_shards(config, tp) == 1:
            return ()
        return lm_param_spec(path, leaf)
    return spec


def port_split_dim(shape: Sequence[int], kernel_shape: Sequence[int], transposed: bool,
                   kernel_spec: Spec, tp: int) -> Optional[int]:
    """The dim of a port weight of ``shape`` that the ``model`` axis splits,
    or None.  ``kernel_spec`` is the JAX rule's spec of its Flax kernel
    (``kernel_shape``); a kernel dim tp does not divide replicates
    (``_param_shardings``).  A transposed kernel is ``[in..., out...]`` of
    the port's ``[out, in]``: its leading dims whose product is the port's
    input width are the input side."""
    if tp == 1 or "model" not in kernel_spec:
        return None
    kdim = list(kernel_spec).index("model")
    if kernel_shape[kdim] % tp:
        return None
    if not transposed:
        return kdim
    n_in = 1
    while math.prod(kernel_shape[:n_in]) != shape[-1]:
        n_in += 1
    return 0 if kdim >= n_in else 1


def shard_module(model: nn.Module, devices: Sequence[torch.device],
                 dims: Dict[str, Optional[int]]) -> nn.Module:
    """Split ``model`` in place over ``devices`` (one a shard): every
    bias-free Dense whose ``<name>.weight`` has a split dim in ``dims``
    becomes a ``ShardedDense`` over the devices; every other parameter
    moves to ``devices[0]``.  With one device this only moves the model."""
    from tpu_air_torch.models.layers import Dense

    from .tensor_parallel import ShardedDense

    home = devices[0]
    if len(devices) > 1:
        for name, module in list(model.named_modules()):
            dim = dims.get(f"{name}.weight")
            if dim is None or not isinstance(module, Dense):
                continue
            if module.bias is not None:
                raise ValueError(f"{name}: a Dense with a bias is not split")
            parent, _, child = name.rpartition(".")
            owner = model.get_submodule(parent) if parent else model
            setattr(owner, child, ShardedDense(module.weight, dim, devices,
                                               module.compute_dtype))
    for name, p in model.named_parameters():
        if ".shards." not in name and p.device != torch.device(home):
            p.data = p.data.to(home)
    return model


def logical_parameters(model: nn.Module) -> List[Tuple[str, List[nn.Parameter], Optional[int]]]:
    """The model's parameters as the unsplit model names them, in its
    order: ``(name, shards, dim)``, one shard and dim None for a whole
    parameter, a ShardedDense's shards and split dim for a split one."""
    from .tensor_parallel import ShardedDense

    out, seen = [], set()
    for mname, module in model.named_modules():
        if isinstance(module, ShardedDense):
            out.append((f"{mname}.weight", list(module.shards), module.dim))
            seen.update(id(p) for p in module.shards)
            continue
        for pname, p in module.named_parameters(recurse=False):
            if id(p) not in seen:
                out.append((f"{mname}.{pname}" if mname else pname, [p], None))
                seen.add(id(p))
    return out


def gather_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The logical state dict of a model split by :func:`shard_module`
    (the unsplit model's keys and shapes; a split weight is its shards
    concatenated on the first shard's device), buffers included."""
    out = {name: (shards[0] if dim is None else torch.cat(
        [p.to(shards[0].device) for p in shards], dim)).detach()
        for name, shards, dim in logical_parameters(model)}
    out.update({n: b for n, b in model.named_buffers()})
    return out


def params_bytes(model: nn.Module) -> Tuple[int, int]:
    """(bytes of the logical parameters, bytes the first device holds: a
    whole parameter in full, a split one's first shard), as the JAX loops
    count ``nbytes`` and ``addressable_shards[0]``."""
    total = per_device = 0
    for _, shards, _ in logical_parameters(model):
        sizes = [p.numel() * p.element_size() for p in shards]
        total += sum(sizes)
        per_device += sizes[0]
    return total, per_device
