"""Carry the JAX package's T5 weights into the port.

``params_from_jax`` maps a Flax T5 parameter tree (nested dicts of numpy
arrays, as ``jax.device_get`` returns it) onto the state dict of
:class:`tpu_air_torch.models.t5.modeling.T5ForConditionalGeneration`.  It
takes plain numpy, so it imports nothing of JAX.  Layouts:

* ``DenseGeneral`` q/k/v kernels ``[d_model, h, d_kv]`` -> Linear weight
  ``[h*d_kv, d_model]``; the o kernel ``[h, d_kv, d_model]`` -> ``[d_model, h*d_kv]``;
* ``Dense`` kernels ``[in, out]`` -> ``[out, in]``;
* ``rel_bias/embedding`` ``[buckets, h]`` and ``shared/embedding``
  ``[vocab, d_model]`` as they are; RMSNorm weights as they are.

One rule (``_layout``) holds them: ``params_from_jax`` applies it to every
parameter of the port's model, ``params_to_jax`` inverts it, and
``jax_layouts`` reports it.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .config import T5Config

_DENSE = ("wi", "wi_0", "wi_1", "wo", "lm_head")


def _layout(name: str, shape: Tuple[int, ...], config: T5Config) -> Tuple[bool, Tuple[int, ...]]:
    """(whether the JAX kernel is the transpose of the port's weight ``name``
    of ``shape``, the kernel's shape): the layouts above."""
    module = name.split(".")[-2]
    if module in ("q", "k", "v"):
        return True, (shape[1], config.num_heads, config.d_kv)
    if module == "o":
        return True, (config.num_heads, config.d_kv, shape[0])
    if module in _DENSE:
        return True, tuple(shape[::-1])
    return False, tuple(shape)


def _flax_path(name: str, transposed: bool) -> Tuple[str, ...]:
    """The Flax tree's path of the port's parameter ``name``."""
    if name == "shared.weight":
        return ("shared", "embedding")
    path = name.replace("layers.", "layer_").split(".")
    return tuple(path[:-1] + ["kernel"]) if transposed else tuple(path)


def _shapes(config: T5Config) -> Dict[str, Tuple[int, ...]]:
    """The port's parameter shapes, from a model built on the meta device."""
    from .modeling import T5ForConditionalGeneration

    model = T5ForConditionalGeneration(config, device="meta")
    return {n: tuple(p.shape) for n, p in model.state_dict().items()}


def jax_layouts(config: T5Config) -> Dict[str, Tuple[bool, Tuple[int, ...]]]:
    """Per port parameter, how the JAX package holds it: whether its kernel
    is the transpose of the port's weight, and the kernel's shape.  An
    optimizer whose rule depends on a parameter's shape, as Adafactor's
    factoring does, reads it here."""
    return {n: _layout(n, s, config) for n, s in _shapes(config).items()}


def tp_split_dims(config: T5Config, tp: int) -> Dict[str, Optional[int]]:
    """Per port parameter, the dim a ``model`` axis of ``tp`` splits (None:
    it stays whole): ``t5_param_spec`` on the Flax kernel, whose heads,
    d_ff or vocab tp must divide (``_param_shardings``).  Adafactor reads
    a split parameter's logical layout in :func:`jax_layouts`."""
    from tpu_air_torch.parallel.sharding import port_split_dim, t5_param_spec

    out = {}
    for name, shape in _shapes(config).items():
        transposed, kshape = _layout(name, shape, config)
        spec = t5_param_spec(_flax_path(name, transposed))
        out[name] = port_split_dim(shape, kshape, transposed, spec, tp)
    return out


def params_from_jax(params: Dict[str, Any], config: T5Config) -> Dict[str, torch.Tensor]:
    """Flax param tree (numpy leaves) -> the port's state dict (f32, CPU)."""
    sd: Dict[str, torch.Tensor] = {}
    for name, shape in _shapes(config).items():
        transposed, _ = _layout(name, shape, config)
        w = np.asarray(functools.reduce(lambda t, k: t[k], _flax_path(name, transposed), params))
        if transposed:          # [in..., out...] -> [out, in]
            w = w.reshape(shape[::-1]).T
        sd[name] = torch.from_numpy(np.array(w, dtype=np.float32, order="C"))
    return sd


def params_to_jax(state_dict: Dict[str, torch.Tensor], config: T5Config) -> Dict[str, Any]:
    """The port's state dict -> the Flax param tree (f32 numpy leaves) that
    the JAX package's ``T5ForConditionalGeneration`` applies."""
    tree: Dict[str, Any] = {}
    for name, shape in _shapes(config).items():
        transposed, kernel_shape = _layout(name, shape, config)
        w = state_dict[name].detach().to("cpu", torch.float32).numpy()
        if transposed:          # [out, in] -> [in..., out...]
            w = w.T.reshape(kernel_shape)
        *path, leaf = _flax_path(name, transposed)
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = np.ascontiguousarray(w)
    return tree
