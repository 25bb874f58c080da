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
parameter of the port's model, and ``jax_layouts`` reports it.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Tuple

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
