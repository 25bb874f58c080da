"""Carry the JAX package's SegFormer weights into the port and back.

``params_from_jax(params, batch_stats, config)`` maps the Flax trees of
``tpu_air.models.segformer`` (nested dicts of numpy arrays: the ``params``
collection and the ``batch_stats`` collection) onto the state dict of
:class:`~tpu_air_torch.models.segformer.modeling.SegformerForSemanticSegmentation`;
``params_to_jax`` goes back to ``(params, batch_stats)``.  Plain numpy, so
nothing of JAX is imported.  One rule (``_rules``), read off the port's
module types, holds the layouts:

* ``Dense`` kernels ``[in, out]`` <-> Linear weights ``[out, in]``;
* ``Conv`` kernels HWIO ``(kh, kw, in/groups, out)`` <-> OIHW weights (the
  depthwise ``(3, 3, 1, C)`` <-> ``(C, 1, 3, 3)``);
* LayerNorm and BatchNorm ``scale`` <-> ``weight``, ``bias`` as it is;
* the batch norm's running ``mean`` and ``var`` (in ``batch_stats``) <->
  its ``running_mean`` and ``running_var`` buffers.

Every array is checked against the shape the config gives; a missing or
misshapen one raises, naming it.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .config import SegformerConfig

_BUFFERS = {"running_mean": "mean", "running_var": "var"}
# (collection, Flax path, layout, the port's shape) per state-dict name
Rule = Tuple[str, Tuple[str, ...], str, Tuple[int, ...]]


def _rules(config: SegformerConfig, model_cls=None) -> Dict[str, Rule]:
    from .modeling import BatchNorm, SegformerForSemanticSegmentation
    from tpu_air_torch.models.layers import Conv, Dense

    model = (model_cls or SegformerForSemanticSegmentation)(config, device="meta")
    rules: Dict[str, Rule] = {}
    for name, t in model.state_dict().items():
        mod_name, leaf = name.rsplit(".", 1)
        mod = model.get_submodule(mod_name)
        path = tuple(mod_name.split("."))
        shape = tuple(t.shape)
        if isinstance(mod, BatchNorm) and leaf in _BUFFERS:
            rules[name] = ("batch_stats", path + (_BUFFERS[leaf],), "plain", shape)
        elif leaf == "weight" and isinstance(mod, Conv):
            rules[name] = ("params", path + ("kernel",), "conv", shape)
        elif leaf == "weight" and isinstance(mod, Dense):
            rules[name] = ("params", path + ("kernel",), "dense", shape)
        elif leaf == "weight":
            rules[name] = ("params", path + ("scale",), "plain", shape)
        else:
            rules[name] = ("params", path + (leaf,), "plain", shape)
    return rules


def _to_port(w: np.ndarray, layout: str) -> np.ndarray:
    if layout == "conv":
        return w.transpose(3, 2, 0, 1)      # HWIO -> OIHW
    if layout == "dense":
        return w.T
    return w


def _to_jax(w: np.ndarray, layout: str) -> np.ndarray:
    if layout == "conv":
        return w.transpose(2, 3, 1, 0)      # OIHW -> HWIO
    if layout == "dense":
        return w.T
    return w


def params_from_jax(params: Dict[str, Any], batch_stats: Optional[Dict[str, Any]],
                    config: SegformerConfig, model_cls=None) -> Dict[str, torch.Tensor]:
    """Flax ``params`` and ``batch_stats`` (numpy leaves) -> the port's
    state dict (f32, CPU)."""
    trees = {"params": params, "batch_stats": batch_stats or {}}
    sd: Dict[str, torch.Tensor] = {}
    for name, (coll, path, layout, shape) in _rules(config, model_cls).items():
        try:
            w = functools.reduce(lambda t, k: t[k], path, trees[coll])
        except (KeyError, TypeError) as e:
            raise KeyError(f"{coll}/{'/'.join(path)} (for {name}) is missing") from e
        w = _to_port(np.asarray(w), layout)
        if tuple(w.shape) != shape:
            raise ValueError(f"{coll}/{'/'.join(path)} converts to shape {tuple(w.shape)}; "
                             f"{name} of this config is {shape}")
        sd[name] = torch.from_numpy(np.array(w, dtype=np.float32, order="C"))
    return sd


def params_to_jax(state_dict: Dict[str, torch.Tensor], config: SegformerConfig,
                  model_cls=None) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """The port's state dict -> ``(params, batch_stats)``, the Flax trees
    (f32 numpy leaves) the JAX package's model applies."""
    trees: Dict[str, Dict[str, Any]] = {"params": {}, "batch_stats": {}}
    for name, (coll, path, layout, shape) in _rules(config, model_cls).items():
        if name not in state_dict:
            raise KeyError(f"{name} is missing from the state dict")
        t = state_dict[name]
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}; this config's is {shape}")
        w = _to_jax(t.detach().to("cpu", torch.float32).numpy(), layout)
        node = trees[coll]
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = np.ascontiguousarray(w)
    return trees["params"], trees["batch_stats"]

