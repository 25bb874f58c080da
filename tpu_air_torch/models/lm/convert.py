"""Carry the JAX package's LM weights into the port.

``params_from_jax`` maps a Flax ``CausalLM`` parameter tree (nested dicts of
numpy arrays, as ``jax.device_get`` returns it) onto the state dict of
:class:`tpu_air_torch.models.lm.modeling.CausalLM`.  It takes plain numpy, so
it imports nothing of JAX.  Flax ``Dense`` kernels are ``[in, out]`` and
become ``nn.Linear`` weights ``[out, in]``; the embedding ``[vocab,
d_model]`` (tied to the head unless ``lm_head`` is present) and the RMSNorm
weights carry over as they are.  ``params_to_jax`` is the inverse, and
``jax_layouts`` reports the layout of each parameter for the optimizers
whose rule reads it (Adafactor's factoring).  ``shard_params_from_jax``
carries the tree straight onto a ``(data, model)`` mesh: the conversion,
then ``parallel.sharding.shard_params`` under the JAX package's LM rule.

``cache_from_jax`` / ``cache_to_jax`` carry a decode cache both ways: the
Flax ``"cache"`` collection (``{"layer_i": {"attn": {cached_key,
cached_value, cache_index[, block_table]}}}``, numpy leaves) and the port's
list of per-layer :class:`~tpu_air_torch.models.lm.modeling.AttnCache`, so
one step of each decode branch can run on both packages from one state.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .config import LMConfig
from .modeling import AttnCache, CausalLM


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C"))


def params_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax param tree (numpy leaves) -> the port's state dict (f32, CPU)."""
    sd: Dict[str, torch.Tensor] = {"embedding": _tensor(params["embedding"])}
    n_layers = sum(1 for name in params if name.startswith("layer_"))
    for i in range(n_layers):
        src, dst = params[f"layer_{i}"], f"layers.{i}"
        for part, names in (("attn", ("q", "k", "v", "o")), ("mlp", ("gate", "up", "down"))):
            for n in names:
                sd[f"{dst}.{part}.{n}.weight"] = _tensor(np.asarray(src[part][n]["kernel"]).T)
        for norm in ("attn_norm", "mlp_norm"):
            sd[f"{dst}.{norm}.weight"] = _tensor(src[norm]["weight"])
    sd["final_norm.weight"] = _tensor(params["final_norm"]["weight"])
    if "lm_head" in params:
        sd["lm_head.weight"] = _tensor(np.asarray(params["lm_head"]["kernel"]).T)
    return sd


def shard_params_from_jax(params: Dict[str, Any], mesh) -> np.ndarray:
    """Flax param tree (numpy leaves) -> every mesh device's slice of the
    port's state dict (``shard_params`` with ``lm_param_spec``): an object
    array in the mesh's shape of state dicts on their devices."""
    from tpu_air_torch.parallel.sharding import lm_param_spec, shard_params

    return shard_params(params_from_jax(params), mesh, lm_param_spec)


def jax_layouts(config: LMConfig) -> Dict[str, Tuple[bool, Tuple[int, ...]]]:
    """Per port parameter, how the JAX package holds it: whether its kernel
    is the transpose of the port's weight (every Dense kernel, ``[in,
    out]``), and the kernel's shape.  The embedding and the norms keep
    theirs.  The counterpart of ``models/t5/convert.py::jax_layouts``."""
    model = CausalLM(config, device="meta")
    out = {}
    for name, p in model.state_dict().items():
        shape = tuple(p.shape)
        dense = name.endswith(".weight") and "norm" not in name
        out[name] = (True, shape[::-1]) if dense else (False, shape)
    return out


def tp_split_dims(config: LMConfig, tp: int) -> Dict[str, Optional[int]]:
    """Per port parameter, the dim a ``model`` axis of ``tp`` splits (None:
    it stays whole): ``lm_param_spec`` on the Flax kernel, over whole heads
    and whole ff columns (``lm_unit_spec``), as the sharded engine splits
    them.  Adafactor reads a split parameter's logical layout in
    :func:`jax_layouts`."""
    from tpu_air_torch.parallel.sharding import lm_flax_path, lm_unit_spec, port_split_dim

    spec = lm_unit_spec(config, tp)
    out = {}
    for name, (transposed, kshape) in jax_layouts(config).items():
        path, _ = lm_flax_path(name)
        shape = kshape[::-1] if transposed else kshape
        out[name] = port_split_dim(shape, kshape, transposed, spec(path), tp)
    return out


def params_to_jax(state_dict: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """The port's state dict -> the Flax ``CausalLM`` param tree (f32 numpy
    leaves)."""
    def arr(name, transpose=False):
        w = state_dict[name].detach().to("cpu", torch.float32).numpy()
        return np.ascontiguousarray(w.T if transpose else w)

    tree: Dict[str, Any] = {"embedding": arr("embedding"),
                            "final_norm": {"weight": arr("final_norm.weight")}}
    n_layers = 1 + max(int(k.split(".")[1]) for k in state_dict if k.startswith("layers."))
    for i in range(n_layers):
        src = f"layers.{i}"
        layer: Dict[str, Any] = {}
        for part, names in (("attn", ("q", "k", "v", "o")), ("mlp", ("gate", "up", "down"))):
            layer[part] = {n: {"kernel": arr(f"{src}.{part}.{n}.weight", True)} for n in names}
        for norm in ("attn_norm", "mlp_norm"):
            layer[norm] = {"weight": arr(f"{src}.{norm}.weight")}
        tree[f"layer_{i}"] = layer
    if "lm_head.weight" in state_dict:
        tree["lm_head"] = {"kernel": arr("lm_head.weight", True)}
    return tree


def cache_from_jax(cache: Dict[str, Any], device="cpu") -> List[AttnCache]:
    """A Flax LM cache collection (numpy leaves) as the port's per-layer
    caches on ``device``: the slabs or pools keep their type, a 0-d
    ``cache_index`` becomes an int, a per-row one and the block table int64
    tensors."""
    out = []
    for i in range(sum(1 for name in cache if name.startswith("layer_"))):
        leaves = cache[f"layer_{i}"]["attn"]
        kv = [torch.from_numpy(np.array(leaves[n])).to(device)
              for n in ("cached_key", "cached_value")]
        idx = np.asarray(leaves["cache_index"])
        index = int(idx) if idx.ndim == 0 else torch.from_numpy(idx.astype(np.int64)).to(device)
        table = leaves.get("block_table")
        if table is not None:
            table = torch.from_numpy(np.asarray(table).astype(np.int64)).to(device)
        out.append(AttnCache(kv[0], kv[1], index, table))
    return out


def cache_to_jax(cache: List[AttnCache]) -> Dict[str, Any]:
    """The port's per-layer caches as a Flax LM cache collection of numpy
    leaves (int32 index and table, as the JAX package keeps them)."""
    def arr(t):
        return t.detach().cpu().numpy()

    tree: Dict[str, Any] = {}
    for i, c in enumerate(cache):
        index = c.cache_index
        leaves = {"cached_key": arr(c.cached_key), "cached_value": arr(c.cached_value),
                  "cache_index": (np.asarray(index, np.int32) if isinstance(index, int)
                                  else arr(index).astype(np.int32))}
        if c.block_table is not None:
            leaves["block_table"] = arr(c.block_table).astype(np.int32)
        tree[f"layer_{i}"] = {"attn": leaves}
    return tree
