"""Carry the JAX package's LM weights into the port.

``params_from_jax`` maps a Flax ``CausalLM`` parameter tree (nested dicts of
numpy arrays, as ``jax.device_get`` returns it) onto the state dict of
:class:`tpu_air_torch.models.lm.modeling.CausalLM`.  It takes plain numpy, so
it imports nothing of JAX.  Flax ``Dense`` kernels are ``[in, out]`` and
become ``nn.Linear`` weights ``[out, in]``; the embedding ``[vocab,
d_model]`` (tied to the head unless ``lm_head`` is present) and the RMSNorm
weights carry over as they are.  ``params_to_jax`` is the inverse.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


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
