"""Carry the JAX package's LM weights into the port.

``params_from_jax`` maps a Flax ``CausalLM`` parameter tree (nested dicts of
numpy arrays, as ``jax.device_get`` returns it) onto the state dict of
:class:`tpu_air_torch.models.lm.modeling.CausalLM`.  It takes plain numpy, so
it imports nothing of JAX.  Flax ``Dense`` kernels are ``[in, out]`` and
become ``nn.Linear`` weights ``[out, in]``; the embedding ``[vocab,
d_model]`` (tied to the head unless ``lm_head`` is present) and the RMSNorm
weights carry over as they are.
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
