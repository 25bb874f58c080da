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
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .config import T5Config


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C"))


def params_from_jax(params: Dict[str, Any], config: T5Config) -> Dict[str, torch.Tensor]:
    """Flax param tree (numpy leaves) -> the port's state dict (f32, CPU)."""
    h, dkv, dm = config.num_heads, config.d_kv, config.d_model
    sd: Dict[str, torch.Tensor] = {"shared.weight": _tensor(params["shared"]["embedding"])}

    def attn(dst: str, src: Dict[str, Any]) -> None:
        for n in ("q", "k", "v"):
            w = np.asarray(src[n]["kernel"]).reshape(dm, h * dkv)
            sd[f"{dst}.{n}.weight"] = _tensor(w.T)
        w = np.asarray(src["o"]["kernel"]).reshape(h * dkv, dm)
        sd[f"{dst}.o.weight"] = _tensor(w.T)

    def dense(dst: str, src: Dict[str, Any]) -> None:
        sd[f"{dst}.weight"] = _tensor(np.asarray(src["kernel"]).T)

    def mlp(dst: str, src: Dict[str, Any]) -> None:
        for n in ("wi_0", "wi_1", "wi", "wo"):
            if n in src:
                dense(f"{dst}.{n}", src[n])

    for stack, n_layers, parts in (
        ("encoder", config.num_layers, ("self_attn",)),
        ("decoder", config.num_decoder_layers, ("self_attn", "cross_attn")),
    ):
        tree = params[stack]
        sd[f"{stack}.rel_bias.embedding"] = _tensor(tree["rel_bias"]["embedding"])
        sd[f"{stack}.final_ln.weight"] = _tensor(tree["final_ln"]["weight"])
        for i in range(n_layers):
            src = tree[f"layer_{i}"]
            dst = f"{stack}.layers.{i}"
            for part in parts:
                attn(f"{dst}.{part}", src[part])
            mlp(f"{dst}.mlp", src["mlp"])
            for ln in ("ln_self", "ln_cross", "ln_mlp"):
                if ln in src:
                    sd[f"{dst}.{ln}.weight"] = _tensor(src[ln]["weight"])
    if not config.tie_word_embeddings:
        dense("lm_head", params["lm_head"])
    return sd
