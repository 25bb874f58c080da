"""Load a local Hugging Face T5 directory (``config.json`` +
``model.safetensors``) into the port, without ``transformers`` or
``safetensors``: the file format is read here directly.

The name mapping is a copy of ``tpu_air/models/t5/hf_import.py``'s
``convert_t5_state_dict``; the port's Linear layers keep torch's
``[out, in]`` layout, so HF weights need renaming only.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any, Dict, Mapping, Union

import torch

from tpu_air_torch.device import DeviceLike, resolve_device

from .config import T5Config
from .modeling import T5ForConditionalGeneration, torch_dtype

_ST_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool,
}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of a ``.safetensors`` file, on the CPU.  Format: an
    8-byte little-endian header length, a JSON header mapping names to
    ``{dtype, shape, data_offsets}``, then the raw little-endian bytes."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = bytearray(f.read())
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _ST_DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: unsupported safetensors dtype {info['dtype']}")
        begin, end = info["data_offsets"]
        count = (end - begin) // torch.empty((), dtype=dtype).element_size()
        t = torch.frombuffer(data, dtype=dtype, count=count, offset=begin) if count else \
            torch.empty(0, dtype=dtype)
        out[name] = t.reshape(info["shape"])
    return out


def convert_t5_state_dict(sd: Mapping[str, Any], config: T5Config) -> Dict[str, torch.Tensor]:
    """Map an HF T5 state dict onto the port's parameter names."""
    sd = {k: torch.as_tensor(v) for k, v in sd.items()}
    out: Dict[str, torch.Tensor] = {"shared.weight": sd["shared.weight"]}

    def attn(dst: str, src: str) -> None:
        for n in ("q", "k", "v", "o"):
            out[f"{dst}.{n}.weight"] = sd[f"{src}.{n}.weight"]

    def mlp(dst: str, src: str) -> None:
        names = ("wi_0", "wi_1", "wo") if config.is_gated_act else ("wi", "wo")
        for n in names:
            out[f"{dst}.{n}.weight"] = sd[f"{src}.{n}.weight"]

    for stack, n_layers in (("encoder", config.num_layers),
                            ("decoder", config.num_decoder_layers)):
        out[f"{stack}.rel_bias.embedding"] = sd[
            f"{stack}.block.0.layer.0.SelfAttention.relative_attention_bias.weight"]
        out[f"{stack}.final_ln.weight"] = sd[f"{stack}.final_layer_norm.weight"]
        for i in range(n_layers):
            b, dst = f"{stack}.block.{i}", f"{stack}.layers.{i}"
            attn(f"{dst}.self_attn", f"{b}.layer.0.SelfAttention")
            out[f"{dst}.ln_self.weight"] = sd[f"{b}.layer.0.layer_norm.weight"]
            last = 1
            if stack == "decoder":
                attn(f"{dst}.cross_attn", f"{b}.layer.1.EncDecAttention")
                out[f"{dst}.ln_cross.weight"] = sd[f"{b}.layer.1.layer_norm.weight"]
                last = 2
            mlp(f"{dst}.mlp", f"{b}.layer.{last}.DenseReluDense")
            out[f"{dst}.ln_mlp.weight"] = sd[f"{b}.layer.{last}.layer_norm.weight"]
    if not config.tie_word_embeddings:
        out["lm_head.weight"] = sd["lm_head.weight"]
    return out


def config_from_hf(hf_config: Union[Mapping[str, Any], Any]) -> T5Config:
    """T5Config from an HF config: a ``config.json`` dict or an object with
    the same attributes."""
    get = (hf_config.get if isinstance(hf_config, Mapping)
           else lambda k, d=None: getattr(hf_config, k, d))
    return T5Config(
        vocab_size=get("vocab_size"),
        d_model=get("d_model"),
        d_kv=get("d_kv"),
        d_ff=get("d_ff"),
        num_layers=get("num_layers"),
        num_decoder_layers=get("num_decoder_layers"),
        num_heads=get("num_heads"),
        relative_attention_num_buckets=get("relative_attention_num_buckets"),
        relative_attention_max_distance=get("relative_attention_max_distance", 128),
        dropout_rate=get("dropout_rate"),
        layer_norm_epsilon=get("layer_norm_epsilon"),
        feed_forward_proj=get("feed_forward_proj").replace("gated-gelu_new", "gated-gelu"),
        tie_word_embeddings=get("tie_word_embeddings"),
        pad_token_id=get("pad_token_id"),
        eos_token_id=get("eos_token_id"),
        decoder_start_token_id=get("decoder_start_token_id"),
    )


def load_t5(path: str, dtype: str = "float32",
            device: DeviceLike = None) -> T5ForConditionalGeneration:
    """Build the model from a local HF directory on ``device`` (``cuda:0``
    by default; raises without a GPU unless ``device="cpu"``), weights cast
    to ``dtype`` once, here (an inference load)."""
    dev = resolve_device(device)
    with open(os.path.join(path, "config.json")) as f:
        config = config_from_hf(json.load(f))
    config.dtype = dtype
    torch_dtype(dtype)  # reject a type the kernels do not take before building
    sd = convert_t5_state_dict(read_safetensors(os.path.join(path, "model.safetensors")),
                               config)
    model = T5ForConditionalGeneration(config, device=dev)
    model.load_state_dict(sd)
    return model.to(torch_dtype(dtype))


def load_t5_from_hf(name_or_path: str, dtype: str = "float32",
                    device: DeviceLike = None) -> T5ForConditionalGeneration:
    """The JAX package's entry under its name: :func:`load_t5` of a local
    Hugging Face directory.  The port downloads nothing, so a name that is
    no directory (a hub id such as ``google/flan-t5-base``) raises; point
    it at a downloaded copy instead."""
    if not os.path.isdir(name_or_path):
        raise FileNotFoundError(
            f"load_t5_from_hf takes a local directory with config.json and "
            f"model.safetensors; {name_or_path!r} is none (the port downloads nothing)")
    return load_t5(name_or_path, dtype=dtype, device=device)
