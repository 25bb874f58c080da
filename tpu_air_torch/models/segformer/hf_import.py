"""HF → port weight import for SegFormer, a copy of
``tpu_air/models/segformer/hf_import.py``.

Conv-layout-faithful import of HF torch weights (`nvidia/mit-b0`,
`nvidia/segformer-b0-finetuned-ade-512-512` — the two checkpoints the
reference loads at Scaling_model_training.ipynb:cc-16 and
Scaling_batch_inference.ipynb:cc-20-21).  ``convert_segformer_state_dict``
and ``config_from_hf`` are the JAX package's, giving the Flax trees, which
:func:`~tpu_air_torch.models.segformer.convert.params_from_jax` carries
onto the port's model: one mapping, held against the JAX package by the
tests.  Pure numpy; torch only reads the source state dict.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np

from tpu_air_torch.device import DeviceLike

from .config import SegformerConfig


def _conv(w) -> np.ndarray:
    # torch conv (O, I, kh, kw) → flax (kh, kw, I, O); also correct for
    # depthwise convs ((C,1,3,3) → (3,3,1,C)).
    return np.ascontiguousarray(np.asarray(w).transpose(2, 3, 1, 0))


def _t(w) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(w).T)


def _ln(sd, prefix: str) -> Dict[str, np.ndarray]:
    return {"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]}


def _dense(sd, prefix: str) -> Dict[str, np.ndarray]:
    return {"kernel": _t(sd[f"{prefix}.weight"]), "bias": sd[f"{prefix}.bias"]}


def convert_segformer_state_dict(
    sd: Dict[str, Any], config: SegformerConfig
) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Map an HF torch Segformer state_dict onto (params, batch_stats).

    Handles both the segmentation form (`segformer.encoder…` + `decode_head…`)
    and the bare-backbone classification form (decode-head keys absent →
    returned trees omit `decode_head`, callers init it fresh, mirroring HF's
    "newly initialized" head warning when fine-tuning from `nvidia/mit-b0`).
    """
    sd = {k: np.asarray(v) for k, v in sd.items()}
    enc: Dict[str, Any] = {}
    for s in range(config.num_encoder_blocks):
        pe = f"segformer.encoder.patch_embeddings.{s}"
        enc[f"patch_embed_{s}"] = {
            "proj": {"kernel": _conv(sd[f"{pe}.proj.weight"]), "bias": sd[f"{pe}.proj.bias"]},
            "layer_norm": _ln(sd, f"{pe}.layer_norm"),
        }
        for d in range(config.depths[s]):
            b = f"segformer.encoder.block.{s}.{d}"
            attn: Dict[str, Any] = {
                "query": _dense(sd, f"{b}.attention.self.query"),
                "key": _dense(sd, f"{b}.attention.self.key"),
                "value": _dense(sd, f"{b}.attention.self.value"),
                "out": _dense(sd, f"{b}.attention.output.dense"),
            }
            if config.sr_ratios[s] > 1:
                attn["sr"] = {
                    "kernel": _conv(sd[f"{b}.attention.self.sr.weight"]),
                    "bias": sd[f"{b}.attention.self.sr.bias"],
                }
                attn["sr_norm"] = _ln(sd, f"{b}.attention.self.layer_norm")
            enc[f"block_{s}_{d}"] = {
                "layer_norm_1": _ln(sd, f"{b}.layer_norm_1"),
                "attention": attn,
                "layer_norm_2": _ln(sd, f"{b}.layer_norm_2"),
                "mlp": {
                    "dense1": _dense(sd, f"{b}.mlp.dense1"),
                    "dwconv": {
                        "kernel": _conv(sd[f"{b}.mlp.dwconv.dwconv.weight"]),
                        "bias": sd[f"{b}.mlp.dwconv.dwconv.bias"],
                    },
                    "dense2": _dense(sd, f"{b}.mlp.dense2"),
                },
            }
        enc[f"stage_norm_{s}"] = _ln(sd, f"segformer.encoder.layer_norm.{s}")

    params: Dict[str, Any] = {"encoder": enc}
    batch_stats: Dict[str, Any] = {}

    if "decode_head.linear_fuse.weight" in sd:
        head: Dict[str, Any] = {}
        for i in range(config.num_encoder_blocks):
            head[f"linear_c_{i}"] = _dense(sd, f"decode_head.linear_c.{i}.proj")
        head["linear_fuse"] = {"kernel": _conv(sd["decode_head.linear_fuse.weight"])}
        head["batch_norm"] = {
            "scale": sd["decode_head.batch_norm.weight"],
            "bias": sd["decode_head.batch_norm.bias"],
        }
        head["classifier"] = {
            "kernel": _conv(sd["decode_head.classifier.weight"]),
            "bias": sd["decode_head.classifier.bias"],
        }
        params["decode_head"] = head
        batch_stats["decode_head"] = {
            "batch_norm": {
                "mean": sd["decode_head.batch_norm.running_mean"],
                "var": sd["decode_head.batch_norm.running_var"],
            }
        }
    return params, batch_stats


def config_from_hf(hf_config) -> SegformerConfig:
    return SegformerConfig(
        num_channels=hf_config.num_channels,
        num_encoder_blocks=hf_config.num_encoder_blocks,
        depths=list(hf_config.depths),
        sr_ratios=list(hf_config.sr_ratios),
        hidden_sizes=list(hf_config.hidden_sizes),
        patch_sizes=list(hf_config.patch_sizes),
        strides=list(hf_config.strides),
        num_attention_heads=list(hf_config.num_attention_heads),
        mlp_ratios=list(hf_config.mlp_ratios),
        hidden_dropout_prob=hf_config.hidden_dropout_prob,
        attention_probs_dropout_prob=hf_config.attention_probs_dropout_prob,
        classifier_dropout_prob=hf_config.classifier_dropout_prob,
        drop_path_rate=hf_config.drop_path_rate,
        layer_norm_eps=hf_config.layer_norm_eps,
        decoder_hidden_size=hf_config.decoder_hidden_size,
        num_labels=getattr(hf_config, "num_labels", 150),
    )


def load_segformer_from_hf(
    name_or_path: str,
    dtype: str = "float32",
    num_labels: Optional[int] = None,
    seed: int = 0,
    device: DeviceLike = None,
):
    """Load a local HF Segformer checkpoint into the port's
    ``SegformerForSemanticSegmentation`` on ``device`` (``cuda:0`` by
    default; raises without a GPU unless ``device="cpu"``), cast to
    ``dtype`` once, here.  Reads the directory through ``transformers``, as
    the JAX package does, and fetches nothing.  A missing decode head (bare
    `nvidia/mit-b0` backbone) is freshly initialized from ``seed``, matching
    the reference's fine-tune-from-backbone flow
    (Scaling_model_training.ipynb:cc-16)."""
    from transformers import AutoConfig, AutoModel

    from tpu_air_torch.device import resolve_device
    from tpu_air_torch.models.layers import torch_dtype

    device = resolve_device(device)  # no card and no device named: raise before reading

    from .convert import params_from_jax
    from .modeling import SegformerForSemanticSegmentation

    hf_config = AutoConfig.from_pretrained(name_or_path)
    config = config_from_hf(hf_config)
    if num_labels is not None:
        config.num_labels = num_labels
    config.dtype = dtype
    torch_dtype(dtype)  # reject a type the port does not take before building
    model = SegformerForSemanticSegmentation(config, device=device)

    try:
        from transformers import SegformerForSemanticSegmentation as TorchSeg

        torch_model = TorchSeg.from_pretrained(name_or_path)
    except Exception:  # noqa: BLE001 — head-ful load fails on bare backbones; retry as AutoModel
        torch_model = AutoModel.from_pretrained(name_or_path)
    sd = {k: v.detach().cpu().numpy() for k, v in torch_model.state_dict().items()}
    # Bare-backbone checkpoints (AutoModel → SegformerModel) lack the
    # "segformer." prefix the converter keys on — normalize.
    if not any(k.startswith("segformer.") for k in sd):
        sd = {f"segformer.{k}": v for k, v in sd.items()}
    params, batch_stats = convert_segformer_state_dict(sd, config)

    if "decode_head" not in params:
        model.init_weights(seed)
        from .convert import params_to_jax

        fresh, batch_stats = params_to_jax(model.state_dict(), config)
        params["decode_head"] = fresh["decode_head"]
    model.load_state_dict(params_from_jax(params, batch_stats, config))
    return model.to(torch_dtype(dtype))
