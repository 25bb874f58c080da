"""SegFormer (Mix Transformer, MiT) configuration (a copy of
``tpu_air/models/segformer/config.py``).

The reference fine-tunes `nvidia/mit-b0` for semantic segmentation on ADE20K
(Scaling_model_training.ipynb:cc-16) and runs batch inference with
`nvidia/segformer-b0-finetuned-ade-512-512`
(Scaling_batch_inference.ipynb:cc-20-21).  This config covers the full MiT
family (b0-b5); defaults are MiT-b0.  The fields and ``to_json``'s
``model_type`` key are the JAX package's, so a config round-trips between
the two packages and a checkpoint loader dispatches on it.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import List


@dataclass
class SegformerConfig:
    num_channels: int = 3
    num_encoder_blocks: int = 4
    depths: List[int] = field(default_factory=lambda: [2, 2, 2, 2])
    sr_ratios: List[int] = field(default_factory=lambda: [8, 4, 2, 1])
    hidden_sizes: List[int] = field(default_factory=lambda: [32, 64, 160, 256])
    patch_sizes: List[int] = field(default_factory=lambda: [7, 3, 3, 3])
    strides: List[int] = field(default_factory=lambda: [4, 2, 2, 2])
    num_attention_heads: List[int] = field(default_factory=lambda: [1, 2, 5, 8])
    mlp_ratios: List[int] = field(default_factory=lambda: [4, 4, 4, 4])
    hidden_dropout_prob: float = 0.0
    attention_probs_dropout_prob: float = 0.0
    classifier_dropout_prob: float = 0.1
    drop_path_rate: float = 0.1
    layer_norm_eps: float = 1e-6
    decoder_hidden_size: int = 256
    num_labels: int = 150
    semantic_loss_ignore_index: int = 255
    dtype: str = "float32"

    @classmethod
    def from_dict(cls, d: dict) -> "SegformerConfig":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["model_type"] = "segformer"  # checkpoint-loader dispatch key
        return json.dumps(d)

    @classmethod
    def from_json(cls, s: str) -> "SegformerConfig":
        return cls.from_dict(json.loads(s))

    @classmethod
    def mit_b0(cls, **kw) -> "SegformerConfig":
        return cls(**kw)

    @classmethod
    def mit_b1(cls, **kw) -> "SegformerConfig":
        return cls(hidden_sizes=[64, 128, 320, 512], decoder_hidden_size=256, **kw)

    @classmethod
    def mit_b2(cls, **kw) -> "SegformerConfig":
        return cls(
            hidden_sizes=[64, 128, 320, 512],
            depths=[3, 4, 6, 3],
            decoder_hidden_size=768,
            **kw,
        )

    @classmethod
    def mit_b3(cls, **kw) -> "SegformerConfig":
        return cls(
            hidden_sizes=[64, 128, 320, 512],
            depths=[3, 4, 18, 3],
            decoder_hidden_size=768,
            **kw,
        )

    @classmethod
    def mit_b4(cls, **kw) -> "SegformerConfig":
        return cls(
            hidden_sizes=[64, 128, 320, 512],
            depths=[3, 8, 27, 3],
            decoder_hidden_size=768,
            **kw,
        )

    @classmethod
    def mit_b5(cls, **kw) -> "SegformerConfig":
        return cls(
            hidden_sizes=[64, 128, 320, 512],
            depths=[3, 6, 40, 3],
            decoder_hidden_size=768,
            **kw,
        )

    @classmethod
    def tiny(cls, **kw) -> "SegformerConfig":
        """Test-sized config (SURVEY.md §4.2 small-dials strategy)."""
        return cls(
            depths=[1, 1, 1, 1],
            hidden_sizes=[8, 16, 24, 32],
            num_attention_heads=[1, 1, 2, 2],
            decoder_hidden_size=32,
            num_labels=8,
            drop_path_rate=0.0,
            **kw,
        )
