"""T5 configuration (a copy of ``tpu_air/models/t5/config.py``).

Covers the FLAN-T5 family: the T5 v1.1 architecture with gated-GELU MLP,
untied embedding and lm_head, RMSNorm, relative position bias and no
attention score scaling.  The fields are the JAX package's, so a config
round-trips through ``to_dict`` / ``from_dict`` between the two packages.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Optional


@dataclass
class T5Config:
    vocab_size: int = 32128
    d_model: int = 512
    d_kv: int = 64
    d_ff: int = 1024
    num_layers: int = 8
    num_decoder_layers: Optional[int] = None
    num_heads: int = 6
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    dropout_rate: float = 0.1
    layer_norm_epsilon: float = 1e-6
    feed_forward_proj: str = "gated-gelu"  # v1.1 / FLAN; "relu" for t5 v1.0
    tie_word_embeddings: bool = False
    pad_token_id: int = 0
    eos_token_id: int = 1
    decoder_start_token_id: int = 0
    # activation dtype; weights are cast to it when the model is built
    dtype: str = "float32"
    # Attention dispatch knobs of the JAX package.  The port does NOT read
    # them: on a CUDA tensor every eligible call runs the hand kernels, on a
    # CPU tensor the plain versions.  They stay so that configs round-trip;
    # their defaults (the 1024 flash crossover, the "auto" decode choice)
    # were measured on a TPU v5e and say nothing about the H100.
    attention_impl: str = "auto"
    flash_min_seq_len: int = 1024
    use_flash_attention: bool = False
    # Opt-in int8 decode caches: cross-attention K/V with per-(batch,
    # channel) scales, self-attention slabs with per-(batch, position, head)
    # scales.  Read by the port.
    decode_cache_int8: bool = False
    decode_attention_impl: str = "auto"  # not read by the port (see above)

    def __post_init__(self):
        if self.num_decoder_layers is None:
            self.num_decoder_layers = self.num_layers

    @property
    def is_gated_act(self) -> bool:
        return "gated" in self.feed_forward_proj

    @property
    def act_fn(self) -> str:
        proj = self.feed_forward_proj
        return proj.split("-")[-1] if "-" in proj else proj

    # -- presets -----------------------------------------------------------
    @classmethod
    def tiny(cls, vocab_size: int = 384) -> "T5Config":
        """Test-dial config."""
        return cls(
            vocab_size=vocab_size, d_model=64, d_kv=16, d_ff=128,
            num_layers=2, num_heads=4, dropout_rate=0.0,
        )

    @classmethod
    def flan_t5_small(cls) -> "T5Config":
        return cls(d_model=512, d_kv=64, d_ff=1024, num_layers=8, num_heads=6)

    @classmethod
    def flan_t5_base(cls) -> "T5Config":
        return cls(d_model=768, d_kv=64, d_ff=2048, num_layers=12, num_heads=12)

    @classmethod
    def flan_t5_large(cls) -> "T5Config":
        return cls(d_model=1024, d_kv=64, d_ff=2816, num_layers=24, num_heads=16)

    @classmethod
    def flan_t5_xl(cls) -> "T5Config":
        return cls(d_model=2048, d_kv=64, d_ff=5120, num_layers=24, num_heads=32)

    @classmethod
    def from_name(cls, name: str) -> "T5Config":
        key = name.split("/")[-1].replace("flan-t5-", "").replace("t5-", "")
        presets = {
            "tiny": cls.tiny,
            "small": cls.flan_t5_small,
            "base": cls.flan_t5_base,
            "large": cls.flan_t5_large,
            "xl": cls.flan_t5_xl,
        }
        if key not in presets:
            raise ValueError(f"unknown T5 preset {name!r}")
        return presets[key]()

    # -- (de)serialization --------------------------------------------------
    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "T5Config":
        return cls(**{k: v for k, v in d.items() if k in {f.name for f in dataclasses.fields(cls)}})

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2)

    @classmethod
    def from_json(cls, s: str) -> "T5Config":
        return cls.from_dict(json.loads(s))
