"""Config for the long-context causal LM family (a copy of
``tpu_air/models/lm/config.py``; the port imports nothing of ``tpu_air``)."""

from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import Optional


@dataclass
class LMConfig:
    """Decoder-only transformer (RoPE + SwiGLU, pre-RMSNorm, tied
    embeddings).

    ``attention``, ``flash_min_seq_len``, ``sequence_axis``, ``block_q`` and
    ``block_k`` are kept so configs round-trip with the JAX package, but the
    port does not read them: their defaults are TPU measurements.  Attention
    is the flash kernel on a CUDA tensor and its plain version on the CPU.
    """

    vocab_size: int = 32000
    d_model: int = 512
    n_layers: int = 4
    n_heads: int = 8
    head_dim: Optional[int] = None  # default d_model // n_heads
    d_ff: Optional[int] = None      # default 4 * d_model (SwiGLU uses 2/3)
    max_seq_len: int = 2048
    rope_theta: float = 10000.0
    rmsnorm_eps: float = 1e-6
    dropout_rate: float = 0.0
    dtype: str = "float32"
    tie_embeddings: bool = True
    attention: str = "auto"
    flash_min_seq_len: int = 1024
    sequence_axis: Optional[str] = None
    block_q: Optional[int] = None
    block_k: Optional[int] = None
    pad_token_id: int = 0
    eos_token_id: Optional[int] = None  # None: generation never early-stops

    def __post_init__(self):
        if self.head_dim is None:
            self.head_dim = self.d_model // self.n_heads
        if self.d_ff is None:
            self.d_ff = int(8 * self.d_model / 3 + 255) // 256 * 256

    def to_dict(self) -> dict:
        return asdict(self)

    def to_json(self) -> str:
        """Checkpoint serialization (``model_config.json``); ``model_type``
        tags the config class for reconstruction."""
        import json

        return json.dumps({**self.to_dict(), "model_type": "causal_lm"})

    @classmethod
    def from_dict(cls, d: dict) -> "LMConfig":
        return cls(**{k: v for k, v in d.items() if k in cls.__dataclass_fields__})

    @classmethod
    def tiny(cls, vocab_size: int = 384) -> "LMConfig":
        return cls(vocab_size=vocab_size, d_model=64, n_layers=2, n_heads=4,
                   head_dim=16, d_ff=128, max_seq_len=512)
