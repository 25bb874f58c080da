"""PyTorch long-context causal LM family (counterpart of tpu_air.models.lm,
its training path; generation waits for a later slice)."""

from .config import LMConfig
from .convert import params_from_jax
from .modeling import (
    CausalLM,
    head_weight,
    lm_chunked_loss_with_targets,
    lm_loss,
    lm_loss_with_targets,
)

__all__ = [
    "LMConfig",
    "params_from_jax",
    "CausalLM",
    "head_weight",
    "lm_chunked_loss_with_targets",
    "lm_loss",
    "lm_loss_with_targets",
]
