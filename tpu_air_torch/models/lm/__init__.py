"""PyTorch long-context causal LM family (counterpart of tpu_air.models.lm):
the model and its training losses, KV-cache decoding, ``generate`` and the
continuous-batching engines' entry points."""

from .config import LMConfig
from .convert import cache_from_jax, cache_to_jax, params_from_jax, shard_params_from_jax
from .generate import (
    generate,
    init_cache,
    init_paged_cache,
    init_slot_cache,
    make_lm_decode_step_fn,
    make_lm_generate_fn,
    make_lm_paged_decode_step_fn,
    make_lm_prefill_chunk_fn,
    make_lm_prefill_fn,
    page_copy,
)
from .modeling import (
    AttnCache,
    CausalLM,
    head_weight,
    lm_chunked_loss_with_targets,
    lm_loss,
    lm_loss_with_targets,
)

__all__ = [
    "AttnCache",
    "CausalLM",
    "LMConfig",
    "cache_from_jax",
    "cache_to_jax",
    "generate",
    "head_weight",
    "init_cache",
    "init_paged_cache",
    "init_slot_cache",
    "lm_chunked_loss_with_targets",
    "lm_loss",
    "lm_loss_with_targets",
    "make_lm_decode_step_fn",
    "make_lm_generate_fn",
    "make_lm_paged_decode_step_fn",
    "make_lm_prefill_chunk_fn",
    "make_lm_prefill_fn",
    "page_copy",
    "params_from_jax",
    "shard_params_from_jax",
]
