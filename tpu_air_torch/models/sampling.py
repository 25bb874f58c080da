"""Token sampler for the autoregressive generate loop (counterpart of
``tpu_air/models/sampling.py``)."""

from __future__ import annotations

from typing import Optional

import torch


def sample_token(logits: torch.Tensor, generator: Optional[torch.Generator],
                 do_sample: bool, temperature: float, top_k: int) -> torch.Tensor:
    """Greedy argmax (first index on ties, as jnp.argmax), or temperature /
    top-k categorical sampling drawn from ``generator``.  ``logits`` ``[b, V]``
    -> ``[b]`` int64."""
    if not do_sample:
        return logits.argmax(dim=-1)
    logits = logits.float() / max(temperature, 1e-6)
    if top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, torch.full_like(logits, -1e9), logits)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]
