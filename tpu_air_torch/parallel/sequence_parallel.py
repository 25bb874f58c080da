"""The long-context LM train step, one card (the ``sequence_parallel == 1``
case of ``tpu_air/parallel/sequence_parallel.py``).

On one device the JAX package's ring attention is a single diagonal hop,
``flash_attention_with_lse(..., causal=True)``, merged exactly into the zero
state; the port calls causal flash attention directly (the model does).
The loss recipe is the same: global next-token targets shifted on the host
before any sharding, RoPE positions from offset 0, hidden states through
the chunked lm-head CE, and ``loss = sum / max(count, 1)``.  A sequence
split over several cards needs the ``torch.distributed`` ring (ROADMAP
Queue 1 item 8) and raises here.
"""

from __future__ import annotations

import torch

from tpu_air_torch.models.lm import head_weight, lm_chunked_loss_with_targets


def shift_targets(input_ids: torch.Tensor, pad_token_id: int) -> torch.Tensor:
    """Global next-token shift: position i's target is token i+1; the final
    position gets pad and is masked."""
    pad = torch.full((input_ids.shape[0], 1), pad_token_id, dtype=input_ids.dtype,
                     device=input_ids.device)
    return torch.cat([input_ids[:, 1:], pad], dim=1)


def sp_local_loss(model, input_ids, targets):
    """Unnormalized (sum, count) of the chunked lm-head CE, positions
    0..L-1: the recipe the train step differentiates and eval reports."""
    hidden = model(input_ids, return_hidden=True)
    return lm_chunked_loss_with_targets(hidden, head_weight(model), targets,
                                        model.config.pad_token_id)


def make_sp_train_step(model, optimizer, sp: int = 1):
    """``step(input_ids, targets) -> loss`` (a detached device scalar): the
    mean CE over non-pad targets, its gradient, one ``optimizer.step()``.
    ``optimizer`` is the object ``_make_optimizer`` returns."""
    if sp != 1:
        raise NotImplementedError(
            f"sequence_parallel={sp}: the multi-card ring attention (torch.distributed "
            "around flash-with-lse) is not ported yet (ROADMAP Queue 1 item 8)")

    def step(input_ids, targets):
        s, c = sp_local_loss(model, input_ids, targets)
        # count is independent of the parameters: grad(s / C) = grad(s) / C
        loss = s / torch.clamp(c.detach(), min=1.0)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step
