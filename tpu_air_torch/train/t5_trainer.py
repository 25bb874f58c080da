"""The pieces of ``tpu_air/train/t5_trainer.py`` the LM loop uses:
``TrainingArguments``, ``collate`` and ``_make_optimizer``.  T5 training
itself is the next slice of the port.

``_make_optimizer`` reproduces the JAX package's optax chain,
``clip_by_global_norm(max_grad_norm)`` then ``adamw(schedule, b1=0.9,
b2=0.999, eps=1e-8, weight_decay)`` with the decay on every parameter, as
``torch.optim.AdamW`` plus the same clipping and schedule evaluated at the
0-based update count.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch


@dataclass
class TrainingArguments:
    """The fields of the JAX package's TrainingArguments that the LM loop
    reads.  Its tensor-parallel, remat, logging and tqdm fields are left out:
    nothing in the port reads them yet."""

    learning_rate: float = 2e-5
    per_device_train_batch_size: int = 2
    per_device_eval_batch_size: Optional[int] = None
    num_train_epochs: int = 4
    weight_decay: float = 0.01
    warmup_steps: int = 0
    max_grad_norm: float = 1.0
    optimizer: str = "adamw"  # or "adafactor"
    lr_scheduler_type: str = "constant"  # or "linear" / "cosine" decay to 0
    seed: int = 42
    evaluation_strategy: str = "epoch"
    save_strategy: str = "epoch"
    max_steps_per_epoch: Optional[int] = None  # test dial

    def __post_init__(self):
        if self.per_device_eval_batch_size is None:
            self.per_device_eval_batch_size = self.per_device_train_batch_size


def collate(batch_df, keys, seq_len: Optional[int] = None) -> Dict[str, np.ndarray]:
    """DataFrame of per-row token lists -> stacked int32 arrays."""
    out = {}
    for k in keys:
        col = [np.asarray(v, dtype=np.int32) for v in batch_df[k]]
        out[k] = np.stack(col)
        if seq_len is not None and out[k].shape[1] != seq_len:
            raise ValueError(
                f"column {k} has seq len {out[k].shape[1]}, expected {seq_len}"
            )
    return out


def _linear(init: float, end: float, steps: int) -> Callable[[int], float]:
    """optax.linear_schedule: init -> end over ``steps`` updates, then end."""
    def f(count: int) -> float:
        if steps <= 0:
            return init
        frac = 1.0 - min(max(count, 0), steps) / steps
        return (init - end) * frac + end
    return f


def _make_schedule(args: TrainingArguments, total_steps: int) -> Callable[[int], float]:
    """The learning rate at 0-based update count, as _make_optimizer's optax
    schedule gives it: linear warmup from 0, then constant, linear or cosine
    decay to 0 over the remaining updates."""
    lr = args.learning_rate
    decay_steps = max(1, total_steps - args.warmup_steps)
    if args.lr_scheduler_type == "linear":
        decay = _linear(lr, 0.0, decay_steps)
    elif args.lr_scheduler_type == "cosine":
        def decay(count: int) -> float:
            return lr * 0.5 * (1 + math.cos(math.pi * min(count, decay_steps) / decay_steps))
    else:
        def decay(count: int) -> float:
            return lr
    if args.warmup_steps <= 0:
        return decay
    warmup = _linear(0.0, lr, args.warmup_steps)
    return lambda count: (warmup(count) if count < args.warmup_steps
                          else decay(count - args.warmup_steps))


class _Optimizer:
    """AdamW with optax's global-norm clipping and a per-update schedule.
    ``step()`` applies one update from the parameters' ``.grad`` and clears
    them."""

    def __init__(self, params: Iterable[torch.nn.Parameter], args: TrainingArguments,
                 total_steps: int):
        self.params = [p for p in params if p.requires_grad]
        self.schedule = _make_schedule(args, total_steps)
        self.max_grad_norm = args.max_grad_norm
        self.count = 0
        self.adamw = torch.optim.AdamW(self.params, lr=self.schedule(0), betas=(0.9, 0.999),
                                       eps=1e-8, weight_decay=args.weight_decay)

    @torch.no_grad()
    def step(self) -> None:
        grads = [p.grad for p in self.params if p.grad is not None]
        if self.max_grad_norm and grads:
            norm = torch.stack([g.float().square().sum() for g in grads]).sum().sqrt()
            # optax: g / norm * max_norm, only when norm >= max_norm (no eps);
            # decided on the device, so the step does not wait for the norm
            clip = norm >= self.max_grad_norm
            one = torch.ones_like(norm)
            div = torch.where(clip, norm, one)
            mul = torch.where(clip, torch.full_like(norm, self.max_grad_norm), one)
            for g in grads:
                g.div_(div).mul_(mul)
        for group in self.adamw.param_groups:
            group["lr"] = self.schedule(self.count)
        self.adamw.step()
        self.adamw.zero_grad(set_to_none=True)
        self.count += 1


def _make_optimizer(args: TrainingArguments, total_steps: int,
                    params: Iterable[torch.nn.Parameter]) -> _Optimizer:
    if args.optimizer == "adafactor":
        raise NotImplementedError(
            "optimizer='adafactor' is ported with T5 training (ROADMAP Queue 1 item 3)")
    return _Optimizer(params, args, total_steps)
