"""LMTrainer — long-context causal-LM training through the Trainer API (the
port's counterpart of ``tpu_air/train/lm_trainer.py``, its one-card path).

``LMTrainer(...).fit()`` runs :func:`lm_train_loop`: the
``sequence_parallel == 1`` step of ``parallel/sequence_parallel.py``
(causal flash attention, forward and backward through the port's kernels on
a CUDA device; the chunked lm-head CE), AdamW as ``_make_optimizer`` builds
it, and a per-epoch report with a checkpoint.  A sequence split over several
cards (ROADMAP Queue 1 item 8), tensor parallelism (item 9) and data
parallelism over several cards (item 3) raise.

Datasets: rows with an ``input_ids`` column (fixed-length token lists).
Targets are the global next-token shift, computed on the host.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from .checkpoint import Checkpoint
from .t5_trainer import TrainingArguments, _make_optimizer, collate
from .trainer import BaseTrainer


def lm_train_loop(config: Dict[str, Any]) -> None:
    from tpu_air_torch.device import resolve_device
    from tpu_air_torch.models.lm import CausalLM, LMConfig
    from tpu_air_torch.parallel.sequence_parallel import make_sp_train_step, sp_local_loss

    from . import session

    args: TrainingArguments = config.get("training_args") or TrainingArguments()
    for k in ("learning_rate", "num_train_epochs", "weight_decay"):
        if k in config:
            setattr(args, k, config[k])

    model_config: LMConfig = config["model_config"]
    sc = config.get("_scaling_config")
    sp = getattr(sc, "sequence_parallel", None) or 1
    mp = getattr(sc, "model_parallel", None) or 1
    dp = getattr(sc, "num_workers", None) or 1
    if mp > 1:
        raise NotImplementedError(
            f"LMTrainer: model_parallel={mp}: tensor parallelism is not ported yet "
            "(ROADMAP Queue 1 item 9)")
    if dp > 1:
        raise NotImplementedError(
            f"LMTrainer: num_workers={dp}: data parallelism over several cards is "
            "not ported yet (ROADMAP Queue 1 item 3)")
    device = resolve_device(config.get("_device"))
    pad = model_config.pad_token_id

    train_ds = session.get_dataset_shard("train")
    if train_ds is None:
        raise ValueError("LMTrainer requires a 'train' dataset")
    eval_ds = session.get_dataset_shard("evaluation") or session.get_dataset_shard("eval")

    global_bs = args.per_device_train_batch_size * dp
    steps_per_epoch = max(1, train_ds.count() // global_bs)
    if args.max_steps_per_epoch:
        steps_per_epoch = min(steps_per_epoch, args.max_steps_per_epoch)

    model = CausalLM(model_config, device=device)
    resume_dir = config.get("resume_from_checkpoint")
    if resume_dir:
        model.load_state_dict(Checkpoint.from_directory(resume_dir).get_params())
    else:
        model.init_weights(args.seed)
    opt = _make_optimizer(args, steps_per_epoch * args.num_train_epochs, model.parameters())
    step = make_sp_train_step(model, opt, sp=sp)

    def batches(ds, bs, drop_last=True):
        for df in ds.iter_batches(batch_size=bs, batch_format="pandas",
                                  drop_last=drop_last):
            ids = collate(df, ["input_ids"])["input_ids"]
            # global next-token shift on the host (shift_targets semantics)
            tgt = np.concatenate(
                [ids[:, 1:], np.full((ids.shape[0], 1), pad, ids.dtype)], axis=1
            )
            if len(ids) % bs:
                # partial eval batch: pad with all-pad rows — their targets
                # are fully masked, so they contribute (0, 0) to the sums
                need = bs - len(ids) % bs
                ids = np.concatenate([ids, np.full((need, ids.shape[1]), pad, ids.dtype)])
                tgt = np.concatenate([tgt, np.full((need, tgt.shape[1]), pad, tgt.dtype)])
            yield (torch.from_numpy(ids).to(device, torch.long),
                   torch.from_numpy(tgt).to(device, torch.long))

    for epoch in range(int(args.num_train_epochs)):
        t0 = time.time()
        losses, tokens, nsteps = [], 0, 0
        for ids, tgt in batches(train_ds, global_bs):
            losses.append(step(ids, tgt))  # device scalar; host sync deferred to epoch end
            tokens += ids.shape[0] * ids.shape[1]
            nsteps += 1
            if args.max_steps_per_epoch and nsteps >= args.max_steps_per_epoch:
                break
        # one host sync, which also waits for the epoch's device work
        loss_values = torch.stack(losses).cpu().numpy() if losses else None
        dt = time.time() - t0
        metrics: Dict[str, Any] = {
            "epoch": epoch + 1,
            "loss": float(np.mean(loss_values)) if losses else float("nan"),
            "steps": nsteps,
            "train_tokens_per_sec": tokens / dt if dt > 0 else 0.0,
            "train_tokens_per_sec_per_chip": tokens / dt / (dp * sp) if dt > 0 else 0.0,
            "mesh_data": dp,
            "mesh_sequence": sp,
        }
        if eval_ds is not None and args.evaluation_strategy == "epoch":
            ebs = args.per_device_eval_batch_size * dp
            with torch.no_grad():
                parts = [sp_local_loss(model, ids, tgt)
                         for ids, tgt in batches(eval_ds, ebs, drop_last=False)]
            tot = sum(float(s) for s, _ in parts)
            cnt = sum(int(c) for _, c in parts)
            if cnt:
                metrics["eval_loss"] = tot / cnt
        ckpt = None
        if args.save_strategy == "epoch":
            ckpt = Checkpoint.from_model(model_config=model_config,
                                         params=model.state_dict(), metrics=metrics)
        session.report(metrics, checkpoint=ckpt)


class LMTrainer(BaseTrainer):
    """Long-context causal-LM trainer on one card (``device``, ``cuda:0`` by
    default)."""

    _name_prefix = "LMTrainer"

    def __init__(
        self,
        *,
        model_config,
        training_args: Optional[TrainingArguments] = None,
        trainer_init_config: Optional[Dict[str, Any]] = None,
        **kwargs,
    ):
        super().__init__(**kwargs)
        self.model_config = model_config
        self.training_args = training_args or TrainingArguments()
        self.trainer_init_config = trainer_init_config or {}

    def _training_fn(self):
        return lm_train_loop

    def _train_loop_config(self) -> Dict[str, Any]:
        return {
            "model_config": self.model_config,
            "training_args": self.training_args,
            **self.trainer_init_config,
        }
