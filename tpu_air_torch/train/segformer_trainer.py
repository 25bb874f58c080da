"""SegformerTrainer — semantic-segmentation fine-tuning (W6,
Scaling_model_training.ipynb), the port's counterpart of
``tpu_air/train/segformer_trainer.py``.

``SegformerTrainer(...).fit()`` runs :func:`segformer_train_loop` in each
worker: the reference's AdamW (lr 1e-4, weight decay 0 by default; the
port's ``_make_optimizer``, with optax's global-norm clipping) over
``SegformerForSemanticSegmentation``, dropout and drop-path masks from a
seeded ``torch.Generator``, a per-epoch eval and a checkpoint in the JAX
package's layout (``params.msgpack``, the batch-norm stats and the feature
extractor in ``extras.pkl``), which either package loads.

With ``ScalingConfig(num_workers=N)`` each of N worker processes takes its
contiguous rows of every global batch, as the JAX package's ``P("data")``
sharding hands them to device r.  The JAX step is one SPMD program over the
global batch, so the port reproduces its two reductions: the loss is each
worker's summed NLL over the global count of valid pixels, its gradients
summed over the workers (``parallel/distributed.py``), and the decode
head's batch norm takes the moments of the global batch
(``cross_replica_sum``), forward and backward.  The reference's W6 is
``ScalingConfig(num_workers=2, use_gpu=False)``: two gloo workers on the
CPU; on one card, ``num_workers=1``.

Expected dataset columns (produced by the image-processor BatchMapper, the
``images_preprocessor`` analog, cc-38,42): ``pixel_values`` (HWC float) and
``labels`` (HW int, 255 = ignore).
"""

from __future__ import annotations

import time
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from .checkpoint import Checkpoint
from .t5_trainer import TrainingArguments, _make_optimizer
from .trainer import BaseTrainer


def _collate_images(batch_df) -> Dict[str, np.ndarray]:
    from tpu_air_torch.models.segformer.image_processor import collate_pixel_batch

    out = {"pixel_values": collate_pixel_batch(batch_df["pixel_values"])}
    if "labels" in batch_df.columns:
        out["labels"] = np.stack(
            [np.asarray(v, dtype=np.int32) for v in batch_df["labels"]]
        )
    return out


def _to_device(batch: Dict[str, np.ndarray], rows: slice, device) -> Dict[str, torch.Tensor]:
    """This worker's rows on its device, from pinned memory on CUDA."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v[rows]))
        if device.type == "cuda":
            t = t.pin_memory()
        out[k] = t.to(device, non_blocking=True)
    return out


def _load_variables(model, pretrained, config) -> None:
    """``pretrained_variables``: the port's state dict, or the JAX
    package's ``{"params": ..., "batch_stats": ...}`` Flax trees."""
    if isinstance(pretrained, Mapping) and "params" in pretrained:
        from tpu_air_torch.models.segformer.convert import params_from_jax

        pretrained = params_from_jax(pretrained["params"], pretrained.get("batch_stats"), config)
    model.load_state_dict(pretrained)


def make_segformer_train_step(model, optimizer, generator: Optional[torch.Generator] = None,
                              ignore_index: int = 255):
    """``step(pixel_values, labels) -> loss`` (a detached device scalar,
    the global batch's mean NLL over its valid pixels): this worker's sum
    over the count of all workers, its gradient summed over them, one
    ``optimizer.step()``.  The model is in ``train()`` mode, so its batch
    norm takes the global batch's moments."""
    from tpu_air_torch.models.segformer.modeling import segmentation_nll
    from tpu_air_torch.parallel.distributed import all_reduce_grads, all_reduce_sum

    params = optimizer.params

    def step(pixel_values: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        total, count = segmentation_nll(model(pixel_values, generator), labels, ignore_index)
        n = all_reduce_sum(count.float())
        loss = total / torch.clamp(n, min=1.0)
        loss.backward()
        all_reduce_grads(params)
        optimizer.step()
        return all_reduce_sum(loss.detach())

    return step


def segformer_train_loop(config: Dict[str, Any]) -> None:
    """The training function of each worker (``config`` as
    ``SegformerTrainer._train_loop_config`` builds it).  Uses the session
    API for data, rank and reports."""
    from tpu_air_torch.device import resolve_device
    from tpu_air_torch.models.segformer import SegformerConfig
    from tpu_air_torch.models.segformer.modeling import (SegformerForSemanticSegmentation,
                                                         segmentation_nll)
    from tpu_air_torch.parallel.distributed import all_reduce_sum

    from . import session

    args: TrainingArguments = config.get("training_args") or TrainingArguments(
        learning_rate=1e-4, weight_decay=0.0)
    # Tune-style overrides arrive as plain keys of the config
    for k in ("learning_rate", "num_train_epochs", "weight_decay"):
        if k in config:
            setattr(args, k, config[k])
    if "epochs" in config:
        args.num_train_epochs = config["epochs"]

    model_config: SegformerConfig = config["model_config"]
    preprocessor = config.get("_preprocessor")
    feature_extractor = config.get("feature_extractor")
    sc = config.get("_scaling_config")
    # SegFormer has no sequence axis: the JAX package's loop reads neither
    # degree and trains data-parallel over every device the config leases
    # (num_workers x num_chips_per_worker); the port runs one device a worker
    for what in ("model_parallel", "sequence_parallel"):
        degree = getattr(sc, what, None) or 1
        if degree > 1:
            raise NotImplementedError(
                f"SegformerTrainer: {what}={degree}: the port trains SegFormer data-parallel "
                "over num_workers, one device a worker; a worker over several devices "
                "needs the device mesh (ROADMAP Queue 1 item 9b)")
    dp, rank = session.get_world_size(), session.get_world_rank()
    device = resolve_device(config.get("_device"))
    ignore = model_config.semantic_loss_ignore_index

    train_ds = session.get_dataset_shard("train")
    eval_ds = session.get_dataset_shard("evaluation")
    if eval_ds is None:
        eval_ds = session.get_dataset_shard("eval")
    if train_ds is None:
        raise ValueError("SegformerTrainer requires a 'train' dataset")
    per_device = args.per_device_train_batch_size
    global_bs = per_device * dp

    model = SegformerForSemanticSegmentation(model_config, device=device)
    resume_dir = config.get("resume_from_checkpoint")
    pretrained = config.get("pretrained_variables")
    if resume_dir:
        model.load_state_dict(Checkpoint.from_directory(resume_dir).get_params())
    elif pretrained is not None:
        _load_variables(model, pretrained, model_config)
    else:
        model.init_weights(args.seed)     # numpy-seeded: Flax's init is not reproducible here
    model.train()

    steps_per_epoch = max(1, train_ds.count() // global_bs)
    if args.max_steps_per_epoch:
        steps_per_epoch = min(steps_per_epoch, args.max_steps_per_epoch)
    opt = _make_optimizer(args, steps_per_epoch * args.num_train_epochs, model.parameters())
    # the JAX loop's PRNGKey(seed + 1); each rank draws the masks of its rows
    generator = torch.Generator(device=device)
    generator.manual_seed(args.seed + 1 + rank)
    train_step = make_segformer_train_step(model, opt, generator, ignore)

    mine = slice(rank * per_device, (rank + 1) * per_device)
    for epoch in range(int(args.num_train_epochs)):
        t0 = time.time()
        losses, nsteps, nimg = [], 0, 0
        for batch_df in train_ds.iter_batches(batch_size=global_bs, batch_format="pandas",
                                              drop_last=True):
            b = _to_device(_collate_images(batch_df), mine, device)
            losses.append(train_step(b["pixel_values"], b["labels"]))  # no host sync per step
            nsteps += 1
            nimg += global_bs
            if args.max_steps_per_epoch and nsteps >= args.max_steps_per_epoch:
                break
        # one host sync, which also waits for the epoch's device work
        train_loss = float(torch.stack(losses).mean()) if losses else float("nan")
        dt = time.time() - t0
        metrics: Dict[str, Any] = {
            "epoch": epoch + 1,
            "loss": train_loss,
            "steps": nsteps,
            "train_images_per_sec": nimg / dt if dt > 0 else 0.0,
        }

        if eval_ds is not None and args.evaluation_strategy == "epoch":
            # the JAX eval step: each global batch's mean over its valid
            # pixels, averaged over the batches
            parts = []
            model.eval()
            with torch.no_grad():
                for batch_df in eval_ds.iter_batches(batch_size=global_bs,
                                                     batch_format="pandas", drop_last=True):
                    b = _to_device(_collate_images(batch_df), mine, device)
                    total, count = segmentation_nll(model(b["pixel_values"]), b["labels"], ignore)
                    sums = all_reduce_sum(torch.stack([total, count.float()]))
                    parts.append(sums[0] / torch.clamp(sums[1], min=1.0))
            model.train()
            if parts:
                metrics["eval_loss"] = float(torch.stack(parts).mean())

        ckpt = None
        if args.save_strategy == "epoch" and rank == 0:
            ckpt = Checkpoint.from_model(
                model_config=model_config, params=model.state_dict(), preprocessor=preprocessor,
                metrics=metrics, format="jax",
                extras={"feature_extractor": feature_extractor} if feature_extractor else None)
        session.report(metrics, checkpoint=ckpt)


class SegformerTrainer(BaseTrainer):
    """Drop-in for the reference's HuggingFaceTrainer-on-SegFormer config
    (Scaling_model_training.ipynb:cc-51-52): ``model_config`` (MiT-b0 by
    default), ``training_args`` (AdamW at lr 1e-4, weight decay 0 by
    default), and optionally ``pretrained_variables`` (the port's state
    dict, or the JAX package's Flax variables) and the ``feature_extractor``
    the checkpoints carry for prediction."""

    _name_prefix = "SegformerTrainer"

    def __init__(
        self,
        *,
        model_config=None,
        training_args: Optional[TrainingArguments] = None,
        pretrained_variables=None,
        feature_extractor=None,
        trainer_init_config: Optional[Dict[str, Any]] = None,
        **kwargs,
    ):
        super().__init__(**kwargs)
        if model_config is None:
            from tpu_air_torch.models.segformer import SegformerConfig

            model_config = SegformerConfig.mit_b0()
        self.model_config = model_config
        self.training_args = training_args or TrainingArguments(
            learning_rate=1e-4, weight_decay=0.0
        )
        self.pretrained_variables = pretrained_variables
        self.feature_extractor = feature_extractor
        self.trainer_init_config = trainer_init_config or {}

    def _training_fn(self):
        return segformer_train_loop

    def _train_loop_config(self) -> Dict[str, Any]:
        cfg = dict(self.trainer_init_config)
        cfg["model_config"] = self.model_config
        cfg["training_args"] = self.training_args
        if self.pretrained_variables is not None:
            cfg["pretrained_variables"] = self.pretrained_variables
        if self.feature_extractor is not None:
            cfg["feature_extractor"] = self.feature_extractor
        return cfg
