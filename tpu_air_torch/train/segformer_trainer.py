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
CPU; on one card, ``num_workers=1``.  A worker over several devices
(``num_chips_per_worker``, or the ``model_parallel`` and
``sequence_parallel`` degrees, which the JAX loop reads as devices only)
runs a data replica on each in one controller, the batch norm's moments
summed over them too.

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


class _Replicas:
    """A worker's in-process data replicas of ``model``, one a device of
    ``devices``: a replica on the first device's device runs the model
    itself, another a copy of its own whose parameters are the model's,
    copied onto its device at every call (differentiable, so its gradients
    reach the model's).  :meth:`sums` runs every replica over its block of
    the rows together (``run_local_replicas``), so that the batch norm's
    moments are those of every replica's rows."""

    def __init__(self, model, devices):
        import copy

        self.model = model
        self.devices = list(devices)
        home = self.devices[0]
        self.modules = [model if d == home else copy.deepcopy(model).to(d)
                        for d in self.devices]

    def _call(self, r: int, *args):
        module = self.modules[r]
        if module is self.model:
            return module(*args)
        params = {n: p.to(self.devices[r]) for n, p in self.model.named_parameters()}
        return torch.func.functional_call(module, params, args)

    def train(self, mode: bool = True) -> None:
        for m in {id(m): m for m in self.modules}.values():
            m.train(mode)

    def sums(self, pixel_values, labels, generators, ignore_index: int):
        """(summed NLL, valid pixels) over the rows, on the first device."""
        from tpu_air_torch.models.segformer.modeling import segmentation_nll
        from tpu_air_torch.parallel.distributed import run_local_replicas

        n = len(self.devices)
        px, lb = pixel_values.chunk(n), labels.chunk(n)

        def replica(r):
            dev = self.devices[r]
            gen = None if generators is None else generators[r]
            return lambda: segmentation_nll(self._call(r, px[r].to(dev), gen), lb[r].to(dev),
                                            ignore_index)

        outs = run_local_replicas([replica(r) for r in range(n)])
        home = self.devices[0]
        return (torch.stack([t.to(home) for t, _ in outs]).sum(0),
                torch.stack([c.to(home) for _, c in outs]).sum(0))


def make_segformer_train_step(model, optimizer, generator=None,
                              ignore_index: int = 255, replicas: Optional[_Replicas] = None):
    """``step(pixel_values, labels) -> loss`` (a detached device scalar,
    the global batch's mean NLL over its valid pixels): this worker's sum
    over the count of all workers, its gradient summed over them, one
    ``optimizer.step()``.  The model is in ``train()`` mode, so its batch
    norm takes the global batch's moments.  With ``replicas`` (a worker's
    :class:`_Replicas`) the rows are split over them, ``generator`` then one
    a replica."""
    from tpu_air_torch.models.segformer.modeling import segmentation_nll
    from tpu_air_torch.parallel.distributed import all_reduce_grads, all_reduce_sum

    params = optimizer.params

    def step(pixel_values: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        if replicas is None:
            total, count = segmentation_nll(model(pixel_values, generator), labels,
                                            ignore_index)
        else:
            total, count = replicas.sums(pixel_values, labels, generator, ignore_index)
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
    from tpu_air_torch.models.segformer.modeling import SegformerForSemanticSegmentation
    from tpu_air_torch.parallel.distributed import all_reduce_sum
    from tpu_air_torch.parallel.mesh import worker_devices

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
    # SegFormer has no model or sequence axis: as the JAX package's loop, it
    # reads neither degree and trains data-parallel over every device the
    # config gives it (num_workers x num_chips_per_worker): a replica on
    # each device of this worker
    workers, rank = session.get_world_size(), session.get_world_rank()
    device = resolve_device(config.get("_device"))
    devices = worker_devices(rank, getattr(sc, "num_chips_per_worker", 1), device)
    if not devices:
        raise ValueError("SegformerTrainer: this worker has none of the visible devices")
    dpl = len(devices)
    dp = dpl * workers
    device = devices[0]
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
    # the JAX loop's PRNGKey(seed + 1); each replica draws the masks of its rows
    generators = [torch.Generator(device=d) for d in devices]
    for r, g in enumerate(generators):
        g.manual_seed(args.seed + 1 + rank * dpl + r)
    replicas = _Replicas(model, devices)
    train_step = make_segformer_train_step(model, opt, generators, ignore, replicas)

    rows = per_device * dpl
    mine = slice(rank * rows, (rank + 1) * rows)
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
            replicas.train(False)
            with torch.no_grad():
                for batch_df in eval_ds.iter_batches(batch_size=global_bs,
                                                     batch_format="pandas", drop_last=True):
                    b = _to_device(_collate_images(batch_df), mine, device)
                    total, count = replicas.sums(b["pixel_values"], b["labels"], None, ignore)
                    sums = all_reduce_sum(torch.stack([total, count.float()]))
                    parts.append(sums[0] / torch.clamp(sums[1], min=1.0))
            replicas.train()
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
