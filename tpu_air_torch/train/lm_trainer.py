"""LMTrainer — long-context causal-LM training through the Trainer API (the
port's counterpart of ``tpu_air/train/lm_trainer.py``).

``LMTrainer(...).fit()`` runs :func:`lm_train_loop`, the step of
``parallel/sequence_parallel.py`` (flash attention, or ring attention over
the sequence group, forward and backward through the port's kernels on a
CUDA device; the chunked lm-head CE), AdamW or Adafactor as
``_make_optimizer`` builds them (Adafactor reads the JAX package's
parameter layouts, ``models/lm/convert.py::jax_layouts``), and a per-epoch
report with a checkpoint.

Sequence parallelism is a config change: ``ScalingConfig(num_workers=dp,
sequence_parallel=sp)`` runs ``dp x sp`` ranks, one device each (gloo on
the CPU, nccl with rank r on ``cuda:r``), the JAX package's ``(data,
sequence)`` mesh over ``num_workers x num_chips_per_worker`` devices.  Each
rank reads the whole global batch and keeps its block (its data row's
rows, its sequence column's tokens); the loss and the eval sums are
all-reduced over every rank, and rank 0 writes the checkpoint.  A worker
given more devices than its sequence axis (``num_chips_per_worker``) runs one
rank a device all the same: the extra devices are more data rows.

Tensor parallelism is a config change too: ``ScalingConfig(num_workers=dp,
model_parallel=tp)`` runs :func:`_lm_tp_loop`, the JAX package's
``_lm_tp_loop``.  Each of ``num_workers`` ranks is one controller over its
``num_chips_per_worker`` devices, a ``(data, model)`` mesh
(``parallel/mesh.py::worker_mesh``): the model is split over the ``model``
axis by ``lm_param_spec`` (``parallel/sharding.py::shard_module``:
attention per shard at h/tp heads through the flash forward and backward
kernels, the SwiGLU at d_ff/tp columns, embeddings and norms whole), the
extra devices are in-worker data replicas, and the ranks sum their
gradients shard by shard.  The optimizer acts on the logical parameters
and the checkpoint holds them whole, so it loads at any tp.

Datasets: rows with an ``input_ids`` column (fixed-length token lists).
Targets are the global next-token shift, computed on the host before the
sequence is split.
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
    from tpu_air_torch.models.lm.convert import jax_layouts
    from tpu_air_torch.parallel.distributed import all_reduce_sum
    from tpu_air_torch.parallel.sequence_parallel import (make_sp_mesh, make_sp_train_step,
                                                          shard_batch, sp_local_loss)

    from . import session

    args: TrainingArguments = config.get("training_args") or TrainingArguments()
    for k in ("learning_rate", "num_train_epochs", "weight_decay"):
        if k in config:
            setattr(args, k, config[k])

    model_config: LMConfig = config["model_config"]
    sc = config.get("_scaling_config")
    sp = getattr(sc, "sequence_parallel", None) or 1
    mp = getattr(sc, "model_parallel", None) or 1
    if mp > 1 and sp > 1:
        raise ValueError(
            "LMTrainer: model_parallel and sequence_parallel cannot be "
            "combined yet — pick one axis per run (the SP step runs inside "
            "shard_map; TP rides pjit shardings)"
        )
    if mp > 1:
        _lm_tp_loop(config, args, model_config, mp)
        return
    device = resolve_device(config.get("_device"))
    pad = model_config.pad_token_id

    train_ds = session.get_dataset_shard("train")
    if train_ds is None:
        raise ValueError("LMTrainer requires a 'train' dataset")
    eval_ds = session.get_dataset_shard("evaluation") or session.get_dataset_shard("eval")
    for ds in (train_ds, eval_ds):
        sample = None if ds is None else next(ds.iter_batches(batch_size=1), None)
        length = 0 if sample is None else collate(sample, ["input_ids"])["input_ids"].shape[1]
        if length % sp:
            # the JAX package's text, raised there by device_put
            raise ValueError(
                f"LMTrainer: sequence_parallel={sp} implies that the global size of "
                f"dimension 1 should be divisible by {sp}, but it is equal to {length} "
                f"(full shape: {(len(sample), length)})")
    mesh = make_sp_mesh(sp=sp)
    dp = mesh.dp
    rank = session.get_world_rank()

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
    layouts = jax_layouts(model_config)
    opt = _make_optimizer(args, steps_per_epoch * args.num_train_epochs,
                          [p for _, p in model.named_parameters()],
                          [layouts[n] for n, _ in model.named_parameters()])
    step = make_sp_train_step(model, opt, mesh)

    def batches(ds, bs, drop_last=True):
        """This rank's block of each global batch, on its device."""
        for ids, tgt in _global_batches(ds, bs, pad, drop_last):
            ids, tgt = shard_batch(mesh, ids, tgt)
            yield (torch.from_numpy(np.ascontiguousarray(ids)).to(device, torch.long),
                   torch.from_numpy(np.ascontiguousarray(tgt)).to(device, torch.long),
                   len(ids) * ids.shape[1] * dp * sp)

    for epoch in range(int(args.num_train_epochs)):
        t0 = time.time()
        losses, tokens, nsteps = [], 0, 0
        for ids, tgt, n_tokens in batches(train_ds, global_bs):
            losses.append(step(ids, tgt))  # device scalar; host sync deferred to epoch end
            tokens += n_tokens
            nsteps += 1
            if args.max_steps_per_epoch and nsteps >= args.max_steps_per_epoch:
                break
        # one host sync, which also waits for the epoch's device work
        # airlint: disable=PT004 — epoch cadence, not the step path
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
            # the train step's local loss, summed over every rank per batch;
            # one host sync after the loop
            with torch.no_grad():
                parts = [all_reduce_sum(torch.stack(sp_local_loss(model, ids, tgt, mesh)))
                         for ids, tgt, _ in batches(eval_ds, ebs, drop_last=False)]
            if parts:
                # airlint: disable=PT004 — epoch cadence, not the step path
                tot, cnt = torch.stack(parts).double().sum(0).tolist()
                if cnt:
                    metrics["eval_loss"] = tot / cnt
        ckpt = None
        if args.save_strategy == "epoch" and rank == 0:
            ckpt = Checkpoint.from_model(model_config=model_config,
                                         params=model.state_dict(), metrics=metrics)
        session.report(metrics, checkpoint=ckpt)


def _global_batches(ds, bs: int, pad: int, drop_last: bool = True):
    """``(input_ids, targets)`` of each global batch of ``bs`` rows, as
    int32 numpy arrays: the next-token shift taken on the host before any
    split (``shift_targets`` semantics), and a partial last batch topped up
    with all-pad rows, whose targets are all masked, so they add (0, 0) to
    the sums."""
    for df in ds.iter_batches(batch_size=bs, batch_format="pandas", drop_last=drop_last):
        ids = collate(df, ["input_ids"])["input_ids"]
        tgt = np.concatenate([ids[:, 1:], np.full((ids.shape[0], 1), pad, ids.dtype)], axis=1)
        if len(ids) % bs:
            need = bs - len(ids) % bs
            ids = np.concatenate([ids, np.full((need, ids.shape[1]), pad, ids.dtype)])
            tgt = np.concatenate([tgt, np.full((need, tgt.shape[1]), pad, tgt.dtype)])
        yield ids, tgt


def lm_tp_local_sums(model, mesh, input_ids: torch.Tensor, targets: torch.Tensor):
    """(sum, count) of the chunked lm-head CE over a worker's rows, on its
    ``(data, model)`` mesh: each data replica its block, the sums added in
    replica order on the first device."""
    from tpu_air_torch.models.lm import head_weight, lm_chunked_loss_with_targets
    from tpu_air_torch.parallel.mesh import batch_sharding
    from tpu_air_torch.parallel.tensor_parallel import call_replica

    pad = model.config.pad_token_id

    def replica_sums(m, ids, tgt):
        return lm_chunked_loss_with_targets(m(ids, return_hidden=True), head_weight(m), tgt, pad)

    home = mesh.devices[0, 0]
    parts = [torch.stack(call_replica(model, mesh, r, replica_sums, i, t)).to(home)
             for r, (i, t) in enumerate(zip(batch_sharding(input_ids, mesh),
                                            batch_sharding(targets, mesh)))]
    s, c = torch.stack(parts).sum(0)
    return s, c


def make_lm_tp_train_step(model, optimizer, mesh):
    """``step(input_ids, targets) -> loss`` of a worker over its ``(data,
    model)`` mesh (a model split by ``shard_module``): the worker's sum
    over the count of every rank, its gradient summed shard by shard over
    the ranks, one ``optimizer.step()``; the loss a detached device scalar,
    the global batch's mean CE."""
    from tpu_air_torch.parallel.distributed import all_reduce_grads, all_reduce_sum

    def step(input_ids, targets):
        s, c = lm_tp_local_sums(model, mesh, input_ids, targets)
        # the count is independent of the parameters: grad(S / C) = grad(S) / C
        n = torch.clamp(all_reduce_sum(c.detach().clone()), min=1.0)
        loss = s / n
        loss.backward()
        all_reduce_grads(optimizer.params)
        optimizer.step()
        return all_reduce_sum(loss.detach())

    return step


def _lm_tp_loop(config: Dict[str, Any], args: TrainingArguments, model_config,
                mp: int) -> None:
    """Tensor-parallel LM training (``ScalingConfig(model_parallel=N)``), the
    JAX package's ``_lm_tp_loop``: this rank's ``(data, model)`` mesh over
    its worker's devices, the model split over ``model``, the global
    batch's rows over the ranks and their in-worker replicas, the global
    mean of the chunked CE, and its metrics (``mesh_model``,
    ``mesh_sequence`` 1, ``params_bytes_*``), eval and checkpoint of the
    logical parameters."""
    from tpu_air_torch.device import resolve_device
    from tpu_air_torch.models.lm import CausalLM
    from tpu_air_torch.models.lm.convert import jax_layouts, tp_split_dims
    from tpu_air_torch.parallel.distributed import all_reduce_sum
    from tpu_air_torch.parallel.mesh import worker_devices, worker_mesh
    from tpu_air_torch.parallel.sharding import logical_parameters, params_bytes, shard_module

    from . import session

    sc = config["_scaling_config"]
    rank, workers = session.get_world_rank(), session.get_world_size()
    device = resolve_device(config.get("_device"))
    mesh = worker_mesh(worker_devices(rank, sc.num_chips_per_worker, device), mp)
    dpl = mesh.shape["data"]
    dp = dpl * workers
    home = mesh.devices[0, 0]
    pad = model_config.pad_token_id

    train_ds = session.get_dataset_shard("train")
    if train_ds is None:
        raise ValueError("LMTrainer requires a 'train' dataset")
    eval_ds = session.get_dataset_shard("evaluation") or session.get_dataset_shard("eval")

    global_bs = args.per_device_train_batch_size * dp
    steps_per_epoch = max(1, train_ds.count() // global_bs)
    if args.max_steps_per_epoch:
        steps_per_epoch = min(steps_per_epoch, args.max_steps_per_epoch)

    model = CausalLM(model_config, device=home)
    resume_dir = config.get("resume_from_checkpoint")
    if resume_dir:
        model.load_state_dict(Checkpoint.from_directory(resume_dir).get_params())
    else:
        model.init_weights(args.seed)
    shard_module(model, list(mesh.devices[0]), tp_split_dims(model_config, mp))
    layouts = jax_layouts(model_config)
    logical = logical_parameters(model)
    opt = _make_optimizer(args, steps_per_epoch * args.num_train_epochs,
                          [(shards, dim) for _, shards, dim in logical],
                          [layouts[name] for name, _, _ in logical])
    params_bytes_total, params_bytes_per_device = params_bytes(model)

    step = make_lm_tp_train_step(model, opt, mesh)

    def mine(ids, tgt):
        """This rank's rows of a global batch, as tensors."""
        rows = len(ids) // workers
        return tuple(torch.from_numpy(np.ascontiguousarray(x[rank * rows:(rank + 1) * rows]))
                     .long() for x in (ids, tgt))

    for epoch in range(int(args.num_train_epochs)):
        t0 = time.time()
        losses, tokens, nsteps = [], 0, 0
        for ids, tgt in _global_batches(train_ds, global_bs, pad):
            losses.append(step(*mine(ids, tgt)))
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
            "train_tokens_per_sec_per_chip": tokens / dt / (dp * mp) if dt > 0 else 0.0,
            "mesh_data": dp,
            "mesh_model": mp,
            "mesh_sequence": 1,
            "params_bytes_total": params_bytes_total,
            "params_bytes_per_device": params_bytes_per_device,
        }
        if eval_ds is not None and args.evaluation_strategy == "epoch":
            ebs = args.per_device_eval_batch_size * dp
            with torch.no_grad():
                parts = [all_reduce_sum(torch.stack(lm_tp_local_sums(model, mesh,
                                                                     *mine(ids, tgt))))
                         for ids, tgt in _global_batches(eval_ds, ebs, pad, drop_last=False)]
            if parts:
                tot, cnt = torch.stack(parts).double().sum(0).tolist()   # one host sync
                if cnt:
                    metrics["eval_loss"] = tot / cnt
        ckpt = None
        if args.save_strategy == "epoch" and rank == 0:
            ckpt = Checkpoint.from_model(model_config=model_config, params=model,
                                         preprocessor=config.get("_preprocessor"),
                                         metrics=metrics)
        session.report(metrics, checkpoint=ckpt)


class LMTrainer(BaseTrainer):
    """Long-context causal-LM trainer: ``device`` (``cuda:0`` by default)
    for one rank; ``ScalingConfig(num_workers=dp, sequence_parallel=sp)``
    runs ``dp x sp`` ranks, rank r on ``cuda:r`` (or each on the CPU);
    ``ScalingConfig(num_workers=dp, model_parallel=tp)`` runs ``dp`` ranks,
    each over its worker's ``num_chips_per_worker`` devices."""

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

    def _num_ranks(self) -> int:
        """One rank a worker with tensor parallelism, else one rank a device
        of the ``(data, sequence)`` grid."""
        sc = self.scaling_config
        if sc.model_parallel > 1:
            return sc.num_workers
        return sc.num_workers * sc.num_chips_per_worker

    def _devices_per_rank(self) -> int:
        sc = self.scaling_config
        return sc.num_chips_per_worker if sc.model_parallel > 1 else 1

    def _train_loop_config(self) -> Dict[str, Any]:
        return {
            "model_config": self.model_config,
            "training_args": self.training_args,
            **self.trainer_init_config,
        }
