"""T5Trainer — FLAN-T5 fine-tuning (W1), the port's counterpart of
``tpu_air/train/t5_trainer.py``.

``T5Trainer(...).fit()`` runs :func:`t5_train_loop` in each worker:
teacher-forced T5 with bf16 compute on f32 parameters, dropout masks from a
seeded ``torch.Generator``, the mean CE over the global batch's non-pad
labels, the optimizer below, a per-epoch eval and a checkpoint with the
tokenizer and preprocessor.  With ``ScalingConfig(num_workers=N)`` each of
N worker processes takes its contiguous rows of every global batch, as the
JAX package's ``P("data")`` sharding hands them to device r, and the loss
divides by the global token count (``parallel/distributed.py``).

Each worker runs one controller over its ``num_chips_per_worker`` devices,
the JAX loop's ``(data, model)`` mesh (``parallel/mesh.py::worker_mesh``):
``ScalingConfig(model_parallel=tp)`` (or ``TrainingArguments(
tensor_parallelism=tp)``) splits the model over ``model`` by
``t5_param_spec`` (heads, d_ff and the vocab of ``lm_head``;
``parallel/sharding.py::shard_module``), and the devices beyond tp are
in-worker data replicas, each its block of the worker's rows.  The loop
reports the JAX loop's ``mesh_data``, ``mesh_model`` and
``params_bytes_*``; the optimizer acts on the logical parameters and the
checkpoint holds them whole.

Across hosts (a lease larger than a host, ``trainer.py``'s multi-host
path) each host is one worker over its share of the lease: every host
builds the same logical parameters from the same seed, iterates the same
global batches, takes its own rows, and splits the model over its own
devices only; the data replicas' gradients meet over the hosts' group,
and ``mesh_num_hosts`` counts the hosts.

``_make_optimizer`` reproduces the JAX package's optax chain,
``clip_by_global_norm(max_grad_norm)`` then either ``adamw(schedule,
b1=0.9, b2=0.999, eps=1e-8, weight_decay)`` with the decay on every
parameter (``torch.optim.AdamW``) or ``adafactor(schedule)`` with optax's
defaults (written out here), the schedule evaluated at the 0-based update
count.  The LM loop borrows ``TrainingArguments``, ``collate`` and
``_make_optimizer``.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .checkpoint import Checkpoint
from .trainer import BaseTrainer


@dataclass
class TrainingArguments:
    """The fields of the JAX package's TrainingArguments that the port's
    loops read.  ``tensor_parallelism`` is the T5 loop's tensor-parallel
    degree when ``ScalingConfig.model_parallel`` is 1.  Its remat, logging
    and tqdm fields are left out: nothing reads them (the JAX loop reads
    none of the three either)."""

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
    tensor_parallelism: int = 1

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


class _Adafactor:
    """``optax.adafactor(learning_rate)`` with optax 0.2.6's defaults, the
    update rule of each parameter written out: a second moment factored
    into row and column means over the two largest dims when the smaller of
    them is at least ``MIN_DIM_TO_FACTOR``, else kept whole, decayed at
    1 - (t+1)^-0.8 with ``EPS`` added to the squared gradient; the update
    clipped to RMS 1, times the learning rate, times the parameter's RMS
    (at least 1e-3); no momentum, no weight decay.

    The factoring decision reads each parameter in the JAX package's
    layout (``layouts``: (transposed, shape) per parameter, None for the
    port's own): T5's q/k/v/o kernels are [d_model, h, d_kv] there, whose
    second-largest dim (d_kv) is under 128, so optax keeps their second
    moment whole.  A parameter split over the model axis (``(shards,
    dim)``) is updated as its logical tensor: its gradient and value are
    put back together on the first shard's device, and the update is
    split back to the shards."""

    MIN_DIM_TO_FACTOR = 128
    DECAY = 0.8
    EPS = 1e-30
    CLIP = 1.0
    MIN_SCALE = 1e-3

    def __init__(self, params: Sequence, layouts=None):
        self.groups = [_group(p) for p in params]
        self.layouts = list(layouts) if layouts is not None else [None] * len(self.groups)
        if len(self.layouts) != len(self.groups):
            raise ValueError(f"{len(self.layouts)} layouts for {len(self.groups)} parameters")
        self.state: List[Optional[Dict[str, torch.Tensor]]] = [None] * len(self.groups)
        self.count = 0

    @staticmethod
    def _factored_dims(shape) -> Optional[Tuple[int, int]]:
        """optax's ``_factored_dims``: the two largest axes, or None."""
        if len(shape) < 2:
            return None
        order = np.argsort(shape)
        if shape[order[-2]] < _Adafactor.MIN_DIM_TO_FACTOR:
            return None
        return int(order[-2]), int(order[-1])

    @staticmethod
    def _rms(x: torch.Tensor) -> torch.Tensor:
        return x.square().mean().sqrt()

    @torch.no_grad()
    def step(self, lr: float) -> None:
        # optax computes the decay in f32 from the 0-based count
        t = torch.tensor(self.count + 1, dtype=torch.float32)
        decay = float(1.0 - t ** -self.DECAY)
        for i, ((shards, dim), layout) in enumerate(zip(self.groups, self.layouts)):
            if shards[0].grad is None:
                continue
            # a split parameter's update is its logical one (factored
            # statistics, RMS clip and scale of the whole tensor), taken on
            # the first shard's device and split back
            home = shards[0].device
            p = _logical(shards, dim, home, lambda s: s.detach())
            g = _logical(shards, dim, home, lambda s: s.grad)
            u = self._update(i, p, g, layout, decay, lr)
            for s, part in zip(shards, [u] if dim is None else u.chunk(len(shards), dim)):
                s.sub_(part.to(s.device, s.dtype))
        self.count += 1

    def _update(self, i: int, p: torch.Tensor, grad: torch.Tensor, layout, decay: float,
                lr: float) -> torch.Tensor:
        """The update of parameter ``i`` (the port's layout) from its value
        and gradient."""
        transposed, shape = layout if layout is not None else (False, tuple(p.shape))

        def logical(x):
            return (x.t() if transposed else x).reshape(shape)

        g = logical(grad.float())
        g2 = g.square() + self.EPS
        dims = self._factored_dims(shape)
        st = self.state[i]
        if dims is not None:
            d1, d0 = dims
            if st is None:
                st = self.state[i] = {"v_row": torch.zeros_like(g2.mean(d0)),
                                      "v_col": torch.zeros_like(g2.mean(d1))}
            v_row = st["v_row"].mul_(decay).add_(g2.mean(d0), alpha=1.0 - decay)
            v_col = st["v_col"].mul_(decay).add_(g2.mean(d1), alpha=1.0 - decay)
            reduced_d1 = d1 - 1 if d1 > d0 else d1
            row_factor = (v_row / v_row.mean(reduced_d1, keepdim=True)).rsqrt()
            u = g * row_factor.unsqueeze(d0) * v_col.rsqrt().unsqueeze(d1)
        else:
            if st is None:
                st = self.state[i] = {"v": torch.zeros_like(g2)}
            v = st["v"].mul_(decay).add_(g2, alpha=1.0 - decay)
            u = g * v.rsqrt()
        u = u / torch.clamp(self._rms(u) / self.CLIP, min=1.0)
        u = u * lr
        scale = self._rms(p.float())
        u = u * torch.where(scale <= self.MIN_SCALE,
                            torch.full_like(scale, self.MIN_SCALE), scale)
        if transposed:
            u = u.reshape(p.shape[::-1]).t()
        return u.reshape(p.shape)


def _group(p) -> Tuple[List[torch.nn.Parameter], Optional[int]]:
    """A parameter as ``(shards, split dim)``: an ``nn.Parameter`` is one
    shard (dim None); a ``(shards, dim)`` pair of ``logical_parameters``
    is taken as it is."""
    if isinstance(p, torch.Tensor):
        return [p], None
    shards, dim = p
    return list(shards), dim


def _logical(shards, dim, home, get) -> torch.Tensor:
    """``get(shard)`` of every shard, put back together on ``home``."""
    if dim is None:
        return get(shards[0])
    return torch.cat([get(s).to(home) for s in shards], dim)


class _Optimizer:
    """AdamW or Adafactor with optax's global-norm clipping and a per-update
    schedule.  ``step()`` applies one update from the parameters' ``.grad``
    and clears them."""

    def __init__(self, params: Iterable, args: TrainingArguments,
                 total_steps: int, layouts=None):
        groups = [_group(p) for p in params]
        keep = [i for i, (shards, _) in enumerate(groups) if shards[0].requires_grad]
        self.groups = [groups[i] for i in keep]
        # every shard once: AdamW and the clip's global norm are elementwise
        self.params = [s for shards, _ in self.groups for s in shards]
        self.schedule = _make_schedule(args, total_steps)
        self.max_grad_norm = args.max_grad_norm
        self.count = 0
        self.adafactor = self.adamw = None
        if args.optimizer == "adafactor":
            self.adafactor = _Adafactor(
                self.groups, None if layouts is None else [layouts[i] for i in keep])
        elif args.optimizer == "adamw":
            self.adamw = torch.optim.AdamW(self.params, lr=self.schedule(0),
                                           betas=(0.9, 0.999), eps=1e-8,
                                           weight_decay=args.weight_decay)
        else:
            raise ValueError(f"optimizer must be 'adamw' or 'adafactor', not {args.optimizer!r}")

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
        lr = self.schedule(self.count)
        if self.adafactor is not None:
            self.adafactor.step(lr)
        else:
            for group in self.adamw.param_groups:
                group["lr"] = lr
            self.adamw.step()
        for p in self.params:
            p.grad = None
        self.count += 1


def _make_optimizer(args: TrainingArguments, total_steps: int,
                    params: Iterable, layouts=None) -> _Optimizer:
    """The optimizer of ``args`` over ``params``, each an ``nn.Parameter`` or
    a split parameter's ``(shards, dim)``; ``layouts`` (one per parameter,
    see :class:`_Adafactor`) matter to Adafactor only."""
    return _Optimizer(params, args, total_steps, layouts)


def _tensors(batch: Dict[str, np.ndarray], rows: slice, device) -> Dict[str, torch.Tensor]:
    """This worker's rows on its device.  A CUDA upload goes from pinned
    memory without blocking: from pageable memory torch waits for the
    stream, so every step would wait for the previous one's device work."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(v[rows]).long()
        if device.type == "cuda":
            t = t.pin_memory()
        out[k] = t.to(device, non_blocking=True)
    return out


def _pad_rows(batch: Dict[str, np.ndarray], rows: int, pad_id: int) -> Dict[str, np.ndarray]:
    """A partial eval batch topped up with pad rows: ids and labels all
    ``pad_id`` (so they add no tokens), attention masks all 0.  The JAX
    loop fills the masks with ``pad_id`` too, which is the same for T5's
    pad id 0."""
    return {k: np.concatenate([v, np.full((rows - len(v),) + v.shape[1:],
                                          0 if k == "attention_mask" else pad_id, v.dtype)])
            for k, v in batch.items()}


def t5_local_sums(model, batch: Dict[str, torch.Tensor],
                  generator: Optional[torch.Generator] = None):
    """Summed CE over this worker's non-pad labels and their count (device
    scalars): teacher forcing with ``shift_right`` inputs and a decoder key
    mask that always admits the start position, as the JAX loop builds
    them.  ``generator`` draws the dropout masks in ``train()`` mode."""
    from tpu_air_torch.models.t5.modeling import cross_entropy_sum, shift_right

    cfg = model.config
    labels = batch["labels"]
    dec_in = shift_right(labels, cfg.decoder_start_token_id, cfg.pad_token_id)
    dec_mask = (dec_in != cfg.pad_token_id).long()
    dec_mask[:, 0] = 1
    logits = model(batch["input_ids"], batch["attention_mask"], dec_in,
                   decoder_attention_mask=dec_mask, generator=generator)
    return cross_entropy_sum(logits, labels, cfg.pad_token_id)


def t5_mesh_sums(model, mesh, batch: Dict[str, torch.Tensor],
                 generators: Optional[Sequence[torch.Generator]] = None):
    """:func:`t5_local_sums` over a worker's ``(data, model)`` mesh: each
    data replica its contiguous block of ``batch`` (and its generator),
    the sums added in replica order on the first device."""
    from tpu_air_torch.parallel.mesh import batch_sharding
    from tpu_air_torch.parallel.tensor_parallel import call_replica

    home = mesh.devices[0, 0]
    totals, counts = [], []
    for r, block in enumerate(batch_sharding(batch, mesh)):
        gen = None if generators is None else generators[r]
        total, count = call_replica(model, mesh, r, t5_local_sums, block, gen)
        totals.append(total.to(home))
        counts.append(count.to(home))
    return torch.stack(totals).sum(0), torch.stack(counts).sum(0)


def make_t5_train_step(model, optimizer, generator=None, mesh=None):
    """``step(batch) -> loss`` (a detached device scalar, the global batch's
    mean CE): this worker's sum over the count of all workers, its gradient
    summed over them (not DDP's mean of per-worker means), one
    ``optimizer.step()``.  ``optimizer`` is what ``_make_optimizer``
    returns.  With a worker's ``mesh`` (:func:`t5_mesh_sums`), ``generator``
    is one generator a data replica."""
    from tpu_air_torch.parallel.distributed import all_reduce_grads, all_reduce_sum

    params = optimizer.params

    def step(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        if mesh is None:
            total, count = t5_local_sums(model, batch, generator)
        else:
            total, count = t5_mesh_sums(model, mesh, batch, generator)
        n = all_reduce_sum(count.float())
        loss = total / torch.clamp(n, min=1.0)
        loss.backward()
        all_reduce_grads(params)
        optimizer.step()
        return all_reduce_sum(loss.detach())

    return step


def t5_train_loop(config: Dict[str, Any]) -> None:
    """The training function of each worker (``config`` as
    ``T5Trainer._train_loop_config`` builds it).  Uses the session API for
    data, rank and reports."""
    from tpu_air_torch.device import resolve_device
    from tpu_air_torch.models.t5.config import T5Config
    from tpu_air_torch.models.t5.convert import jax_layouts, tp_split_dims
    from tpu_air_torch.models.t5.modeling import T5ForConditionalGeneration
    from tpu_air_torch.parallel.distributed import all_reduce_sum, current_host_group
    from tpu_air_torch.parallel.mesh import worker_devices, worker_mesh
    from tpu_air_torch.parallel.sharding import logical_parameters, params_bytes, shard_module

    from . import session

    args: TrainingArguments = config.get("training_args") or TrainingArguments(
        **{k: v for k, v in config.items() if k in TrainingArguments.__dataclass_fields__})
    # Tune-style overrides arrive as plain keys of the config
    for k in ("learning_rate", "num_train_epochs", "weight_decay"):
        if k in config:
            setattr(args, k, config[k])
    if "epochs" in config:
        args.num_train_epochs = config["epochs"]

    model_config: T5Config = config["model_config"]
    tokenizer = config.get("tokenizer")
    preprocessor = config.get("_preprocessor")
    # the tensor-parallel degree: ScalingConfig.model_parallel when it asks
    # for tp, else the loop-level TrainingArguments.tensor_parallelism
    sc = config.get("_scaling_config")
    sc_mp = getattr(sc, "model_parallel", None) or 1
    tp = sc_mp if sc_mp > 1 else max(1, args.tensor_parallelism)
    workers, rank = session.get_world_size(), session.get_world_rank()
    device = resolve_device(config.get("_device"))
    # this worker's (data, model) mesh over its devices (its host's share of
    # the lease in a multi-host fit, one worker a host); the extra devices
    # are in-worker data replicas
    mesh = worker_mesh(worker_devices(session.get_local_rank(),
                                      getattr(sc, "num_chips_per_worker", 1), device), tp)
    hosts = current_host_group()
    dpl = mesh.shape["data"]
    dp = dpl * workers
    home = mesh.devices[0, 0]
    pad_id = model_config.pad_token_id

    train_ds = session.get_dataset_shard("train")
    eval_ds = session.get_dataset_shard("evaluation")
    if eval_ds is None:
        eval_ds = session.get_dataset_shard("eval")
    if train_ds is None:
        raise ValueError("T5Trainer requires a 'train' dataset")
    per_device = args.per_device_train_batch_size
    global_bs = per_device * dp
    keys = ["input_ids", "attention_mask", "labels"]
    sample = next(train_ds.iter_batches(batch_size=2, batch_format="pandas"))
    seq_len = collate(sample, keys)["input_ids"].shape[1]

    model = T5ForConditionalGeneration(model_config, device=home)
    resume_dir = config.get("resume_from_checkpoint")
    pretrained = config.get("pretrained_params")
    if resume_dir:
        model.load_state_dict(Checkpoint.from_directory(resume_dir).get_params())
    elif pretrained is not None:
        model.load_state_dict(pretrained)
    else:
        model.init_weights(args.seed)     # numpy-seeded: Flax's init is not reproducible here
    shard_module(model, list(mesh.devices[0]), tp_split_dims(model_config, tp))
    model.train()

    steps_per_epoch = max(1, train_ds.count() // global_bs)
    if args.max_steps_per_epoch:
        steps_per_epoch = min(steps_per_epoch, args.max_steps_per_epoch)
    layouts = jax_layouts(model_config)
    logical = logical_parameters(model)
    opt = _make_optimizer(args, steps_per_epoch * args.num_train_epochs,
                          [(shards, dim) for _, shards, dim in logical],
                          [layouts[name] for name, _, _ in logical])
    params_bytes_total, params_bytes_per_device = params_bytes(model)
    # the JAX loop's PRNGKey(seed + 1); each data replica draws the masks of
    # its rows
    generators = [torch.Generator(device=mesh.devices[r, 0]) for r in range(dpl)]
    for r, g in enumerate(generators):
        g.manual_seed(args.seed + 1 + rank * dpl + r)
    train_step = make_t5_train_step(model, opt, generators, mesh)

    rows = per_device * dpl
    mine = slice(rank * rows, (rank + 1) * rows)
    for epoch in range(int(args.num_train_epochs)):
        t0 = time.time()
        tokens, nsteps, losses = 0, 0, []
        for batch_df in train_ds.iter_batches(batch_size=global_bs, batch_format="pandas",
                                              drop_last=True):
            if len(batch_df) < global_bs:
                continue
            batch = _tensors(collate(batch_df, keys, seq_len), mine, home)
            losses.append(train_step(batch))    # a device scalar: no host sync per step
            tokens += global_bs * seq_len
            nsteps += 1
            if args.max_steps_per_epoch and nsteps >= args.max_steps_per_epoch:
                break
        # one host sync, which also waits for the epoch's device work
        train_loss = float(torch.stack(losses).mean()) if losses else float("nan")
        dt = time.time() - t0
        metrics: Dict[str, Any] = {
            "epoch": epoch + 1,
            "loss": train_loss,
            "steps": nsteps,
            "train_tokens_per_sec": tokens / dt if dt > 0 else 0.0,
            "train_tokens_per_sec_per_chip": (tokens / dt / (dp * tp)) if dt > 0 else 0.0,
            "mesh_data": dp,
            "mesh_model": tp,
            # the hosts the run spans: the cross-host proof of a multi-host fit
            "mesh_num_hosts": hosts.size if hosts is not None else 1,
            "params_bytes_total": params_bytes_total,
            "params_bytes_per_device": params_bytes_per_device,
        }

        if eval_ds is not None and args.evaluation_strategy == "epoch":
            ebs = args.per_device_eval_batch_size * dp
            erows = args.per_device_eval_batch_size * dpl
            eval_rows = slice(rank * erows, (rank + 1) * erows)
            parts = []
            model.eval()
            with torch.no_grad():
                for batch_df in eval_ds.iter_batches(batch_size=ebs, batch_format="pandas",
                                                     drop_last=False):
                    batch = _pad_rows(collate(batch_df, keys, seq_len), ebs, pad_id)
                    total, count = t5_mesh_sums(model, mesh, _tensors(batch, eval_rows, home))
                    sums = all_reduce_sum(torch.stack([total, count.float()]))
                    # the JAX eval step's ntok is at least 1 per global batch
                    parts.append(torch.stack([sums[0], torch.clamp(sums[1], min=1.0)]))
            model.train()
            if parts:
                tot, cnt = torch.stack(parts).double().sum(0).tolist()   # one host sync
                metrics["eval_loss"] = tot / max(cnt, 1.0)

        ckpt = None
        if args.save_strategy == "epoch" and rank == 0:
            ckpt = Checkpoint.from_model(model_config=model_config, params=model,
                                         tokenizer=tokenizer, preprocessor=preprocessor,
                                         metrics=metrics)
        session.report(metrics, checkpoint=ckpt)


class T5Trainer(BaseTrainer):
    """FLAN-T5 fine-tuning through the Trainer API (the JAX package's
    ``T5Trainer``): ``model_config`` or ``model_name`` (``flan-t5-base`` by
    default), ``training_args``, and optionally the ``tokenizer`` and
    ``pretrained_params`` (a state dict of the port's model) the
    checkpoints carry and training starts from."""

    _name_prefix = "T5Trainer"

    def __init__(
        self,
        *,
        model_config=None,
        model_name: Optional[str] = None,
        training_args: Optional[TrainingArguments] = None,
        tokenizer=None,
        pretrained_params=None,
        trainer_init_config: Optional[Dict[str, Any]] = None,
        **kwargs,
    ):
        super().__init__(**kwargs)
        if model_config is None:
            from tpu_air_torch.models.t5.config import T5Config

            model_config = T5Config.from_name(model_name or "flan-t5-base")
        self.model_config = model_config
        self.training_args = training_args or TrainingArguments()
        self.tokenizer = tokenizer
        self.pretrained_params = pretrained_params
        self.trainer_init_config = trainer_init_config or {}

    def _training_fn(self):
        return t5_train_loop

    def _train_loop_config(self) -> Dict[str, Any]:
        cfg = dict(self.trainer_init_config)
        cfg["model_config"] = self.model_config
        cfg["training_args"] = self.training_args
        cfg["tokenizer"] = self.tokenizer
        if self.pretrained_params is not None:
            cfg["pretrained_params"] = self.pretrained_params
        return cfg
