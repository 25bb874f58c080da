"""Trainers: ``fit()`` with retries from the latest checkpoint (the port's
counterpart of ``tpu_air/train/trainer.py``).

An attempt runs one of two ways:

* ``BaseTrainer.fit()`` runs it in the calling process on the trainer's
  device, or, with ``ScalingConfig(num_workers=N > 1)``, in N spawned
  worker processes joined in one ``torch.distributed`` group
  (``parallel/distributed.py``), whose rank 0 reports and checkpoints.
  A worker's rank runs over its ``num_chips_per_worker`` devices (a
  tensor-parallel mesh, in-worker data replicas), except that ``LMTrainer``'s
  sequence-parallel step starts one rank a device: ``_num_ranks()`` and
  ``_devices_per_rank()``.
  The JAX package runs ``fit()``'s attempts in a trial actor that holds a
  chip lease; the port keeps them in process (ROADMAP Queue 1 item 13),
  which the W1 loop and its gloo workers rely on.
* Tune runs each attempt of a trial in a :class:`_TrialRunner`, an actor of
  the port's runtime that leases ``ScalingConfig.total_chips`` cards; a
  training function given no device takes ``cuda:<first leased id>``
  there.  Each report streams to the driver through the object store and
  the scheduler's decision comes back the same way; a stopped trial ends
  with ``StopTrial``, which is a clean stop, not an error.  A trial actor
  is a daemonic process, which may not start processes, so a trial cannot
  spawn ``num_workers > 1`` workers (ROADMAP Queue 1 item 12).

The attempt loop is that of ``_run_actor_attempts``: an attempt whose
training function raises (on any rank) is retried, up to
``FailureConfig.max_failures`` times, resuming from the newest checkpoint
that attempt retained.  A ``preprocessor`` is fitted on the train dataset
and applied to every dataset before the first attempt.
"""

from __future__ import annotations

import os
import time
import traceback
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from tpu_air_torch.core.remote import remote
from tpu_air_torch.device import DeviceLike, resolve_device

from .checkpoint import Checkpoint
from .config import CheckpointConfig, RunConfig, ScalingConfig
from .result import Result
from .session import Session, StopTrial, _set_active


def _default_storage() -> str:
    return os.environ.get(
        "TPU_AIR_RESULTS_DIR", os.path.join(os.path.expanduser("~"), "tpu_air_results")
    )


class _BroadcastDataset:
    """A pandas-backed dataset: the dataset type the port's trainers take
    (copied from the JAX package, where it carries datasets to every host of
    a multihost run).  Covers the surface the train loops use:
    ``iter_batches`` / ``count`` / ``to_pandas``."""

    def __init__(self, df):
        self._df = df.reset_index(drop=True)

    def count(self) -> int:
        return len(self._df)

    def to_pandas(self):
        return self._df

    def iter_batches(self, batch_size: int, batch_format: str = "pandas",
                     drop_last: bool = False):
        n = len(self._df)
        end = n - (n % batch_size) if drop_last else n
        for i in range(0, max(end, 0), batch_size):
            yield self._df.iloc[i : i + batch_size]

    def split(self, n: int, *, equal: bool = True) -> List["_BroadcastDataset"]:
        """``n`` contiguous shards, sized as the data layer's
        ``Dataset.split`` sizes them: ``equal`` drops the remainder rows,
        otherwise the first shards are one row shorter."""
        total = len(self._df)
        if equal:
            sizes = [total // n] * n
        else:
            sizes = [(total + i) // n for i in range(n)]
        offs = np.cumsum([0] + sizes)
        return [_BroadcastDataset(self._df.iloc[int(offs[i]) : int(offs[i + 1])])
                for i in range(n)]

    def map_batches(self, fn, batch_format: str = "pandas",
                    batch_size: Optional[int] = None) -> "_BroadcastDataset":
        """A new dataset of ``fn`` applied to each batch of ``batch_size``
        rows (all rows when None), given as a DataFrame or, with
        ``batch_format="numpy"``, a dict of arrays; ``fn`` returns either."""
        import pandas as pd

        from tpu_air_torch.predict.predictor import _batch_to_numpy, _batch_to_pandas

        if batch_format not in ("pandas", "numpy"):
            raise ValueError(f"batch_format must be 'pandas' or 'numpy', not {batch_format!r}")
        n = len(self._df)
        step = batch_size or max(n, 1)
        outs = []
        for i in range(0, n, step):
            batch = self._df.iloc[i : i + step].reset_index(drop=True)
            if batch_format == "numpy":
                batch = _batch_to_numpy(batch)
            outs.append(_batch_to_pandas(fn(batch)))
        return _BroadcastDataset(pd.concat(outs, ignore_index=True) if outs else self._df)


def _scan_latest_checkpoint(run_dir: str):
    """Newest ``checkpoint_*`` directory under ``run_dir`` as the
    ``(path, metrics)`` pair the session would have reported: what a retry
    resumes from when the trial actor crashed and took the session's list
    with it (the iteration-numbered names sort in time order)."""
    try:
        dirs = sorted(
            d for d in os.listdir(run_dir)
            if d.startswith("checkpoint_") and os.path.isdir(os.path.join(run_dir, d)))
    except OSError:
        return None
    if not dirs:
        return None
    return (os.path.join(run_dir, dirs[-1]), {})


def _run_trial(training_fn: Callable[[Dict[str, Any]], None], config: Dict[str, Any],
               run_dir: str, datasets: Dict[str, Any],
               checkpoint_config: CheckpointConfig, world_size: int = 1,
               world_rank: int = 0, decision_cb=None) -> Dict[str, Any]:
    """One attempt in this process (one rank of it with several workers):
    the body of the JAX package's ``_TrialRunner.run``.  A ``StopTrial``
    from the scheduler ends it clean (``"stopped": True``)."""
    session = Session(run_dir=run_dir, checkpoint_config=checkpoint_config,
                      datasets=datasets, config=config, world_size=world_size,
                      world_rank=world_rank, decision_cb=decision_cb)
    _set_active(session)
    out: Dict[str, Any] = {"error": None, "stopped": False}
    try:
        training_fn(config)
    except StopTrial:
        out["stopped"] = True
    except Exception as e:  # noqa: BLE001 - trial boundary: recorded, retried by fit()
        out["error"] = f"{type(e).__name__}: {e}\n{traceback.format_exc()}"
    finally:
        _set_active(None)
    out["history"] = session.history
    out["checkpoints"] = list(session.checkpoints)
    out["best_checkpoint"] = session.best_checkpoint()
    out["latest_checkpoint"] = session.latest_checkpoint()
    return out


@remote
class _TrialRunner:
    """Actor hosting one attempt of a Tune trial on its chip lease."""

    def run(self, training_fn: Callable[[Dict[str, Any]], None], config: Dict[str, Any],
            run_dir: str, datasets: Dict[str, Any], checkpoint_config: CheckpointConfig,
            world_size: int, trial_id: str) -> Dict[str, Any]:
        from tpu_air_torch.core import runtime as _rt

        store = _rt.current_worker().store

        def decision_cb(rec, seq):
            # Stream the report to the driver, then wait briefly for the
            # scheduler's ack so a prune lands BEFORE the next epoch spends
            # compute.  If the driver is slow the trial goes on and the
            # `{trial}-stop` marker catches it at a later report.
            store.put(rec, f"{trial_id}-report-{seq}")
            try:
                ok = bool(store.get(f"{trial_id}-ack-{seq}", timeout=5.0))
                store.delete(f"{trial_id}-ack-{seq}")
                if not ok:
                    return False
            except TimeoutError:
                pass
            return not store.contains(f"{trial_id}-stop")

        return _run_trial(training_fn, config, run_dir, datasets, checkpoint_config,
                          world_size, decision_cb=decision_cb)


def _worker_trial(rank: int, world_size: int, device, training_fn, config, run_dir,
                  datasets, checkpoint_config) -> Dict[str, Any]:
    """One rank of an attempt, in a worker process on its own device."""
    config = dict(config, _device=device)
    return _run_trial(training_fn, config, run_dir, datasets, checkpoint_config,
                      world_size, rank)


def _run_workers_trial(training_fn, config, run_dir, datasets, checkpoint_config,
                       num_workers: int, device, devices_per_rank: int = 1) -> Dict[str, Any]:
    """One attempt over ``num_workers`` worker processes: rank 0's record,
    with the errors of every rank."""
    from tpu_air_torch.parallel.distributed import run_workers

    outs = run_workers(_worker_trial,
                       (training_fn, config, run_dir, datasets, checkpoint_config),
                       num_workers, device,
                       cloudpickled=config.get("_preprocessor") is not None,
                       chips_per_worker=devices_per_rank)
    errors = [o["error"] for o in outs if o.get("error")]
    out = dict(outs[0])
    out["error"] = "\n".join(errors) if errors else None
    return out


class BaseTrainer:
    """Shared fit() machinery.  Subclasses provide ``_training_fn()`` (a
    function of one ``config`` dict that uses the session API).

    ``datasets`` values are pandas DataFrames (wrapped in
    :class:`_BroadcastDataset`) or objects with the same surface.
    ``preprocessor``: a ``tpu_air_torch.data.preprocessors.Preprocessor``
    fitted on ``datasets["train"]`` and applied to every dataset.
    ``device``: where the training function runs (``cuda:0`` by default,
    which raises without CUDA; ``"cpu"`` runs the kernels' plain versions;
    ``ScalingConfig(use_gpu=False)`` asks for the CPU too).  A Tune trial
    takes the device named here, or, when none was, its leased card."""

    _name_prefix = "Trainer"
    # num_workers > 1 spawns worker processes (parallel/distributed.py),
    # which a trial actor may not start
    _spawns_workers = True
    # the training function builds a model on self.device, resolved here so
    # that a missing card raises at construction; a trainer that places
    # nothing itself passes the named device (or None) on to its function
    _needs_device = True

    def __init__(
        self,
        *,
        scaling_config: Optional[ScalingConfig] = None,
        run_config: Optional[RunConfig] = None,
        datasets: Optional[Dict[str, Any]] = None,
        preprocessor=None,
        resume_from_checkpoint: Optional[Checkpoint] = None,
        metadata: Optional[Dict[str, Any]] = None,
        device: DeviceLike = None,
    ):
        self.scaling_config = scaling_config or ScalingConfig()
        self.run_config = run_config or RunConfig()
        self.datasets = {k: _as_dataset(ds) for k, ds in (datasets or {}).items()}
        self.preprocessor = preprocessor
        self.resume_from_checkpoint = resume_from_checkpoint
        self.metadata = metadata or {}
        use_gpu = self.scaling_config.use_gpu
        if device is None and use_gpu is False:
            device = "cpu"
        self._named_device = device
        self.device = resolve_device(device) if self._needs_device else None
        if self.device is not None and use_gpu is not None and \
                use_gpu != (self.device.type == "cuda"):
            raise ValueError(f"ScalingConfig(use_gpu={use_gpu}) and device {self.device} "
                             "disagree")

    def _training_fn(self) -> Callable[[Dict[str, Any]], None]:
        raise NotImplementedError

    def _num_ranks(self) -> int:
        """Processes an attempt runs in: one a data-parallel worker."""
        return self.scaling_config.num_workers

    def _devices_per_rank(self) -> int:
        """Devices each rank runs over: its worker's."""
        return self.scaling_config.num_chips_per_worker

    def _train_loop_config(self) -> Dict[str, Any]:
        return {}

    # -- preprocessing (fit on train, apply to every dataset) ---------------
    def _preprocess(self) -> Dict[str, Any]:
        datasets = dict(self.datasets)
        if self.preprocessor is not None:
            train = datasets.get("train")
            if train is not None and self.preprocessor._is_fittable:
                if not self.preprocessor.check_is_fitted():
                    self.preprocessor.fit(train)
            for k, ds in list(datasets.items()):
                datasets[k] = self.preprocessor.transform(ds)
        return datasets

    def fit(self) -> Result:
        name = self.run_config.name or (
            f"{self._name_prefix}_{int(time.time())}_{os.urandom(3).hex()}"
        )
        run_dir = os.path.join(self.run_config.storage_path or _default_storage(), name)
        os.makedirs(run_dir, exist_ok=True)
        datasets = self._preprocess()
        config = dict(self._train_loop_config())
        config["_preprocessor"] = self.preprocessor
        config["_scaling_config"] = self.scaling_config
        config["_device"] = self.device if self._needs_device else self._named_device
        return self._run_attempts(config, run_dir, datasets)

    def _run_attempts(self, config: Dict[str, Any], run_dir: str,
                      datasets: Dict[str, Any]) -> Result:
        rc = self.run_config
        resume = self.resume_from_checkpoint
        workers = self._num_ranks()
        attempt = 0
        while True:
            if resume is not None:
                config["resume_from_checkpoint"] = (
                    resume.to_directory() if isinstance(resume, Checkpoint) else resume
                )
            if workers > 1 and self._spawns_workers:
                out = _run_workers_trial(self._training_fn(), config, run_dir, datasets,
                                         rc.checkpoint_config, workers,
                                         self.device or resolve_device(self._named_device),
                                         self._devices_per_rank())
            else:
                out = _run_trial(self._training_fn(), config, run_dir, datasets,
                                 rc.checkpoint_config)
            err = out["error"]
            if err is None:
                return self._assemble(out, run_dir, config, None)
            latest = out.get("latest_checkpoint")
            if attempt < rc.failure_config.max_failures:
                attempt += 1
                if latest:
                    resume = Checkpoint.from_directory(latest[0])
                continue
            return self._assemble(out, run_dir, config, RuntimeError(err))

    def _assemble(self, out, run_dir, config, error) -> Result:
        best = out.get("best_checkpoint")
        history = out.get("history", [])
        return Result(
            metrics=history[-1] if history else {},
            checkpoint=Checkpoint.from_directory(best[0]) if best else None,
            error=error,
            path=run_dir,
            metrics_history=history,
            best_checkpoints=[
                (Checkpoint.from_directory(p), m) for p, m in out.get("checkpoints", [])
            ],
            config={k: v for k, v in config.items() if not k.startswith("_")},
        )


def _as_dataset(ds):
    if ds is None or hasattr(ds, "iter_batches"):
        return ds
    return _BroadcastDataset(ds)


class TorchTrainer(BaseTrainer):
    """Generic function trainer (the JAX package's ``JaxTrainer``, the
    reference's ``TorchTrainer(train_loop_per_worker)``): runs
    ``train_loop_per_worker(config)``, which uses
    ``tpu_air_torch.train.session`` (report / get_dataset_shard /
    get_config).  A function trainable handed to Tune is wrapped in one.
    It places nothing itself: the function gets the named device, or None,
    in ``config["_device"]`` and resolves it where it runs."""

    _name_prefix = "TorchTrainer"
    _needs_device = False

    def __init__(
        self,
        train_loop_per_worker: Callable[[Dict[str, Any]], None],
        *,
        train_loop_config: Optional[Dict[str, Any]] = None,
        **kwargs,
    ):
        super().__init__(**kwargs)
        self.train_loop_per_worker = train_loop_per_worker
        self.train_loop_config = train_loop_config or {}

    def _training_fn(self):
        return self.train_loop_per_worker

    def _train_loop_config(self):
        return dict(self.train_loop_config)
