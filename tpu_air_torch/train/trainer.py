"""Trainers: ``fit()`` with retries from the latest checkpoint (the port's
counterpart of ``tpu_air/train/trainer.py``).

The JAX package runs each attempt in a trial actor holding a chip lease.
The port's trial runner over its runtime comes with Tune (ROADMAP Queue 1
item 4), so ``fit()`` runs each attempt in the calling process on the trainer's device, or, with
``ScalingConfig(num_workers=N > 1)``, in N spawned worker processes joined
in one ``torch.distributed`` group (``parallel/distributed.py``), whose
rank 0 reports and checkpoints.  The attempt loop is that of
``_run_actor_attempts``: an attempt whose training function raises (on any
rank) is retried, up to ``FailureConfig.max_failures`` times, resuming from
the newest checkpoint that attempt retained.  A ``preprocessor`` is fitted
on the train dataset and applied to every dataset before the first attempt.
"""

from __future__ import annotations

import os
import time
import traceback
from typing import Any, Callable, Dict, Optional

from tpu_air_torch.device import DeviceLike, resolve_device

from .checkpoint import Checkpoint
from .config import CheckpointConfig, RunConfig, ScalingConfig
from .result import Result
from .session import Session, _set_active


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


def _run_trial(training_fn: Callable[[Dict[str, Any]], None], config: Dict[str, Any],
               run_dir: str, datasets: Dict[str, Any],
               checkpoint_config: CheckpointConfig, world_size: int = 1,
               world_rank: int = 0) -> Dict[str, Any]:
    """One attempt in this process (one rank of it with several workers):
    the body of the JAX package's ``_TrialRunner.run``."""
    session = Session(run_dir=run_dir, checkpoint_config=checkpoint_config,
                      datasets=datasets, config=config, world_size=world_size,
                      world_rank=world_rank)
    _set_active(session)
    out: Dict[str, Any] = {"error": None}
    try:
        training_fn(config)
    except Exception as e:  # noqa: BLE001 - trial boundary: recorded, retried by fit()
        out["error"] = f"{type(e).__name__}: {e}\n{traceback.format_exc()}"
    finally:
        _set_active(None)
    out["history"] = session.history
    out["checkpoints"] = list(session.checkpoints)
    out["best_checkpoint"] = session.best_checkpoint()
    out["latest_checkpoint"] = session.latest_checkpoint()
    return out


def _worker_trial(rank: int, world_size: int, device, training_fn, config, run_dir,
                  datasets, checkpoint_config) -> Dict[str, Any]:
    """One rank of an attempt, in a worker process on its own device."""
    config = dict(config, _device=device)
    return _run_trial(training_fn, config, run_dir, datasets, checkpoint_config,
                      world_size, rank)


def _run_workers_trial(training_fn, config, run_dir, datasets, checkpoint_config,
                       num_workers: int, device) -> Dict[str, Any]:
    """One attempt over ``num_workers`` worker processes: rank 0's record,
    with the errors of every rank."""
    from tpu_air_torch.parallel.distributed import run_workers

    outs = run_workers(_worker_trial,
                       (training_fn, config, run_dir, datasets, checkpoint_config),
                       num_workers, device,
                       cloudpickled=config.get("_preprocessor") is not None)
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
    ``ScalingConfig(use_gpu=False)`` asks for the CPU too)."""

    _name_prefix = "Trainer"

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
        self.device = resolve_device(device)
        if use_gpu is not None and use_gpu != (self.device.type == "cuda"):
            raise ValueError(f"ScalingConfig(use_gpu={use_gpu}) and device {self.device} "
                             "disagree")

    def _training_fn(self) -> Callable[[Dict[str, Any]], None]:
        raise NotImplementedError

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
        config["_device"] = self.device
        return self._run_attempts(config, run_dir, datasets)

    def _run_attempts(self, config: Dict[str, Any], run_dir: str,
                      datasets: Dict[str, Any]) -> Result:
        rc = self.run_config
        resume = self.resume_from_checkpoint
        workers = self.scaling_config.num_workers
        attempt = 0
        while True:
            if resume is not None:
                config["resume_from_checkpoint"] = (
                    resume.to_directory() if isinstance(resume, Checkpoint) else resume
                )
            if workers > 1:
                out = _run_workers_trial(self._training_fn(), config, run_dir, datasets,
                                         rc.checkpoint_config, workers, self.device)
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
