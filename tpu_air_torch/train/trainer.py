"""Trainers: ``fit()`` with retries from the latest checkpoint (the port's
counterpart of ``tpu_air/train/trainer.py``).

The JAX package runs each attempt in a trial actor holding a chip lease.
The port has no core runtime yet (ROADMAP Queue 1 item 1), so ``fit()``
runs each attempt in the calling process on the trainer's device; the
attempt loop is that of ``_run_actor_attempts``: an attempt whose training
function raises is retried, up to ``FailureConfig.max_failures`` times,
resuming from the newest checkpoint that attempt retained.
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


def _run_trial(training_fn: Callable[[Dict[str, Any]], None], config: Dict[str, Any],
               run_dir: str, datasets: Dict[str, Any],
               checkpoint_config: CheckpointConfig, world_size: int) -> Dict[str, Any]:
    """One attempt in this process: the body of the JAX package's
    ``_TrialRunner.run``."""
    session = Session(run_dir=run_dir, checkpoint_config=checkpoint_config,
                      datasets=datasets, config=config, world_size=world_size)
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


class BaseTrainer:
    """Shared fit() machinery.  Subclasses provide ``_training_fn()`` (a
    function of one ``config`` dict that uses the session API).

    ``datasets`` values are pandas DataFrames (wrapped in
    :class:`_BroadcastDataset`) or objects with the same surface.
    ``device``: where the training function runs (``cuda:0`` by default,
    which raises without CUDA; ``"cpu"`` runs the kernels' plain
    versions)."""

    _name_prefix = "Trainer"

    def __init__(
        self,
        *,
        scaling_config: Optional[ScalingConfig] = None,
        run_config: Optional[RunConfig] = None,
        datasets: Optional[Dict[str, Any]] = None,
        resume_from_checkpoint: Optional[Checkpoint] = None,
        metadata: Optional[Dict[str, Any]] = None,
        device: DeviceLike = None,
    ):
        self.scaling_config = scaling_config or ScalingConfig()
        self.run_config = run_config or RunConfig()
        self.datasets = {k: _as_dataset(ds) for k, ds in (datasets or {}).items()}
        self.resume_from_checkpoint = resume_from_checkpoint
        self.metadata = metadata or {}
        self.device = resolve_device(device)

    def _training_fn(self) -> Callable[[Dict[str, Any]], None]:
        raise NotImplementedError

    def _train_loop_config(self) -> Dict[str, Any]:
        return {}

    def fit(self) -> Result:
        name = self.run_config.name or (
            f"{self._name_prefix}_{int(time.time())}_{os.urandom(3).hex()}"
        )
        run_dir = os.path.join(self.run_config.storage_path or _default_storage(), name)
        os.makedirs(run_dir, exist_ok=True)
        config = dict(self._train_loop_config())
        config["_scaling_config"] = self.scaling_config
        config["_device"] = self.device
        return self._run_attempts(config, run_dir)

    def _run_attempts(self, config: Dict[str, Any], run_dir: str) -> Result:
        rc = self.run_config
        resume = self.resume_from_checkpoint
        attempt = 0
        while True:
            if resume is not None:
                config["resume_from_checkpoint"] = (
                    resume.to_directory() if isinstance(resume, Checkpoint) else resume
                )
            out = _run_trial(self._training_fn(), config, run_dir, self.datasets,
                             rc.checkpoint_config, self.scaling_config.num_workers)
            err = out["error"]
            if err is None:
                return self._assemble(out, run_dir, config, None)
            latest = out["latest_checkpoint"]
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
