"""Training session — the loop's reporting channel (the port's counterpart
of ``tpu_air/train/session.py``).

The training loop calls ``session.report(metrics, checkpoint)`` once per
epoch; the session records the history (also appended to
``progress.jsonl``), retains checkpoints under the run directory by
``CheckpointConfig`` and tracks the best and the latest one.  In a run of
several workers every rank has a session; rank 0's writes the progress
file and retains the checkpoints; every host of a multi-host fit has one
too, host 0's the real one.  In a Tune trial the session's
``decision_cb`` hands each report to the driver and ``report`` raises
:class:`StopTrial` when the scheduler stops the trial.  With
``CheckpointConfig.publish_weights_to`` every retained checkpoint is also
published to that :class:`~tpu_air_torch.serve.weights.WeightStore`, the
live-serving handoff.  With tracing on (``TPU_AIR_TRACE=1``), each report
records a ``train.iteration`` span under the trace context the session was
made in, so ``step_timer`` numbers and ``profile_trace`` land on the same
timeline.  Fault-plan hooks and metric sinks wait for the slices that port
them.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from tpu_air_torch.observability import tracing as _tracing

from .checkpoint import Checkpoint
from .config import CheckpointConfig


class StopTrial(Exception):
    """Raised inside the training loop when the scheduler stops this trial."""


class Session:
    def __init__(
        self,
        run_dir: str,
        checkpoint_config: Optional[CheckpointConfig] = None,
        datasets: Optional[Dict[str, Any]] = None,
        config: Optional[Dict[str, Any]] = None,
        world_size: int = 1,
        world_rank: int = 0,
        decision_cb: Optional[Callable[[Dict[str, Any], int], bool]] = None,
        local_rank: Optional[int] = None,
    ):
        self.run_dir = run_dir
        self.checkpoint_config = checkpoint_config or CheckpointConfig()
        self.datasets = datasets or {}
        self.config = config or {}
        self.world_size = world_size
        self.world_rank = world_rank
        # this rank's index among the ranks of its machine: its worker's on
        # one host; 0 on every host of a multi-host fit, where one
        # controller a host runs over all of the host's devices
        self.local_rank = world_rank if local_rank is None else local_rank
        self.decision_cb = decision_cb
        self.history: List[Dict[str, Any]] = []
        self.checkpoints: List[Tuple[str, Dict[str, Any]]] = []  # (dir, metrics)
        self._iter = 0
        # airtrace: ambient context at session construction (the trainer's
        # task span on the worker) so every train.iteration span lands on
        # the same trial timeline; report-to-report window stamps
        self._trace_ctx = _tracing.current_propagation()
        self._last_report_ns = _tracing.now_ns() if _tracing.enabled() else 0
        os.makedirs(run_dir, exist_ok=True)

    def get_dataset_shard(self, name: str):
        return self.datasets.get(name)

    def report(self, metrics: Dict[str, Any], checkpoint: Optional[Checkpoint] = None):
        self._iter += 1
        rec = dict(metrics)
        rec.setdefault("training_iteration", self._iter)
        rec.setdefault("_timestamp", time.time())
        self.history.append(rec)
        if _tracing.enabled():
            self._emit_iteration_span()
        if self.world_rank == 0:
            with open(os.path.join(self.run_dir, "progress.jsonl"), "a") as f:
                f.write(json.dumps(rec, default=float) + "\n")
            if checkpoint is not None:
                self._retain(checkpoint, rec)
                if self.checkpoint_config.publish_weights_to:
                    self._publish_weights(checkpoint, rec)
        # every rank with a decision_cb asks it (the hosts of a multi-host
        # fit decide together whether their lease is revoked); the stream's
        # sequence number is the session's own counter: user metrics may
        # set training_iteration, but the Tune driver drains report-1,
        # report-2, ... in order
        if self.decision_cb is not None and not self.decision_cb(rec, self._iter):
            raise StopTrial(f"trial stopped by scheduler at iteration {self._iter}")

    def _emit_iteration_span(self) -> None:
        """One ``train.iteration`` span per report, covering the window
        since the previous report (what ``step_timer`` summarizes) so the
        trial's cadence is visible on the same timeline as everything else."""
        now = _tracing.now_ns()
        if self._trace_ctx is None:
            # no ambient context at construction (tracing enabled later, or
            # a bare local session): root one trace for the whole session
            self._trace_ctx = {"trace_id": _tracing.new_trace_id()}
        _tracing.record_span(
            "train.iteration",
            trace_id=self._trace_ctx.get("trace_id"),
            parent_id=self._trace_ctx.get("span_id"),
            start_ns=self._last_report_ns or now,
            end_ns=now,
            attrs={"iteration": self._iter, "run_dir": self.run_dir},
        )
        self._last_report_ns = now

    # -- weight publishing (the live-serving handoff) -----------------------
    def _publish_weights(self, checkpoint: Checkpoint, metrics: Dict[str, Any]) -> None:
        """Publish the retained checkpoint's parameters, with its iteration
        and metrics, to ``CheckpointConfig.publish_weights_to``, then keep
        the newest ``num_to_keep`` versions (2 when unset).  The publish is
        torn-proof and checksummed, and a failure, an injected
        ``weights.publish`` fault included, does not stop training: serving
        keeps the previous version."""
        from tpu_air_torch.faults.plan import FaultInjectedError
        from tpu_air_torch.serve.weights import TornPublishError, WeightStore

        params = checkpoint.get_params()
        if params is None:
            return
        cfg = self.checkpoint_config
        try:
            store = WeightStore(cfg.publish_weights_to)
            store.publish(params, metadata={
                "iteration": self._iter,
                "run_dir": self.run_dir,
                "metrics": {k: v for k, v in metrics.items()
                            if isinstance(v, (int, float, str))},
            })
            store.gc(keep=cfg.num_to_keep or 2)
        except (TornPublishError, FaultInjectedError, OSError, TimeoutError):
            # a torn or failed publish leaves no manifest, so serving never
            # sees it
            pass

    # -- retention (CheckpointConfig semantics) -----------------------------
    def _retain(self, checkpoint: Checkpoint, metrics: Dict[str, Any]):
        ckpt_dir = os.path.join(self.run_dir, f"checkpoint_{self._iter:06d}")
        src = checkpoint.path
        checkpoint.to_directory(ckpt_dir)
        # from_model() stages into a tempdir; once copied under run_dir the
        # staging copy would leak one state dict per epoch — remove it and
        # repoint the handle at the retained copy.
        if (
            src
            and os.path.abspath(src) != os.path.abspath(ckpt_dir)
            and os.path.abspath(src).startswith(tempfile.gettempdir() + os.sep)
        ):
            shutil.rmtree(src, ignore_errors=True)
            checkpoint._path = ckpt_dir
        self.checkpoints.append((ckpt_dir, metrics))
        cfg = self.checkpoint_config
        if cfg.num_to_keep is None or len(self.checkpoints) <= cfg.num_to_keep:
            return
        attr = cfg.checkpoint_score_attribute
        if attr:
            sign = 1 if cfg.checkpoint_score_order == "min" else -1
            ranked = sorted(
                self.checkpoints,
                key=lambda cm: sign * float(cm[1].get(attr, float("inf") * sign)),
            )
        else:
            ranked = list(reversed(self.checkpoints))  # keep most recent
        keep = {path for path, _ in ranked[: cfg.num_to_keep]}
        for path, _ in self.checkpoints:
            if path not in keep:
                shutil.rmtree(path, ignore_errors=True)
        self.checkpoints = [cm for cm in self.checkpoints if cm[0] in keep]

    # -- results ------------------------------------------------------------
    def best_checkpoint(self) -> Optional[Tuple[str, Dict[str, Any]]]:
        if not self.checkpoints:
            return None
        cfg = self.checkpoint_config
        attr = cfg.checkpoint_score_attribute
        if not attr:
            return self.checkpoints[-1]
        sign = 1 if cfg.checkpoint_score_order == "min" else -1
        return min(
            self.checkpoints,
            key=lambda cm: sign * float(cm[1].get(attr, float("inf") * sign)),
        )

    def latest_checkpoint(self) -> Optional[Tuple[str, Dict[str, Any]]]:
        return self.checkpoints[-1] if self.checkpoints else None


# -- the active session (what training loops import) -------------------------

_active: Optional[Session] = None


def _set_active(s: Optional[Session]):
    global _active
    _active = s


def get_session() -> Session:
    if _active is None:
        raise RuntimeError("no active training session (call inside a trainer loop)")
    return _active


def report(metrics: Dict[str, Any], checkpoint: Optional[Checkpoint] = None):
    get_session().report(metrics, checkpoint)


def get_dataset_shard(name: str):
    return get_session().get_dataset_shard(name)


def get_config() -> Dict[str, Any]:
    return get_session().config


def get_world_size() -> int:
    return get_session().world_size


def get_world_rank() -> int:
    return get_session().world_rank


def get_local_rank() -> int:
    return get_session().local_rank
