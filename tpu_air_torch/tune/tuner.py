"""Tuner — trial-parallel HPO over a Trainer, the port's counterpart of
``tpu_air/tune/tuner.py`` (L4; SURVEY.md §3.2).

Parity surface: ``Tuner(trainer, param_space, tune_config, run_config)``
(Model_finetuning…ipynb:cc-57), ``TuneConfig(metric, mode, num_samples,
scheduler)`` (both import spellings), ``tuner.fit() -> ResultGrid``.

Resource model: every trial runs in a ``_TrialRunner`` actor
(``train/trainer.py``) that leases the trainer's
``ScalingConfig.total_chips`` cards at once, as the JAX trial does, and as
``fit()``'s runner does (``BaseTrainer._runner_chips``: none for a trainer
on the CPU, whose trials ``TuneConfig.max_concurrent_trials`` bounds).  The
runtime queues the actors until a lease frees, so on one card the trials
run one after another; a finished trial's runner is killed, and its cards
return to the pool only once the runner's process (and its CUDA context)
has exited.  Leases are whole cards, as in the JAX runtime.  In the actor a
training function given no device takes ``cuda:<first leased id>``; a
device named on the trainer (the tests' ``"cpu"``) is passed on as it is.
A trainer with ``num_workers > 1`` runs its trial on that many worker
actors placed on the runner's own lease (never claimed from the pool
again, so two trials cannot each hold half of their cards and wait for the
rest), joined in one ``torch.distributed`` group; rank 0 reports, and the
scheduler's decision on each report reaches every rank before any of them
goes on (``train/trainer.py::_shared_decision``).

Driver loop: trials stream per-epoch reports through the object store
(``{trial}-report-{i}`` keys written by the trial's decision callback); the
scheduler (e.g. ASHA) judges each report, the driver acks the decision and
plants a ``{trial}-stop`` marker that the trial's next ``session.report``
observes — asynchronous early stopping with no barrier across trials.
"""

from __future__ import annotations

import copy
import os
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np

import tpu_air_torch
from tpu_air_torch.train.checkpoint import Checkpoint
from tpu_air_torch.train.config import RunConfig
from tpu_air_torch.train.result import Result
from tpu_air_torch.train.trainer import (
    BaseTrainer,
    TorchTrainer,
    _default_storage,
    _scan_latest_checkpoint,
    _TrialRunner,
)

from .result_grid import ResultGrid
from .schedulers import CONTINUE, FIFOScheduler, TrialScheduler
from .search import expand_grid, sample_space


@dataclass
class TuneConfig:
    metric: Optional[str] = None
    mode: str = "min"
    num_samples: int = 1
    scheduler: Optional[TrialScheduler] = None
    max_concurrent_trials: Optional[int] = None
    time_budget_s: Optional[float] = None
    seed: Optional[int] = None
    reuse_actors: bool = False  # accepted for parity; actors are per-trial


def _deep_merge(base: Dict[str, Any], over: Dict[str, Any]) -> Dict[str, Any]:
    out = dict(base)
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


class Tuner:
    def __init__(
        self,
        trainable,
        *,
        param_space: Optional[Dict[str, Any]] = None,
        tune_config: Optional[TuneConfig] = None,
        run_config: Optional[RunConfig] = None,
    ):
        if isinstance(trainable, BaseTrainer):
            self._trainer = trainable
        elif callable(trainable):
            # function trainable: config -> session.report(...) calls
            self._trainer = TorchTrainer(trainable)
        else:
            raise TypeError("trainable must be a Trainer or a callable")
        self.param_space = param_space or {}
        self.tune_config = tune_config or TuneConfig()
        self.run_config = run_config or self._trainer.run_config

    # -- config sampling ----------------------------------------------------
    def _sample_trial_configs(self) -> List[Dict[str, Any]]:
        """grid_search axes are exhaustive; num_samples multiplies the grid
        (Ray semantics: every grid point runs num_samples times)."""
        tc = self.tune_config
        rng = np.random.default_rng(tc.seed)
        subspaces = expand_grid(self.param_space)
        return [
            sample_space(space, rng)
            for _ in range(tc.num_samples)
            for space in subspaces
        ]

    def _trial_config(self, sampled: Dict[str, Any]) -> Dict[str, Any]:
        """Merge a sampled point over the trainer's base config.  The
        reference nests tuned keys under ``trainer_init_config``
        (Model_finetuning…ipynb:cc-57) or ``train_loop_config`` — both
        flatten into the top-level trial config the training fn reads."""
        base = dict(self._trainer._train_loop_config())
        sampled = copy.deepcopy(sampled)
        for alias in ("trainer_init_config", "train_loop_config"):
            if isinstance(sampled.get(alias), dict):
                base = _deep_merge(base, sampled.pop(alias))
        return _deep_merge(base, sampled)

    # -- fit ----------------------------------------------------------------
    def fit(self) -> ResultGrid:
        sc = self._trainer.scaling_config
        # a trainer whose function runs on several ranks runs them as worker
        # actors on the trial's own lease
        ranks = self._trainer._num_ranks()
        tpu_air_torch.init()
        from tpu_air_torch.core.runtime import get_runtime

        store = get_runtime().store
        # the runner's lease: fit()'s rule
        chips = self._trainer._runner_chips()
        tc = self.tune_config
        # schedulers accumulate rung/stop state per sweep; a second fit() (or
        # a scheduler shared across Tuners) must not judge trials against a
        # previous sweep's records
        scheduler = tc.scheduler or FIFOScheduler()
        scheduler.reset()
        if tc.metric:
            scheduler.set_metric(tc.metric, tc.mode)

        name = self.run_config.name or f"Tuner_{int(time.time())}_{os.urandom(3).hex()}"
        exp_dir = os.path.join(
            self.run_config.storage_path or _default_storage(), name
        )
        os.makedirs(exp_dir, exist_ok=True)

        datasets = self._trainer._preprocess()
        cc = self.run_config.checkpoint_config
        training_fn = self._trainer._training_fn()

        sampled = self._sample_trial_configs()
        n = len(sampled)
        # cap concurrency so trial actors don't exhaust host RAM even when
        # cards are plentiful; the lease queue enforces the card limit
        max_conc = tc.max_concurrent_trials or n

        max_failures = self.run_config.failure_config.max_failures

        trials: List[Dict[str, Any]] = []
        for i, s in enumerate(sampled):
            tid = f"{name}_trial_{i:05d}"
            cfg = self._trial_config(s)
            cfg["_preprocessor"] = self._trainer.preprocessor
            cfg["_scaling_config"] = sc
            # the named device, or None: the runner resolves it to its lease
            cfg["_device"] = self._trainer._named_device
            if self._trainer.resume_from_checkpoint is not None:
                resume = self._trainer.resume_from_checkpoint
                cfg["resume_from_checkpoint"] = (
                    resume.to_directory() if isinstance(resume, Checkpoint) else resume
                )
            trials.append({
                "id": tid, "config": cfg, "sampled": s,
                "dir": os.path.join(exp_dir, tid),
                "runner": None, "future": None, "next_report": 1,
                "attempt": 0, "start": None,
            })

        launched = 0
        running: List[Dict[str, Any]] = []
        results: List[Optional[Result]] = [None] * n
        t0 = time.time()

        def budget_left() -> bool:
            return not (tc.time_budget_s and time.time() - t0 > tc.time_budget_s)

        def launch(tr):
            os.makedirs(tr["dir"], exist_ok=True)
            runner = _TrialRunner.options(num_chips=chips or None, num_cpus=0).remote()
            tr["runner"] = runner
            tr["start"] = time.time()
            tr["future"] = runner.run.remote(
                training_fn, tr["config"], tr["dir"], datasets, cc,
                sc.num_workers, tr["id"], ranks, self._trainer._devices_per_rank(),
            )
            running.append(tr)

        def drain_reports(tr):
            """Feed streamed reports to the scheduler; ack each decision (the
            trial blocks on the ack so prunes land before the next round) and
            plant the async stop marker as a backstop."""
            while True:
                seq = tr["next_report"]
                key = f"{tr['id']}-report-{seq}"
                if not store.contains(key):
                    return
                rec = store.get(key)
                store.delete(key)
                tr["next_report"] += 1
                go = scheduler.on_result(tr["id"], rec) == CONTINUE
                if not go and not store.contains(f"{tr['id']}-stop"):
                    store.put(True, f"{tr['id']}-stop")
                store.put(go, f"{tr['id']}-ack-{seq}")

        def drop_stream(tr):
            """Delete the trial's stop marker, any reports that streamed after
            the last drain and any acks its (now dead) runner never read."""
            store.delete(f"{tr['id']}-stop")
            while store.contains(f"{tr['id']}-report-{tr['next_report']}"):
                store.delete(f"{tr['id']}-report-{tr['next_report']}")
                tr["next_report"] += 1
            for i in range(1, tr["next_report"]):
                store.delete(f"{tr['id']}-ack-{i}")

        def finalize(tr, out, err):
            idx = trials.index(tr)
            scheduler.on_trial_complete(tr["id"])
            results[idx] = self._trainer._assemble(
                out, tr["dir"], tr["config"],
                RuntimeError(err) if err else None,
            )
            tpu_air_torch.kill(tr["runner"])
            drop_stream(tr)

        def complete(tr):
            """Trial future resolved: finalize, or retry per FailureConfig
            from the attempt's latest checkpoint (the newest one on disk when
            the runner crashed)."""
            running.remove(tr)
            try:
                out = tpu_air_torch.get(tr["future"])
                err = out.get("error")
                if out.get("stopped"):
                    err = None  # scheduler prune is a clean exit
            except tpu_air_torch.RemoteError as e:
                out = {"history": [], "checkpoints": [], "best_checkpoint": None,
                       "latest_checkpoint": _scan_latest_checkpoint(tr["dir"])}
                err = str(e)
            drain_reports(tr)
            if err is not None and tr["attempt"] < max_failures and budget_left():
                tr["attempt"] += 1
                tpu_air_torch.kill(tr["runner"])
                # reset per-attempt stream state so the retried attempt's
                # report-1.. stream is drained from its start
                drop_stream(tr)
                tr["next_report"] = 1
                latest = out.get("latest_checkpoint")
                if latest:
                    tr["config"]["resume_from_checkpoint"] = latest[0]
                launch(tr)
                return
            finalize(tr, out, err)

        while launched < n and len(running) < max_conc and budget_left():
            launch(trials[launched])
            launched += 1

        while running:
            futures = [tr["future"] for tr in running]
            # short slot: trials block on per-report acks, so drain latency
            # is training latency
            ready, _ = tpu_air_torch.wait(futures, num_returns=1, timeout=0.05)
            for tr in list(running):
                drain_reports(tr)
                if tr["future"] in ready:
                    complete(tr)
            if not budget_left():
                # budget exhausted: stop running trials at their next report,
                # launch nothing further (unlaunched trials are dropped)
                for tr in running:
                    if not store.contains(f"{tr['id']}-stop"):
                        store.put(True, f"{tr['id']}-stop")
            while launched < n and len(running) < max_conc and budget_left():
                launch(trials[launched])
                launched += 1

        return ResultGrid([r for r in results if r is not None],
                          metric=tc.metric, mode=tc.mode)
