"""Trainers: ``fit()`` with retries from the latest checkpoint (the port's
counterpart of ``tpu_air/train/trainer.py``).

An attempt runs one of two ways:

* On this host, ``BaseTrainer.fit()`` calls ``tpu_air_torch.init()`` (a
  runtime already running is reused; one that ``fit()`` starts for itself
  is stopped when it returns) and runs every attempt in a
  :class:`_TrialRunner`, an actor of the port's runtime that leases
  ``ScalingConfig.total_chips`` chip slots, as the JAX package's
  ``_run_actor_attempts`` does (``_runner_chips()``, a Tune trial's rule
  too), none on the CPU (``device="cpu"``, ``use_gpu=False``, or a
  trainer that uses no card).  A training function given no device takes
  ``cuda:<first leased id>`` there.  With ``ScalingConfig(num_workers=N >
  1)`` the runner runs the attempt on N rank actors placed on its own
  lease (``parallel/distributed.py::run_actor_workers``), joined in one
  ``torch.distributed`` group, whose rank 0 reports and checkpoints.  A
  rank runs over its ``num_chips_per_worker`` devices (a tensor-parallel
  mesh, in-worker data replicas), except that ``LMTrainer``'s
  sequence-parallel step starts one rank a device: ``_num_ranks()`` and
  ``_devices_per_rank()``.  A runner that dies outright fails its attempt
  with the ``RemoteError``; the retry resumes from the newest checkpoint on
  disk (``_scan_latest_checkpoint``).  The runner is killed after each
  attempt, and its lease returns once its processes, its ranks' among
  them, have exited.
* Tune runs each attempt of a trial in a :class:`_TrialRunner` the same
  way.  Each report streams to the driver through the object store and the
  scheduler's decision comes back the same way; on a trial of several
  ranks rank 0 asks and every rank takes its answer at that report
  (``_shared_decision``), so all stop together; a stopped trial ends with
  ``StopTrial``, which is a clean stop, not an error.

* Across hosts: with an active cluster (``parallel/distributed.py``'s
  ``spawn_local_cluster`` or ``set_active_cluster``) and a lease larger
  than a host, ``fit()`` leases the devices from the runtime of host 0 in
  whole hosts and runs each attempt on every host of the lease through the
  cluster's agent plane (``_run_spmd_multihost``, the JAX package's): each
  host is one controller over its local share of the lease, a worker of
  ``len(hosts)`` workers, its data replicas' gradients summed over a
  group of one rank a host that lives only for the attempt.  The lease's
  first host keeps the real session; the others' run directories are
  thrown away.  A revoked lease stops every host at the same report and
  shrinks the data-parallel width (an elastic preemption, budgeted apart
  from ``max_failures``); once the lease fits one host, the remaining
  attempts run on this host as above.

The attempt loop: an attempt whose training function raises (on any rank)
is retried, up to ``FailureConfig.max_failures`` times, resuming from the
newest checkpoint that attempt retained.  A ``preprocessor`` is fitted on
the train dataset and applied to every dataset before the first attempt.
"""

from __future__ import annotations

import os
import time
import traceback
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

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
    """A pandas-backed dataset: the dataset type the port's trainers take,
    and what carries the datasets to every host of a multi-host attempt
    (every host iterates the same rows in the same order).  Covers the
    surface the train loops use: ``iter_batches`` / ``count`` /
    ``to_pandas``."""

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


def _touch(path: str) -> None:
    try:
        with open(path, "w") as f:
            f.write("revoked")
    except OSError:
        pass


def _stage_resume(path: str, run_dir: str, n: int) -> str:
    """The checkpoint a multi-host attempt resumes from, out of the way of
    that attempt's session: a checkpoint this run retained is renamed
    ``resume_<n>_<name>``, because the new session's first report retains
    into ``checkpoint_000001`` again (each session counts from 1) while
    the other hosts may still be reading the one they resume from."""
    name = os.path.basename(os.path.normpath(path))
    if not name.startswith("checkpoint_") or \
            os.path.dirname(os.path.abspath(path)) != os.path.abspath(run_dir):
        return path
    staged = os.path.join(run_dir, f"resume_{n}_{name}")
    os.rename(path, staged)
    return staged


def _shrunk_scaling(sc: ScalingConfig, chips_per_host: int) -> Optional[ScalingConfig]:
    """The next smaller legal lease shape after a preemption: halve the
    data-parallel degree (the model and sequence axes must survive intact:
    a tensor-parallel model cannot lose devices) until the total is a
    legal lease shape (whole-host multiples above one host).  None at one
    worker: the run cannot shrink further and waits for the same shape."""
    import dataclasses

    workers = sc.num_workers
    while workers > 1:
        workers //= 2
        total = workers * sc.num_chips_per_worker
        if total <= chips_per_host or total % chips_per_host == 0:
            return dataclasses.replace(sc, num_workers=workers)
    return None


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
               world_rank: int = 0, decision_cb=None,
               local_rank: Optional[int] = None) -> Dict[str, Any]:
    """One attempt in this process (one rank of it with several workers or
    hosts): the body of the JAX package's ``_TrialRunner.run``.  A
    ``StopTrial`` from the scheduler ends it clean (``"stopped": True``)."""
    session = Session(run_dir=run_dir, checkpoint_config=checkpoint_config,
                      datasets=datasets, config=config, world_size=world_size,
                      world_rank=world_rank, decision_cb=decision_cb, local_rank=local_rank)
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


def _tune_decision_cb(trial_id: str):
    """The Tune driver's decision on each report of ``trial_id``, through
    the object store: stream the report, then wait briefly for the
    scheduler's ack, so that a prune lands BEFORE the next epoch spends
    compute.  If the driver is slow the trial goes on and the
    ``{trial}-stop`` marker catches it at a later report."""
    from tpu_air_torch.core import runtime as _rt

    store = _rt.current_worker().store

    def decision_cb(rec, seq):
        store.put(rec, f"{trial_id}-report-{seq}")
        try:
            ok = bool(store.get(f"{trial_id}-ack-{seq}", timeout=5.0))
            store.delete(f"{trial_id}-ack-{seq}")
            if not ok:
                return False
        except TimeoutError:
            pass
        return not store.contains(f"{trial_id}-stop")

    return decision_cb


def _shared_decision(own):
    """A worker group's decision on each report: rank 0's (``own``, None on
    the other ranks), shared over the group by a MAX all-reduce of the stop
    flag before any rank goes on, so every rank stops at the same report
    and none is left waiting in the next step's collectives."""
    from tpu_air_torch.parallel.distributed import any_rank

    def decision_cb(rec, seq):
        go = own(rec, seq) if own is not None else True
        return not any_rank(not go)

    return decision_cb


@remote
class _TrialRunner:
    """Actor hosting one attempt of a ``fit()`` or of a Tune trial on its
    chip lease.  With ``ranks > 1`` the attempt runs on a worker group of
    actors placed on that lease (``parallel/distributed.py``), whose rank 0
    reports and checkpoints."""

    def run(self, training_fn: Callable[[Dict[str, Any]], None], config: Dict[str, Any],
            run_dir: str, datasets: Dict[str, Any], checkpoint_config: CheckpointConfig,
            world_size: int, trial_id: Optional[str], ranks: int = 1,
            devices_per_rank: int = 1, threads: Optional[int] = None) -> Dict[str, Any]:
        if threads:
            # fit()'s attempt runs with its caller's torch threads
            torch.set_num_threads(threads)
        if ranks > 1:
            return _run_workers_trial(training_fn, config, run_dir, datasets,
                                      checkpoint_config, ranks,
                                      resolve_device(config.get("_device")),
                                      devices_per_rank, trial_id)
        return _run_trial(training_fn, config, run_dir, datasets, checkpoint_config,
                          world_size, decision_cb=(None if trial_id is None
                                                   else _tune_decision_cb(trial_id)))


def _worker_trial(rank: int, world_size: int, device, training_fn, config, run_dir,
                  datasets, checkpoint_config, trial_id=None) -> Dict[str, Any]:
    """One rank of an attempt, in a worker process on its own device.  In a
    Tune trial rank 0 asks the driver at every report and every rank takes
    its answer."""
    config = dict(config, _device=device)
    decision_cb = None
    if trial_id is not None:
        decision_cb = _shared_decision(_tune_decision_cb(trial_id) if rank == 0 else None)
    return _run_trial(training_fn, config, run_dir, datasets, checkpoint_config,
                      world_size, rank, decision_cb=decision_cb)


def _run_workers_trial(training_fn, config, run_dir, datasets, checkpoint_config,
                       num_workers: int, device, devices_per_rank: int = 1,
                       trial_id: Optional[str] = None) -> Dict[str, Any]:
    """One attempt over ``num_workers`` rank actors on this actor's lease:
    rank 0's record, with the errors of every rank (a rank stopped by the
    scheduler is no error)."""
    from tpu_air_torch.parallel.distributed import run_actor_workers

    outs = run_actor_workers(_worker_trial,
                             (training_fn, config, run_dir, datasets, checkpoint_config,
                              trial_id),
                             num_workers, device, chips_per_worker=devices_per_rank)
    errors = [o["error"] for o in outs if o.get("error")]
    out = dict(outs[0])
    out.setdefault("history", [])
    out.setdefault("checkpoints", [])
    out.setdefault("best_checkpoint", None)
    out.setdefault("latest_checkpoint", None)
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
    # a trainer that runs on no card (host numpy) runs on the CPU: its
    # runners lease no chip slot
    _uses_cards = True
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
        """Processes an attempt runs in: one a data-parallel worker, a
        worker group of rank actors (``parallel/distributed.py``) when
        more than one."""
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

    def _on_cpu(self) -> bool:
        """Whether the run holds no card: its device is the CPU
        (``device="cpu"``, ``use_gpu=False``), or the trainer uses none."""
        named = self._named_device
        return not self._uses_cards or (named is not None and torch.device(named).type == "cpu")

    def _runner_chips(self) -> int:
        """The chip slots an attempt's runner leases, in ``fit()`` and in a
        Tune trial alike: ``ScalingConfig.total_chips``, none on the CPU."""
        return 0 if self._on_cpu() else self.scaling_config.total_chips

    def _start_runtime(self) -> bool:
        """``tpu_air_torch.init()`` unless a runtime runs (or this is one of
        its workers); True when this call started it.  A run on the CPU
        starts one without cards; any other asks for the cards, and raises
        where there are none."""
        from tpu_air_torch.core import runtime as _rt

        if _rt.current_worker() is not None or _rt.is_initialized():
            return False
        _rt.init(num_chips=0 if self._on_cpu() else None)
        return True

    def fit(self) -> Result:
        started = self._start_runtime()
        try:
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
        finally:
            if started:
                from tpu_air_torch.core import runtime as _rt

                _rt.shutdown()

    def _run_attempts(self, config: Dict[str, Any], run_dir: str,
                      datasets: Dict[str, Any]) -> Result:
        # a lease larger than one host runs on every host it spans, through
        # the active cluster's agent plane
        from tpu_air_torch.parallel.distributed import active_cluster

        cluster = active_cluster()
        if cluster is not None and cluster.num_processes > 1:
            from tpu_air_torch.core.runtime import get_runtime

            rt = get_runtime()
            if (self.scaling_config.total_chips or 0) > rt.chips_per_host:
                return self._run_spmd_multihost(datasets, run_dir, config, cluster, rt,
                                                self.resume_from_checkpoint)
        return self._run_local_attempts(config, run_dir, datasets, self.resume_from_checkpoint)

    def _run_local_attempts(self, config: Dict[str, Any], run_dir: str,
                            datasets: Dict[str, Any], resume) -> Result:
        """The attempts on this host (also where an elastic shrink of a
        multi-host lease lands once it fits one host), each in a
        :class:`_TrialRunner` on a lease of :meth:`_runner_chips` cards, as
        the JAX package's ``_run_actor_attempts``.  A runner that dies
        outright fails its attempt with the ``RemoteError``, and the retry
        resumes from the newest checkpoint on disk."""
        import tpu_air_torch

        from tpu_air_torch.core import runtime as _rt
        from tpu_air_torch.parallel.distributed import check_slots

        rc = self.run_config
        ranks = self._num_ranks()
        chips = self._runner_chips()
        if _rt.current_worker() is None and chips:
            check_slots(ranks, self._devices_per_rank(), _rt.get_runtime().num_chips)
        # the runner resolves a device left unnamed to its own lease
        config = dict(config, _device=self._named_device)
        attempt = 0
        while True:
            if resume is not None:
                config["resume_from_checkpoint"] = (
                    resume.to_directory() if isinstance(resume, Checkpoint) else resume
                )
            runner = _TrialRunner.options(num_chips=chips or None, num_cpus=0).remote()
            try:
                out = tpu_air_torch.get(runner.run.remote(
                    self._training_fn(), config, run_dir, datasets, rc.checkpoint_config,
                    1, None, ranks, self._devices_per_rank(), torch.get_num_threads()))
                err = out["error"]
            except tpu_air_torch.RemoteError as e:   # the runner died outright
                # the crash took the session's list of checkpoints with it
                out = {"history": [], "checkpoints": [], "best_checkpoint": None,
                       "latest_checkpoint": _scan_latest_checkpoint(run_dir)}
                err = str(e)
            finally:
                tpu_air_torch.kill(runner)
            if err is None:
                return self._assemble(out, run_dir, config, None)
            latest = out.get("latest_checkpoint")
            if attempt < rc.failure_config.max_failures:
                attempt += 1
                if latest:
                    resume = Checkpoint.from_directory(latest[0])
                continue
            return self._assemble(out, run_dir, config, RuntimeError(err))

    def _run_spmd_multihost(self, datasets, run_dir, config, cluster, rt, resume) -> Result:
        """Run the training function on every host of the lease, in
        lockstep, over a driver-level lease that spans hosts.  The lease's
        first host (host 0, this process, whenever the lease holds it)
        keeps the real session (reporting, checkpoint retention); the
        others run throwaway replicas whose only output is their error.

        ``FailureConfig`` retries a training error (an exception inside the
        training function on any host) from the latest checkpoint, up to
        ``max_failures``.  Infrastructure failures (a dead host agent)
        propagate: the same dead cluster would fail every retry.

        Elastic preemption: a revoked lease, cold (``LeaseRevokedError`` at
        acquisition) or graceful (a notice mid-trial, which every host's
        session sees at the same report), is not a training failure.  The
        run re-leases at half the data-parallel width and resumes from the
        newest retained checkpoint; preemption retries are budgeted apart
        from ``max_failures``.  Once the lease fits one host, the remaining
        attempts run on this host (``_run_local_attempts``)."""
        import copy

        from tpu_air_torch.faults.plan import LeaseRevokedError

        sc = self.scaling_config
        rc = self.run_config
        max_failures = rc.failure_config.max_failures
        max_preemptions = 3
        attempt = 0
        preemptions = 0
        marker = os.path.join(run_dir, "_lease_revoked")

        def shrink_and_resume(latest):
            nonlocal sc, resume
            smaller = _shrunk_scaling(sc, rt.chips_per_host)
            if smaller is not None:
                sc = smaller
                config["_scaling_config"] = sc
            if latest:
                resume = Checkpoint.from_directory(latest[0])

        while True:
            if sc.total_chips <= rt.chips_per_host:
                local = copy.copy(self)
                local.scaling_config = sc
                return local._run_local_attempts(config, run_dir, datasets, resume)
            if resume is not None:
                resume = _stage_resume(
                    resume.to_directory() if isinstance(resume, Checkpoint) else resume,
                    run_dir, attempt + preemptions)
                config["resume_from_checkpoint"] = resume
            try:
                os.remove(marker)
            except OSError:
                pass
            try:
                lease = rt.lease_chips(sc.total_chips, timeout=300.0)
            except LeaseRevokedError:
                # cold revocation at acquisition: nothing ran, nothing is lost
                if preemptions >= max_preemptions:
                    raise
                preemptions += 1
                shrink_and_resume(_scan_latest_checkpoint(run_dir))
                continue
            # graceful preemption: the notice writes the marker (run_dir is
            # on shared storage); the hosts read it together at their next
            # report and stop at that same iteration
            lease.on_revoke(lambda notice_s, _m=marker: _touch(_m))
            try:
                out, error = self._run_spmd_leased(datasets, run_dir, config, cluster, rc, sc,
                                                   lease, rt.chips_per_host)
            finally:
                rt.release_chips(lease)
            if error is None:
                return self._assemble(out, run_dir, config, None)
            latest = out.get("latest_checkpoint")
            if (lease.revoking and "LeaseRevokedError" in str(error)
                    and preemptions < max_preemptions):
                preemptions += 1
                shrink_and_resume(latest)
                continue
            if attempt < max_failures:
                attempt += 1
                if latest:
                    resume = Checkpoint.from_directory(latest[0])
                continue
            return self._assemble(out, run_dir, config, error)

    def _run_spmd_leased(self, datasets, run_dir, config, cluster, rc, sc, lease,
                         chips_per_host: int):
        """One multi-host attempt; returns (the session host's out dict,
        error or None).  Each host of the lease runs one controller over
        its local share of it (``TPU_AIR_CHIP_IDS`` = its local slots), as
        worker ``h`` of ``len(hosts)`` workers of ``total_chips / hosts``
        devices each (the loop's ``_scaling_config``), joined by a
        :class:`~tpu_air_torch.parallel.distributed.HostGroup` for the
        length of the fit; hosts outside the lease return at once."""
        import dataclasses
        import secrets

        hosts = sorted({c // chips_per_host for c in lease})
        share = {h: [c % chips_per_host for c in lease if c // chips_per_host == h]
                 for h in hosts}
        host_config = dict(config, _scaling_config=dataclasses.replace(
            sc, num_workers=len(hosts), num_chips_per_worker=sc.total_chips // len(hosts)))
        spmd_fit = _SpmdFit(self._training_fn(), host_config,
                            {k: ds.to_pandas() for k, ds in datasets.items() if ds is not None},
                            run_dir, rc.checkpoint_config, hosts, share, secrets.token_hex(8))
        outs = cluster.run(spmd_fit)
        errors = [o["error"] for o in outs if o.get("error")]
        return outs[hosts[0]], (RuntimeError("\n---\n".join(errors)) if errors else None)

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


class _SpmdFit:
    """The thunk every host of a multi-host attempt runs (through
    ``cluster.run``): the attempt's session on this host, inside the
    lease's :class:`~tpu_air_torch.parallel.distributed.HostGroup`."""

    def __init__(self, training_fn, config, dfs, run_dir, checkpoint_config, hosts, share,
                 token):
        self.training_fn = training_fn
        self.config = config
        self.dfs = dfs
        self.run_dir = run_dir
        self.checkpoint_config = checkpoint_config
        self.hosts = hosts
        self.share = share
        self.token = token

    def __call__(self) -> Dict[str, Any]:
        import shutil
        import tempfile

        from tpu_air_torch.faults.plan import LeaseRevokedError
        from tpu_air_torch.parallel import distributed as D

        pid = D.process_index()
        if pid not in self.share:
            return {"error": None, "replica": pid}
        rank = self.hosts.index(pid)
        prev_lease = os.environ.get("TPU_AIR_CHIP_IDS")
        os.environ["TPU_AIR_CHIP_IDS"] = ",".join(str(c) for c in self.share[pid])
        rd = self.run_dir if rank == 0 else tempfile.mkdtemp(prefix="tpu_air_torch-spmd-replica-")
        marker = os.path.join(self.run_dir, "_lease_revoked")
        try:
            group = D.HostGroup(self.hosts, self.token,
                                resolve_device(self.config.get("_device")))

            def preempt_check(rec, seq):
                # the hosts read the marker together, so they stop at the
                # same report
                if group.any(os.path.exists(marker)):
                    raise LeaseRevokedError("chip lease revoked mid-trial (preemption notice)")
                return True

            with D.host_scope(group):
                out = _run_trial(self.training_fn, self.config, rd,
                                 {k: _BroadcastDataset(df) for k, df in self.dfs.items()},
                                 self.checkpoint_config, len(self.hosts), rank,
                                 decision_cb=preempt_check, local_rank=0)
                if out["error"]:
                    # the other hosts may wait in a collective for this one
                    group.close()
        finally:
            if prev_lease is None:
                os.environ.pop("TPU_AIR_CHIP_IDS", None)
            else:
                os.environ["TPU_AIR_CHIP_IDS"] = prev_lease
            if rank != 0:
                # a replica's run dir holds full checkpoint copies
                shutil.rmtree(rd, ignore_errors=True)
        if rank != 0:
            return {"error": out["error"], "replica": pid}
        return out


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
