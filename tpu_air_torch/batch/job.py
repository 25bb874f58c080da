"""The elastic offline batch-inference lane, copied from
``tpu_air/batch/job.py`` over the port's runtime and serve plane.

A :class:`BatchJob` streams every row of a :class:`tpu_air_torch.data.Dataset`
through an already-deployed serve route — the SAME engines, admission
controller, journal, and preemption watcher the interactive lane uses —
at ``best_effort`` priority, so offline throughput soaks whatever the
online SLO leaves on the table and never competes with it:

* **One admission path.**  Every row is admitted through the route's
  :class:`~tpu_air_torch.serve.admission.AdmissionController` exactly like an
  HTTP client; under interactive pressure the controller sheds
  ``best_effort`` first and the runner backs off.  There is no second
  queue to tune and no way for batch to starve interactive.
* **Checkpointable sharded readers** (:mod:`tpu_air_torch.batch.reader`):
  deterministic ``(seed, cursor)``-addressed row streams.  Outputs land
  in the object store as immutable chunk objects with DETERMINISTIC ids,
  cursors are journaled as checkpoint objects, and the commit order is
  chunk-then-checkpoint — so a driver killed at ANY point resumes with
  zero dropped and zero duplicated rows: an already-present chunk id is
  skipped, an absent one is recomputed from the same row stream.
* **Elastic chip borrowing.**  When the route is idle (admission gauges
  low, autoscaler idle-ticking, free chips in the pool) the runner
  borrows a replica via ``scale_up`` and widens its in-flight window;
  when interactive load returns it hands the replica back THROUGH the
  preemption path (``borrow_return`` delivers a lease revocation notice;
  the :class:`~tpu_air_torch.serve.supervisor.PreemptionWatcher` drains and
  migrates in-flight streams, skipping the autoscaler backfill because
  the capacity is leaving on purpose).
* **Observability.**  Work is billed to airwatch tenant
  ``batch:<job_id>`` (CostLedger splits batch vs interactive
  chip-seconds), progress gauges surface on ``/-/stats`` → ``batch`` /
  the dashboard's ``/api/batch`` / ``tpu_air_batch_*`` prometheus
  families, and each run emits a ``batch.job`` → ``batch.chunk`` span
  tree.

This is the serve-lane complement to
:class:`tpu_air_torch.predict.BatchPredictor`, which owns its own actor pool
and chips; see that module's docstring for the boundary.

Chaos: the runner exposes the ``batch.runner`` fault site at every
chunk-commit boundary — a ``kill`` spec raises :class:`BatchJobKilled`
after the chunk object is durable but before the cursor checkpoint, the
hardest resume case (tests/test_torch_batch.py proves exactly-once across
it).
"""

from __future__ import annotations

import json
import threading
import time
import uuid
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from tpu_air_torch.batch.reader import ShardCursor, ShardedReader
from tpu_air_torch.core.runtime import RemoteError, TpuAirError, get_runtime
from tpu_air_torch.faults import plan as _faults
from tpu_air_torch.faults.retry import Backoff
from tpu_air_torch.observability import tracing as _tracing
from tpu_air_torch.observability import watch as _watch
from tpu_air_torch.serve.admission import AdmissionShedError
from tpu_air_torch.serve.deployment import NoLiveReplicasError, ReplicaGoneError
from tpu_air_torch.serve.supervisor import journaled_poll


class BatchJobKilled(TpuAirError):
    """The job driver died mid-epoch (chaos ``batch.runner`` kill spec).

    Raised at a chunk-commit boundary to simulate driver preemption; a
    fresh :class:`BatchJob` with the same ``job_id`` resumes from the
    journaled cursors and committed chunks."""


@dataclass
class BatchJobConfig:
    """Knobs for one batch job.  The determinism fingerprint — ``seed``,
    ``num_shards``, ``chunk_rows``, ``input_column`` — is frozen into the
    first checkpoint; a resume with different values is refused rather
    than silently re-sharding mid-epoch."""

    route_prefix: str = "/"
    input_column: str = "prompt"
    max_new_tokens: int = 16
    #: admission class for every row; ``best_effort`` is the point of the
    #: lane (shed first under pressure) but ``batch`` is accepted too
    priority: str = "best_effort"
    num_shards: int = 2
    seed: int = 0
    #: rows per commit unit — one object-store chunk + fault-site hit
    chunk_rows: int = 32
    #: base in-flight window (driver worker threads); widened by borrowing
    window: int = 8
    checkpoint_every_chunks: int = 1
    row_timeout_s: float = 120.0
    submit_timeout_s: float = 60.0
    poll_interval_s: float = 0.01
    shed_backoff_s: float = 0.05
    shed_backoff_cap_s: float = 1.0
    # -- elastic chip borrowing ------------------------------------------
    borrow: bool = False
    #: autoscaler idle ticks required before soaking (skipped when the
    #: route runs without an autoscaler — the depth gate still applies)
    borrow_idle_ticks: int = 3
    #: queue depth per replica at/below which the route counts as a trough
    borrow_depth_low: float = 0.5
    #: depth at/above which borrowed capacity is handed back immediately
    borrow_depth_high: float = 2.0
    borrow_max_replicas: int = 1
    borrow_notice_s: float = 5.0
    borrow_spawn_timeout_s: float = 120.0


class BatchJob:
    """One resumable batch-inference job over a dataset.

    ``run()`` drives the whole epoch and returns :meth:`stats`; outputs
    are keyed by GLOBAL row index via :meth:`results`.  Re-running the
    same ``job_id`` after a crash resumes; re-running after completion is
    a no-op that re-reads the committed chunks.

    ``row_fn`` swaps the engine round-trip for a local function
    ``prompt -> tokens`` — the checkpoint/chunk machinery is identical,
    which is how the unit tests prove resume exactness without a serve
    stack.

    Thread model: ``run()`` is single-driver; ``_process_chunk`` fans the
    chunk's rows over ``window`` worker threads.  ``self._lock`` is the
    ONLY lock this class takes (no ordering to invert) and nothing
    blocking runs under it.
    """

    def __init__(self, dataset, job_id: Optional[str] = None,
                 config: Optional[BatchJobConfig] = None, *,
                 row_fn: Optional[Callable[[List[int]], Sequence[int]]] = None):
        self.dataset = dataset
        self.job_id = str(job_id) if job_id else f"job-{uuid.uuid4().hex[:8]}"
        self.cfg = config or BatchJobConfig()
        if self.cfg.priority not in ("batch", "best_effort"):
            raise ValueError(
                "batch lane priority must be 'batch' or 'best_effort', got "
                f"{self.cfg.priority!r} — interactive is the lane it yields to")
        self.tenant = f"batch:{self.job_id}"
        self._row_fn = row_fn
        self._lock = threading.Lock()
        # -- all fields below are guarded by _lock ------------------------
        self._state = "created"
        self._started = 0.0
        self._elapsed = 0.0
        self.rows_total = 0
        self.rows_processed = 0   # actually ran through the engine THIS run
        self.rows_resumed = 0     # skipped: committed by a previous run
        self.chunks_done = 0
        self.chunks_resumed = 0
        self.checkpoints = 0
        self.resumes = 0          # 1 when this run started from a checkpoint
        self.inflight = 0
        self.shed_retries = 0
        self.submit_retries = 0
        self.borrows = 0
        self.borrow_returns = 0
        self._borrowed: set = set()   # replica tags currently on loan to us
        self._window_live = int(self.cfg.window)
        self._next_ckpt_seq = 0

    # -- deterministic object-store addressing ---------------------------
    def _chunk_id(self, shard: int, chunk: int) -> str:
        return f"airbatch-{self.job_id}-s{shard:03d}-c{chunk:06d}"

    def _ckpt_id(self, seq: int) -> str:
        return f"airbatch-{self.job_id}-ckpt-{seq:06d}"

    def _fingerprint(self, counts: Sequence[int]) -> Dict[str, Any]:
        return {
            "seed": int(self.cfg.seed),
            "num_shards": int(self.cfg.num_shards),
            "chunk_rows": int(self.cfg.chunk_rows),
            "input_column": str(self.cfg.input_column),
            "counts": [int(c) for c in counts],
        }

    # -- public API ------------------------------------------------------
    def run(self) -> Dict[str, Any]:
        """Drive the epoch to completion (or resume it), returning
        :meth:`stats`.  Raises :class:`BatchJobKilled` when a chaos plan
        kills the driver — rerun to resume."""
        register_job(self)
        with self._lock:
            self._state = "running"
            self._started = time.monotonic()
        ctl = None
        if self._row_fn is None:
            from tpu_air_torch.serve.proxy import route_control
            ctl = route_control(self.cfg.route_prefix)
        try:
            self._run_inner(ctl)
            # graceful end-of-epoch: hand back any loan BEFORE the final
            # snapshot so the returned stats show nothing outstanding
            self._return_all_borrowed(ctl)
            with self._lock:
                self._state = "done"
                self._elapsed = time.monotonic() - self._started
            return self.stats()
        except BaseException:  # noqa: BLE001 — state bookkeeping only, re-raised unchanged
            with self._lock:
                self._state = "failed"
                self._elapsed = time.monotonic() - self._started
            raise
        finally:
            # never strand borrowed chips, even on a crash path — the
            # interactive lane gets its capacity back through the same
            # drain it would see on a graceful return
            self._return_all_borrowed(ctl)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            elapsed = (self._elapsed if self._state in ("done", "failed")
                       else (time.monotonic() - self._started
                             if self._started else 0.0))
            return {
                "job_id": self.job_id,
                "tenant": self.tenant,
                "state": self._state,
                "priority": self.cfg.priority,
                "rows_total": self.rows_total,
                "rows_processed": self.rows_processed,
                "rows_resumed": self.rows_resumed,
                "rows_done": self.rows_processed + self.rows_resumed,
                "rows_per_s": (self.rows_processed / elapsed
                               if elapsed > 0 else 0.0),
                "chunks_done": self.chunks_done,
                "chunks_resumed": self.chunks_resumed,
                "checkpoints": self.checkpoints,
                "resumes": self.resumes,
                "inflight": self.inflight,
                "window": self._window_live,
                "borrowed_replicas": len(self._borrowed),
                "borrows": self.borrows,
                "borrow_returns": self.borrow_returns,
                "shed_retries": self.shed_retries,
                "submit_retries": self.submit_retries,
                "elapsed_s": elapsed,
            }

    def results(self) -> Dict[int, List[int]]:
        """Union of every committed chunk, keyed by global row index.
        Complete exactly when the job has finished one epoch."""
        store = get_runtime().store
        counts = [int(c) for c in self.dataset._row_counts()]
        out: Dict[int, List[int]] = {}
        for s in range(self.cfg.num_shards):
            total = ShardedReader(self.dataset, s, self.cfg.num_shards,
                                  self.cfg.seed, counts=counts).total_rows()
            nchunks = (total + self.cfg.chunk_rows - 1) // self.cfg.chunk_rows
            for c in range(nchunks):
                cid = self._chunk_id(s, c)
                if not store.contains(cid):
                    continue
                for gi, toks in store.get(cid)["rows"].items():
                    out[int(gi)] = list(toks)
        return out

    # -- the epoch loop --------------------------------------------------
    def _run_inner(self, ctl: Optional[Dict[str, Any]]) -> None:
        cfg = self.cfg
        store = get_runtime().store
        counts = [int(c) for c in self.dataset._row_counts()]
        readers = [ShardedReader(self.dataset, s, cfg.num_shards, cfg.seed,
                                 counts=counts)
                   for s in range(cfg.num_shards)]
        totals = [r.total_rows() for r in readers]
        cursors = self._load_cursors(store, counts)
        with self._lock:
            self.rows_total = sum(totals)
            resumed = self.resumes
        # per-shard live row iterator + its stream position, so sequential
        # chunks don't refetch the block (rebuilt whenever a resume skip
        # moves the cursor away from the iterator)
        iters: List[Tuple[Optional[Any], int]] = [(None, -1)] * cfg.num_shards
        chunks_since_ckpt = 0
        with _tracing.span("batch.job", attrs={
                "job_id": self.job_id, "tenant": self.tenant,
                "rows": sum(totals), "num_shards": cfg.num_shards,
                "seed": cfg.seed, "resumed": resumed}):
            while any(cursors[s].rows_done < totals[s]
                      for s in range(cfg.num_shards)):
                for s in range(cfg.num_shards):
                    done = cursors[s].rows_done
                    if done >= totals[s]:
                        continue
                    chunk = done // cfg.chunk_rows
                    n = min(cfg.chunk_rows, totals[s] - done)
                    cid = self._chunk_id(s, chunk)
                    if store.contains(cid):
                        # committed by a previous incarnation (possibly
                        # AFTER its last checkpoint): skip, never re-emit
                        cursors[s].rows_done = done + n
                        with self._lock:
                            self.chunks_resumed += 1
                            self.rows_resumed += n
                    else:
                        if ctl is not None:
                            self._maybe_borrow(ctl)
                        items = self._take(readers, iters, s, done, n)
                        with _tracing.span("batch.chunk", attrs={
                                "job_id": self.job_id, "shard": s,
                                "chunk": chunk, "rows": n}):
                            outputs = self._process_chunk(items, ctl)
                        # aircrash: data batch-chunk
                        store.put({"job_id": self.job_id, "shard": s,
                                   "chunk": chunk, "rows": outputs},
                                  object_id=cid)
                        cursors[s].rows_done = done + n
                        with self._lock:
                            self.chunks_done += 1
                    # chaos hook at the commit boundary: the chunk object
                    # is durable, the cursor checkpoint is not — a kill
                    # here is the hardest resume case (the chunk must be
                    # SKIPPED next run, not recomputed and double-emitted)
                    if _faults.enabled():
                        spec = _faults.perturb("batch.runner",
                                               key=self.job_id)
                        if spec is not None and spec.action == "kill":
                            raise BatchJobKilled(
                                f"fault plan killed batch driver {self.job_id}"
                                f" at shard {s} chunk {chunk}")
                    chunks_since_ckpt += 1
                    if chunks_since_ckpt >= cfg.checkpoint_every_chunks:
                        self._write_checkpoint(store, counts, cursors)
                        chunks_since_ckpt = 0
            self._write_checkpoint(store, counts, cursors)

    def _take(self, readers, iters, s: int, start: int,
              n: int) -> List[Tuple[int, Dict[str, Any]]]:
        it, pos = iters[s]
        if it is None or pos != start:
            it = readers[s].rows(start)
            pos = start
        out = []
        for _ in range(n):
            out.append(next(it))
            pos += 1
        iters[s] = (it, pos)
        return out

    # -- checkpoints -----------------------------------------------------
    def _load_cursors(self, store, counts) -> List[ShardCursor]:
        latest = None
        seq = 0
        while store.contains(self._ckpt_id(seq)):
            latest = store.get(self._ckpt_id(seq))
            seq += 1
        self._next_ckpt_seq = seq
        if latest is None:
            return [ShardCursor(shard=s) for s in range(self.cfg.num_shards)]
        if latest.get("fingerprint") != self._fingerprint(counts):
            raise ValueError(
                f"batch job {self.job_id!r} checkpoint was written with a "
                "different (seed, num_shards, chunk_rows, input_column, "
                "dataset) — resuming would re-shard mid-epoch and break "
                "exactly-once; use a fresh job_id")
        cursors = [ShardCursor.from_dict(d) for d in latest["cursors"]]
        with self._lock:
            self.resumes = 1
            # rows behind the checkpointed cursors were committed by a
            # previous incarnation; chunks committed AFTER the checkpoint
            # add to this via the contains-skip path in the loop
            self.rows_resumed += sum(c.rows_done for c in cursors)
        w = _watch.current()
        if w is not None:
            w.note("batch.resume", job=self.job_id,
                   rows_done=sum(c.rows_done for c in cursors))
        return cursors

    def _write_checkpoint(self, store, counts,
                          cursors: List[ShardCursor]) -> None:
        # aircrash: commits batch-chunk
        store.put({
            "job_id": self.job_id,
            "seq": self._next_ckpt_seq,
            "fingerprint": self._fingerprint(counts),
            "cursors": [c.to_dict() for c in cursors],
        }, object_id=self._ckpt_id(self._next_ckpt_seq))
        self._next_ckpt_seq += 1
        with self._lock:
            self.checkpoints += 1

    # -- chunk fan-out ---------------------------------------------------
    def _process_chunk(self, items, ctl) -> Dict[int, List[int]]:
        with self._lock:
            window = self._window_live
        nthreads = max(1, min(window, len(items)))
        outputs: Dict[int, List[int]] = {}
        failures: List[BaseException] = []
        next_idx = [0]

        def worker() -> None:
            while True:
                with self._lock:
                    if failures or next_idx[0] >= len(items):
                        return
                    gi, row = items[next_idx[0]]
                    next_idx[0] += 1
                    self.inflight += 1
                try:
                    toks = self._run_row(gi, row, ctl)
                except BaseException as e:  # noqa: BLE001 — surfaced below, chunk fails atomically
                    with self._lock:
                        failures.append(e)
                        self.inflight -= 1
                    return
                with self._lock:
                    outputs[gi] = list(toks)
                    self.rows_processed += 1
                    self.inflight -= 1

        threads = [threading.Thread(target=worker, daemon=True,
                                    name=f"airbatch-{self.job_id}-w{i}")
                   for i in range(nthreads)]
        for t in threads:
            t.start()
        # a surge must preempt the loan back NOW, not at the next chunk
        # boundary — under interactive pressure best_effort rows crawl,
        # so the boundary could be many seconds out
        while True:
            alive = [t for t in threads if t.is_alive()]
            if not alive:
                break
            alive[0].join(timeout=0.25)
            self._surge_return(ctl)
        if failures:
            raise failures[0]
        return outputs

    def _surge_return(self, ctl) -> None:
        """Mid-chunk fast path of :meth:`_maybe_borrow`: hand the loan
        back (and narrow the window) the moment interactive depth climbs.
        Never borrows — loans are only taken at chunk boundaries."""
        if ctl is None:
            return
        admission = ctl.get("admission")
        if admission is None:
            return
        with self._lock:
            holding = len(self._borrowed)
        if not holding:
            return
        depth = float(admission.gauges().get("depth_per_replica") or 0.0)
        if depth < self.cfg.borrow_depth_high:
            return
        with self._lock:
            self._window_live = max(1, self.cfg.window // 2)
        self._return_all_borrowed(ctl)

    def _run_row(self, gi: int, row: Dict[str, Any],
                 ctl: Optional[Dict[str, Any]]) -> List[int]:
        prompt = [int(t) for t in row[self.cfg.input_column]]
        if self._row_fn is not None:
            return list(self._row_fn(prompt))
        cfg = self.cfg
        handle = ctl["handle"]
        admission = ctl["admission"]
        journal = ctl["journal"]
        mnt = int(cfg.max_new_tokens)
        if admission is not None:
            clamped = admission.policy.clamp_budget(cfg.priority, mnt, None)
            if clamped is not None:
                mnt = int(clamped)
        # seeded per-row backoff: chaos runs replay the same delay sequence
        backoff = Backoff(base=cfg.shed_backoff_s, cap=cfg.shed_backoff_cap_s,
                          seed=cfg.seed * 100003 + gi)
        deadline = time.monotonic() + cfg.row_timeout_s
        body = json.dumps({"action": "submit", "prompt": prompt,
                           "max_new_tokens": mnt, "priority": cfg.priority,
                           "tenant": self.tenant}).encode()
        attempt = 0
        while True:
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"batch row {gi} gave up after {cfg.row_timeout_s:g}s of "
                    "admission/submit retries")
            try:
                if admission is not None:
                    # the ONE admission path: best_effort sheds first under
                    # interactive pressure, and we back off instead of queue
                    admission.admit(cfg.priority, tenant=self.tenant)
                result, tag = handle.call_http_sync_tagged(
                    body, timeout=cfg.submit_timeout_s)
                rid = int(result["request_id"])
                break
            except AdmissionShedError as e:
                attempt += 1
                with self._lock:
                    self.shed_retries += 1
                time.sleep(max(float(e.retry_after_s or 0.0) * 0.1,
                               backoff.next_delay(attempt)))
            except (NoLiveReplicasError, ReplicaGoneError):
                # replicas mid-respawn (e.g. right after a borrow return)
                attempt += 1
                with self._lock:
                    self.submit_retries += 1
                time.sleep(backoff.next_delay(attempt))
            except RemoteError as e:
                if not e.cause_repr.startswith(("EngineOverloadedError",
                                                "EngineDrainingError")):
                    raise
                attempt += 1
                with self._lock:
                    self.submit_retries += 1
                time.sleep(backoff.next_delay(attempt))
        # journal with an EXPLICIT budget so the stream is replayable and
        # migratable — the batch lane gets preemption recovery for free
        journal.record_submit(cfg.route_prefix, tag, rid, prompt=prompt,
                              max_new_tokens=mnt, priority=cfg.priority,
                              deadline_ms=None, tenant=self.tenant)
        cursor = 0
        toks: List[int] = []
        while True:
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"batch row {gi} stream stalled past {cfg.row_timeout_s:g}s")
            try:
                result, _ = journaled_poll(
                    journal, handle, cfg.route_prefix,
                    {"request_id": rid, "cursor": cursor}, tag,
                    timeout=cfg.submit_timeout_s)
            except (NoLiveReplicasError, ReplicaGoneError):
                # survivor mid-respawn while our pinned replica is gone —
                # the journal entry survives, so the next poll replays
                attempt += 1
                with self._lock:
                    self.submit_retries += 1
                time.sleep(backoff.next_delay(attempt))
                continue
            except RemoteError as e:
                # a pinned-replica death mid-stream replays through the
                # journal INSIDE journaled_poll; when the survivor's
                # queue is full (a returned borrow halved capacity under
                # surge) the replay submit overloads — back off and let
                # the journal retry, don't kill the epoch
                if not e.cause_repr.startswith(("EngineOverloadedError",
                                                "EngineDrainingError")):
                    raise
                attempt += 1
                with self._lock:
                    self.submit_retries += 1
                time.sleep(backoff.next_delay(attempt))
                continue
            new = list(result.get("tokens") or [])
            toks.extend(new)
            cursor += len(new)
            if result.get("done"):
                return toks
            if not new:
                time.sleep(cfg.poll_interval_s)

    # -- elastic chip borrowing ------------------------------------------
    def _maybe_borrow(self, ctl: Dict[str, Any]) -> None:
        """Between chunks (driver thread only): soak a replica when the
        route is in a trough, hand everything back the moment interactive
        depth climbs.  Window sizing rides the same gauges — wider while
        borrowing, halved under a surge we can't shed capacity for."""
        cfg = self.cfg
        admission = ctl.get("admission")
        if admission is None:
            return
        gauges = admission.gauges()
        depth = float(gauges.get("depth_per_replica") or 0.0)
        with self._lock:
            holding = len(self._borrowed)
            if holding:
                self._window_live = cfg.window * (1 + holding)
            elif depth >= cfg.borrow_depth_high:
                self._window_live = max(1, cfg.window // 2)
            else:
                self._window_live = cfg.window
        if holding and depth >= cfg.borrow_depth_high:
            # interactive is back: return the loan NOW, through the
            # drain path, before finishing the epoch on base capacity
            self._return_all_borrowed(ctl)
            return
        if not cfg.borrow or holding >= cfg.borrow_max_replicas:
            return
        if depth > cfg.borrow_depth_low:
            return
        autoscaler = ctl.get("autoscaler")
        if (autoscaler is not None and
                int(autoscaler.stats().get("idle_ticks") or 0)
                < cfg.borrow_idle_ticks):
            return
        if float(get_runtime().avail.get("chip", 0.0)) < 1.0:
            return  # no free chips: borrowing would steal, not soak
        handle = ctl["handle"]
        with handle._lock:
            before = {r._actor_id for r in handle._replicas}
        if not handle.scale_up(timeout=cfg.borrow_spawn_timeout_s):
            return
        with handle._lock:
            new = {r._actor_id for r in handle._replicas} - before
        with self._lock:
            self._borrowed.update(new)
            self.borrows += len(new)
            self._window_live = cfg.window * (1 + len(self._borrowed))
        w = _watch.current()
        if w is not None:
            for tag in new:
                w.note("batch.borrow", job=self.job_id, replica=tag)

    def _return_all_borrowed(self, ctl: Optional[Dict[str, Any]]) -> None:
        if ctl is None:
            return
        with self._lock:
            tags = list(self._borrowed)
            self._borrowed.clear()
            self._window_live = self.cfg.window
        if not tags:
            return
        from tpu_air_torch.core import api as core_api

        handle = ctl["handle"]
        watcher = ctl.get("watcher")
        for tag in tags:
            # the loan raised the deployment's replica target by one;
            # lower it back or the restart controller respawns the
            # replica we are about to drain away
            handle.shrink_target()
            if watcher is not None:
                # flag FIRST so the watcher never mistakes this voluntary
                # return for a real preemption (no autoscaler backfill)
                watcher.mark_borrowed(tag)
            with handle._lock:
                replica = next((r for r in handle._replicas
                                if r._actor_id == tag), None)
            if replica is not None:
                try:
                    core_api.get(replica.handle.remote(
                        "borrow_return", (self.cfg.borrow_notice_s,), {}),
                        timeout=30.0)
                except Exception:  # noqa: BLE001 — a replica that died on loan is already returned
                    pass
            with self._lock:
                self.borrow_returns += 1
            w = _watch.current()
            if w is not None:
                w.note("batch.borrow_return", job=self.job_id, replica=tag)


# -- job registry (observability surface) ---------------------------------
# jobs stay registered after completion so /api/batch and the prometheus
# families can show terminal state; a re-run of the same job_id replaces
# its entry (latest incarnation wins)
_registry_lock = threading.Lock()
_registry: Dict[str, BatchJob] = {}


def register_job(job: BatchJob) -> None:
    with _registry_lock:
        _registry[job.job_id] = job


def get_job(job_id: str) -> Optional[BatchJob]:
    with _registry_lock:
        return _registry.get(str(job_id))


def jobs_stats() -> Dict[str, Dict[str, Any]]:
    """Snapshot of every registered job's :meth:`BatchJob.stats` — the
    payload behind ``/-/stats`` → ``batch``, the dashboard's
    ``/api/batch``, and the ``tpu_air_batch_*`` prometheus families."""
    with _registry_lock:
        jobs = list(_registry.values())
    return {j.job_id: j.stats() for j in jobs}


def clear_registry() -> None:
    """Test hook: forget completed jobs between cases."""
    with _registry_lock:
        _registry.clear()
