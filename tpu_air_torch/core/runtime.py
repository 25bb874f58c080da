"""The port's core runtime: tasks, actors, objects over host processes,
copied from ``tpu_air/core/runtime.py``.

One driver-side scheduler plus a pool of persistent worker processes:

* **tasks** — stateless remote functions (``@tpu_air_torch.remote`` on a
  function), executed on any idle worker with enough resources;
* **actors** — stateful remote classes, each pinned to a dedicated worker
  process, method calls executed FIFO;
* **objects** — immutable values in the shared-memory store
  (object_store.py); every task/actor result is sealed there and resolved
  by ``get``/``wait``.

Scheduling resources are CPUs and CUDA devices ("chips"): an actor asking
for ``num_chips=k`` receives a lease of k device ids, exported to its
process as ``TPU_AIR_CHIP_IDS`` and kept on its worker context, so that
:func:`tpu_air_torch.device.resolve_device` places its model on
``cuda:<first leased id>``.  ``num_chips`` defaults to
``torch.cuda.device_count()``.  An actor may place actors on a part of its
own lease (``options(chip_ids=[...])``, a Tune trial's worker ranks): they
claim nothing from the pool, skip its queue, die with their creator, and
the creator's claim returns to the pool only once their processes have
exited.

Workers start through a **forkserver** (default start method) whose
server has preloaded torch, numpy and pandas (worker_preload.py) and never
initializes CUDA.  The runtime never forks the driver once
``torch.cuda.is_initialized()`` is true: a forked child inherits a CUDA
context it cannot use.  ``start_method="fork"`` is honoured only until then.

``init(include_dashboard=True)`` (or ``TPU_AIR_DASHBOARD=1``) starts the
dashboard (observability/dashboard.py), and with ``TPU_AIR_POSTMORTEM_DIR``
set every worker death dumps a flight record (observability/postmortem.py),
as in the JAX package.

Chip leases are revocable, as in the JAX package: :meth:`Runtime.lease_chips`
grants a driver-level :class:`ChipLease` (a ``list`` of device ids, which
name ``cuda:<id>`` as ``resolve_device`` does), :func:`attach_chip_lease`
wraps the devices an actor was placed on, and a lease's ``on_revoke``
callbacks fire when :meth:`Runtime.revoke_lease` or the ``runtime.lease``
fault site delivers a notice (how the serve plane drains and migrates a
replica).

The control plane is on the default path, as in the JAX package: ``init()``
starts the port's C++ GCS daemon (``tpu_air_torch/_native/gcs_server.cpp``,
client in ``tpu_air_torch/control``), registers this host as node
``host-0`` with its card count and heartbeats it, publishes every placed
actor with its card ids to the actor directory and marks it dead when it is
killed or its worker dies; :meth:`Runtime.nodes` reads membership and
liveness from it.  ``TPU_AIR_GCS=<host:port>`` joins a running daemon
instead, ``TPU_AIR_NO_GCS=1`` turns the control plane off.  It is
best-effort, as there: where the daemon is not built yet it is built on a
background thread, and a missing protobuf toolchain or a dead daemon leaves
``gcs_address`` ``None`` and ``nodes()`` ``[]``, never an error.  The
object store puts what fits into the C++ shared-memory arena
(object_store.py).

Multi-host, as in the JAX package: ``init()`` joins the rendezvous first
when the ``TPU_AIR_COORDINATOR`` env contract is set
(``parallel/distributed.py``; a failed one raises), and the runtime of a
cluster's host 0 schedules the global slot pool (``TPU_AIR_NUM_CHIPS``,
``TPU_AIR_CHIPS_PER_HOST`` slots a host: slot g is local slot
g % chips_per_host of host g // chips_per_host) in lease SHAPES: a lease
of at most a host's slots lives on one host, a larger one is whole hosts,
and shape-blocked queue heads reserve the hosts they wait to recombine.
"""

from __future__ import annotations

import itertools
import os
import secrets
import sys
import tempfile
import threading
import time
import traceback
import multiprocessing as mp
import multiprocessing.connection as mpc
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from . import serialization
from .object_store import ObjectRef, ObjectStore, new_object_id

from tpu_air_torch.faults import plan as _faults
from tpu_air_torch.observability import tracing as _tracing

# --------------------------------------------------------------------------
# errors
# --------------------------------------------------------------------------


class TpuAirError(Exception):
    pass


class RemoteError(TpuAirError):
    """A task/actor method raised; carries the remote traceback and, when
    the failed call was traced, the trace id (the driver recorder's
    ``for_trace`` answers "which hop killed this request")."""

    def __init__(self, cause_repr: str, remote_traceback: str,
                 trace_id: Optional[str] = None):
        super().__init__(f"{cause_repr}\n\n--- remote traceback ---\n{remote_traceback}")
        self.cause_repr = cause_repr
        self.remote_traceback = remote_traceback
        self.trace_id = trace_id


class ActorDiedError(TpuAirError):
    pass


class ChipLease(list):
    """A granted chip lease: a ``list`` of device ids (drop-in for the plain
    ``List[int]`` callers index, join, and pass back to
    :meth:`Runtime.release_chips`) plus revocation plumbing for preemptible
    capacity.  Id ``c`` is the device ``cuda:<c>``, as
    :func:`tpu_air_torch.device.resolve_device` maps a leased actor's ids.

    Preemption arrives with *notice*: "these devices go away in N seconds",
    and a holder that drains or migrates within the window loses nothing.
    :meth:`on_revoke` registers a callback; when the lease is revoked (by
    the ``runtime.lease`` fault site's ``notice`` action or by
    :meth:`Runtime.revoke_lease`), every callback fires once with the
    advance warning in seconds, and ``notice_s`` seconds later the lease
    reports :attr:`expired`: past that point the holder must treat the
    devices as gone.

    Callbacks run on the revoker's thread and never under the handle's
    lock; a callback registered *after* the notice was delivered fires
    immediately (no lost-wakeup window between engine construction and
    watcher registration).
    """

    def __init__(self, chip_ids):
        super().__init__(chip_ids)
        self._lease_lock = threading.Lock()
        self._callbacks: List[Any] = []
        self._notice_s: Optional[float] = None
        self._expired = threading.Event()

    @property
    def chip_ids(self) -> List[int]:
        return list(self)

    @property
    def revoking(self) -> bool:
        """True once a revocation notice has been delivered."""
        with self._lease_lock:
            return self._notice_s is not None

    @property
    def notice_s(self) -> Optional[float]:
        """The advance warning the notice carried, or None if not revoked."""
        with self._lease_lock:
            return self._notice_s

    @property
    def expired(self) -> bool:
        """True once the notice window has elapsed: the devices are gone."""
        return self._expired.is_set()

    def on_revoke(self, callback) -> None:
        """Register ``callback(notice_s: float)`` to fire when this lease
        is revoked.  Fires immediately (on the caller's thread) if the
        notice already arrived."""
        with self._lease_lock:
            if self._notice_s is None:
                self._callbacks.append(callback)
                return
            notice = self._notice_s
        callback(notice)

    def deliver_notice(self, notice_s: float) -> None:
        """Deliver the revocation notice: fire callbacks with ``notice_s``
        of warning, then mark the lease expired once the window elapses.
        Idempotent: only the first delivery counts."""
        notice = max(0.0, float(notice_s))
        with self._lease_lock:
            if self._notice_s is not None:
                return
            self._notice_s = notice
            callbacks, self._callbacks = self._callbacks, []
        for cb in callbacks:
            try:
                cb(notice)
            except Exception:  # a broken callback must not mask the notice
                pass
        if notice > 0:
            t = threading.Timer(notice, self._expired.set)
            t.daemon = True
            t.start()
        else:
            self._expired.set()

    def wait_expired(self, timeout: Optional[float] = None) -> bool:
        return self._expired.wait(timeout)

    def __reduce__(self):
        # a lease crossing a process boundary degrades to its device ids:
        # the revocation plumbing (lock, timer, callbacks) means something
        # only in the process that holds the lease
        return (list, (list(self),))


class _ErrorSentinel:
    """Stored in the object store in place of a result when a task fails."""

    def __init__(self, cause_repr: str, tb: str, trace_id: Optional[str] = None):
        self.cause_repr = cause_repr
        self.tb = tb
        self.trace_id = trace_id

    def raise_(self):
        raise RemoteError(self.cause_repr, self.tb,
                          trace_id=getattr(self, "trace_id", None))


def _resolve_if_error(value):
    if isinstance(value, _ErrorSentinel):
        value.raise_()
    return value


# --------------------------------------------------------------------------
# specs / messages
# --------------------------------------------------------------------------

_INLINE_LIMIT = 512 * 1024  # payloads larger than this travel via the store


@dataclass
class _TaskSpec:
    task_id: str            # also the result object id
    payload: Optional[bytes]  # cloudpickle of (fn, args, kwargs); None if via store
    payload_ref: Optional[str]
    resources: Dict[str, float]
    kind: str = "task"      # "task" | "actor_create" | "actor_task"
    actor_id: Optional[str] = None
    method: Optional[str] = None
    from_worker: bool = False
    # airtrace carrier captured at submit time (None unless the submitting
    # thread had tracing on and an active span — the zero-cost-off default)
    trace_ctx: Optional[Dict[str, str]] = None


@dataclass
class _WorkerState:
    worker_id: int
    proc: mp.process.BaseProcess
    conn: mpc.Connection
    busy_task: Optional[str] = None
    actor_id: Optional[str] = None   # set => dedicated actor worker
    alive: bool = True


@dataclass
class _ActorState:
    actor_id: str
    worker: _WorkerState
    name: Optional[str]
    # the ids this actor claimed from the pool and returns to it
    chip_ids: List[int] = field(default_factory=list)
    resources: Dict[str, float] = field(default_factory=dict)
    dead: bool = False
    pending: int = 0
    # the ids its process runs on: its own claim, or, for an actor placed
    # on its creator's lease (``options(chip_ids=...)``), a part of that
    lease: List[int] = field(default_factory=list)
    parent: Optional[str] = None
    # actors placed on this one's lease: they die with it, and its claim
    # returns to the pool only once their processes have exited
    children: List["_ActorState"] = field(default_factory=list)


# --------------------------------------------------------------------------
# worker process
# --------------------------------------------------------------------------

_worker_ctx: Optional["_WorkerContext"] = None


class _WorkerContext:
    """Per-worker client handle back to the driver scheduler."""

    def __init__(self, conn: mpc.Connection, store: ObjectStore, worker_id: int):
        self.conn = conn
        self.store = store
        self.worker_id = worker_id
        self.send_lock = threading.Lock()
        # the device ids this process was leased (an actor with num_chips)
        self.chip_ids: List[int] = []

    def send(self, msg):
        with self.send_lock:
            self.conn.send(msg)


def current_worker() -> Optional["_WorkerContext"]:
    return _worker_ctx


def _store_result(store: ObjectStore, object_id: str, fn, args, kwargs):
    try:
        result = fn(*args, **kwargs)
        store.put(result, object_id)
        return True
    except BaseException as e:  # noqa: BLE001 - remote boundary
        store.put(
            _ErrorSentinel(repr(e), traceback.format_exc(),
                           trace_id=_tracing.current_trace_id()),
            object_id,
        )
        return False


def _send_done(worker_id: int, task_id: str) -> None:
    """Send the task-complete control message, piggybacking any spans this
    worker recorded since the last done (engine spans, nested task spans) so
    the driver's recorder sees one merged timeline.  The common untraced
    case ships the plain 3-tuple."""
    spans = _tracing.drain_if_any()
    if spans is None:
        _worker_ctx.send(("done", worker_id, task_id))
    else:
        _worker_ctx.send(("done", worker_id, task_id, spans))


def _load_payload(store: ObjectStore, spec: dict):
    blob = spec["payload"]
    if blob is None:
        blob = store.get(spec["payload_ref"])
    return serialization.loads(blob)


def _resolve_args(store: ObjectStore, args, kwargs):
    def r(v):
        return store.get(v.id) if isinstance(v, ObjectRef) else v

    args = [r(a) for a in args]
    kwargs = {k: r(v) for k, v in kwargs.items()}
    for v in itertools.chain(args, kwargs.values()):
        _resolve_if_error(v)
    return args, kwargs


def _worker_main(
    worker_id: int,
    store_root: str,
    conn: mpc.Connection,
    driver_env: Optional[Dict[str, str]] = None,
):
    global _worker_ctx
    if driver_env:
        # apply the driver's environ as of spawn time (forkserver children
        # otherwise see the env snapshot from forkserver start) — must happen
        # before CUDA initializes (CUDA_VISIBLE_DEVICES)
        for k, v in driver_env.items():
            os.environ[k] = v
        for k in list(os.environ):
            if k not in driver_env:
                os.environ.pop(k, None)
    # the tracing flag (and any installed fault plan) was read at import
    # time, which for forkserver children predates the env application
    # above — re-read both
    _tracing._sync_from_env()
    _faults._sync_from_env()
    store = ObjectStore(store_root)
    _worker_ctx = _WorkerContext(conn, store, worker_id)
    actors: Dict[str, Any] = {}
    failed_actors: Dict[str, _ErrorSentinel] = {}
    while True:
        try:
            msg = conn.recv()
        except (EOFError, OSError):
            return
        kind = msg[0]
        if kind == "shutdown":
            return
        spec = msg[1]
        if kind == "task":
            fn, args, kwargs = _load_payload(store, spec)
            try:
                args, kwargs = _resolve_args(store, args, kwargs)
            except RemoteError as e:
                store.put(_ErrorSentinel(repr(e), e.remote_traceback), spec["task_id"])
                _send_done(worker_id, spec["task_id"])
                continue
            name = getattr(fn, "__name__", None) or "task"
            with _tracing.task_span(f"task.{name}", spec.get("trace_ctx")) as sp:
                if not _store_result(store, spec["task_id"], fn, args, kwargs):
                    sp.set_status("error")
            _send_done(worker_id, spec["task_id"])
        elif kind == "actor_create":
            chip_ids = spec.get("chip_ids") or []
            _worker_ctx.chip_ids = list(chip_ids)
            if chip_ids:
                # export the lease: resolve_device() places the actor's
                # model on cuda:<first leased id>
                os.environ["TPU_AIR_CHIP_IDS"] = ",".join(str(c) for c in chip_ids)
            else:
                # a chip-LESS actor must not inherit a lease from the parent
                # env (e.g. forked mid-SPMD-fit while the driver holds the
                # cluster lease in its own environ)
                os.environ.pop("TPU_AIR_CHIP_IDS", None)
            cls, args, kwargs = _load_payload(store, spec)
            args, kwargs = _resolve_args(store, args, kwargs)
            cname = getattr(cls, "__name__", None) or "actor"
            with _tracing.task_span(f"actor.{cname}.__init__",
                                    spec.get("trace_ctx")) as sp:
                if not _store_result(store, spec["task_id"], cls, args, kwargs):
                    sp.set_status("error")
            # fetch back so a failed __init__ is visible to callers
            inst = store.get(spec["task_id"])
            if isinstance(inst, _ErrorSentinel):
                failed_actors[spec["actor_id"]] = inst
            else:
                actors[spec["actor_id"]] = inst
            _send_done(worker_id, spec["task_id"])
        elif kind == "actor_task":
            inst = actors.get(spec["actor_id"])
            _, args, kwargs = _load_payload(store, spec)
            if inst is None:
                init_err = failed_actors.get(spec["actor_id"])
                store.put(
                    init_err
                    if init_err is not None
                    else _ErrorSentinel("ActorDiedError('actor failed to initialize')", ""),
                    spec["task_id"],
                )
            else:
                try:
                    args, kwargs = _resolve_args(store, args, kwargs)
                    method = getattr(inst, spec["method"])
                except RemoteError as e:
                    store.put(_ErrorSentinel(repr(e), e.remote_traceback), spec["task_id"])
                    _send_done(worker_id, spec["task_id"])
                    continue
                name = f"actor.{type(inst).__name__}.{spec['method']}"
                with _tracing.task_span(name, spec.get("trace_ctx")) as sp:
                    if not _store_result(store, spec["task_id"], method, args, kwargs):
                        sp.set_status("error")
            _send_done(worker_id, spec["task_id"])


# --------------------------------------------------------------------------
# driver-side runtime
# --------------------------------------------------------------------------

_STALE_SESSION_AGE_S = 2 * 3600.0


def _kill_quietly(proc) -> None:
    try:
        proc.kill()
    except (OSError, ProcessLookupError):
        pass


def _sweep_stale_sessions(base: str, spill_base: str = "/var/tmp") -> None:
    """Remove store dirs leaked by killed sessions (tmpfs is RAM — leaks
    accumulate).  A dir is stale when untouched for _STALE_SESSION_AGE_S.
    ``spill_base`` is injectable for tests."""
    now = time.time()
    names = []
    for d in (base, spill_base):  # spill_base: spill dirs of killed sessions
        try:
            names += [(d, n) for n in os.listdir(d)]
        except OSError:
            pass
    for d, name in names:
        if not name.startswith(("tpu_air_torch-", "tpu_air_torch-spill-")):
            continue
        if d == spill_base and not name.startswith("tpu_air_torch-spill-"):
            continue
        path = os.path.join(d, name)
        try:
            if name.startswith("tpu_air_torch-spill-"):
                # a spill dir's mtime goes stale while its session still
                # runs (spills may all happen early) — it is reapable only
                # once the owning store root is gone.  The dir carries an
                # ``.owner`` marker naming the root's absolute path
                # (ObjectStore._ensure_spill_dir), so liveness is checked
                # against THAT path — a custom-base root named
                # tpu_air_torch-* is not mistaken for dead just because it
                # isn't under a default base.  No marker: fall back to
                # probing the default bases, and never sweep owners that
                # aren't tpu_air_torch-* (they live somewhere we can't check).
                owner_root = None
                try:
                    with open(os.path.join(path, ".owner")) as f:
                        owner_root = f.read().strip()
                except OSError:
                    pass
                if owner_root:
                    if os.path.exists(owner_root):
                        continue
                else:
                    owner = name[len("tpu_air_torch-spill-"):]
                    if not owner.startswith("tpu_air_torch-"):
                        continue
                    if any(
                        os.path.exists(os.path.join(b, owner))
                        for b in ("/dev/shm", tempfile.gettempdir())
                    ):
                        continue
            if now - os.path.getmtime(path) < _STALE_SESSION_AGE_S:
                continue
            for f in os.listdir(path):
                try:
                    os.chmod(os.path.join(path, f), 0o644)
                    os.remove(os.path.join(path, f))
                except OSError:
                    pass
            os.rmdir(path)
        except OSError:
            pass


def _cuda_initialized() -> bool:
    torch = sys.modules.get("torch")
    return torch is not None and torch.cuda.is_initialized()


class Runtime:
    """Driver-side scheduler (the raylet analog)."""

    def __init__(
        self,
        num_cpus: Optional[int] = None,
        num_chips: Optional[int] = None,
        start_method: Optional[str] = None,
        store_root: Optional[str] = None,
    ):
        from tpu_air_torch.parallel import distributed as _dist

        hosts = _dist.process_count()
        if num_chips is None and hosts > 1:
            # a multi-host cluster's global slot pool: the launcher's count,
            # else every host's cards
            num_chips = int(os.environ.get("TPU_AIR_NUM_CHIPS", "0") or 0) or None
        if num_chips is None:
            import torch

            num_chips = torch.cuda.device_count() * hosts
            if num_chips == 0:
                raise RuntimeError(
                    "tpu_air_torch.init() leases CUDA devices and none is available; "
                    "pass num_chips= explicitly to lease slots that run on the CPU "
                    "(with device='cpu' passed to the entry points)")
        self.session_id = secrets.token_hex(8)
        base = "/dev/shm" if os.path.isdir("/dev/shm") else tempfile.gettempdir()
        _sweep_stale_sessions(base)
        self.store_root = store_root or os.path.join(base, f"tpu_air_torch-{self.session_id}")
        self.store = ObjectStore(self.store_root, create=True)
        self.num_cpus = num_cpus if num_cpus is not None else max(2, os.cpu_count() or 2)
        self.num_chips = num_chips
        # Topology for lease shapes: chip g lives on host g // chips_per_host,
        # as its local slot g % chips_per_host.  One host (the default) is
        # chips_per_host == num_chips, and the shape policy is a no-op.
        cph = int(os.environ.get("TPU_AIR_CHIPS_PER_HOST", "0") or 0)
        if not 0 < cph <= num_chips:
            cph = num_chips // hosts if hosts > 1 else 0
        self.chips_per_host = cph or num_chips or 1
        self.free_chips: List[int] = list(range(self.num_chips))
        self.avail = {"cpu": float(self.num_cpus), "chip": float(self.num_chips)}
        method = start_method or os.environ.get("TPU_AIR_START_METHOD", "forkserver")
        self.mp_ctx = mp.get_context(method)
        if method == "forkserver":
            self.mp_ctx.set_forkserver_preload(["tpu_air_torch.core.worker_preload"])
        self._fs_ctx = None  # lazy preloaded forkserver (see _pick_ctx)
        self.lock = threading.RLock()
        self.workers: Dict[int, _WorkerState] = {}
        self.actors: Dict[str, _ActorState] = {}
        self.named_actors: Dict[str, str] = {}
        self.task_resources: Dict[str, Dict[str, float]] = {}
        self.task_worker: Dict[str, int] = {}
        # task_id -> trace id, for traced tasks only: lets worker-death
        # sentinels carry the trace id of the request they killed
        self.task_trace: Dict[str, str] = {}
        self.queue: List[_TaskSpec] = []
        # Actor creations wait in their own FIFO queue for resources (chip
        # leases especially) instead of spin-waiting in the caller — an
        # oversubscribed Tune sweep queues its trials rather than timing out
        # (SURVEY.md §7 hard-part 1; Model_finetuning…ipynb:cc-53-54).
        self.actor_queue: List[dict] = []
        self.pending_actors: Dict[str, dict] = {}          # queued, not yet placed
        self.pending_actor_tasks: Dict[str, List[_TaskSpec]] = {}
        # actors refused a place on their creator's lease, with the reason
        self._refused_actors: Dict[str, "_ErrorSentinel"] = {}
        # Event-driven wait(): notified whenever a result object may have
        # been sealed (task done / worker death / driver put).
        self._obj_cv = threading.Condition()
        self._next_worker_id = itertools.count()
        self._stop = threading.Event()
        self._wakeup_r, self._wakeup_w = mp.Pipe(duplex=False)
        # Worker-process spawns (forkserver first spin-up imports torch/pandas,
        # seconds) run on a dedicated placement thread so the listener thread
        # never blocks — done/submit messages from all workers must keep
        # flowing while an actor is being placed.
        self._placement_event = threading.Event()
        self._spawn_requests = 0
        self._to_spawn: List[tuple] = []  # claimed creations awaiting spawn
        self._placement_thread = threading.Thread(
            target=self._placement_loop, daemon=True
        )
        self._placement_thread.start()
        self._listener = threading.Thread(target=self._listen, daemon=True)
        self._listener.start()
        # GCS control plane on the DEFAULT path, as in the JAX package: a
        # single-host run gets the same membership / actor-directory /
        # liveness machinery as a multi-host one
        self.node_id = f"host-{os.environ.get('TPU_AIR_PROCESS_ID', '0')}"
        self.gcs_address: Optional[str] = None
        self._gcs_proc = None
        self._gcs_heartbeat = None
        self._gcs_client = None
        self._gcs_lock = threading.Lock()
        if os.environ.get("TPU_AIR_NO_GCS", "0") != "1":
            self._start_gcs()
        self._min_idle = min(2, self.num_cpus)
        for _ in range(self._min_idle):
            self._spawn_worker()

    # -- GCS control plane ---------------------------------------------------
    def _start_gcs(self):
        """Start (or join) the C++ control-plane daemon.  Best-effort: a
        missing protobuf toolchain degrades to ``gcs_address=None`` and every
        directory call becomes a no-op."""
        existing = os.environ.get("TPU_AIR_GCS")
        if existing:
            # a running cluster's daemon: join it — membership and
            # heartbeats belong to whoever started it
            self.gcs_address = existing
            return
        from tpu_air_torch import _native

        try:
            built = os.path.exists(_native.gcs_binary_path())
        except RuntimeError:  # no protoc: _launch_gcs_daemon reports it
            built = False
        if built:
            self._launch_gcs_daemon()  # binary ready: ~ms, synchronous
        else:
            # first use on a fresh checkout: protoc + g++ take seconds to
            # minutes — init() must not block on it; the control plane comes
            # up late and everything degrades gracefully until then
            threading.Thread(
                target=self._launch_gcs_daemon, daemon=True,
                name="tpu_air_torch-gcs-build",
            ).start()

    def _launch_gcs_daemon(self):
        try:
            import atexit

            from tpu_air_torch.control import HeartbeatThread, start_gcs

            proc, port = start_gcs(dead_after_ms=3000)
            if self._stop.is_set():  # runtime shut down mid-build
                proc.kill()
                return
            # airlint: disable=CC001 — build-thread publish vs shutdown
            # read: the _stop check above plus the atexit kill below close
            # the race (worst case the daemon dies at exit, not shutdown)
            self._gcs_proc = proc
            # the daemon must not outlive this process even when an
            # exception skips shutdown(): an orphan daemon holds the
            # inherited stderr pipe open, wedging any parent reading it
            atexit.register(_kill_quietly, proc)
            # airlint: disable=CC001 — best-effort control plane: readers
            # treat a not-yet-published address as None and no-op
            self.gcs_address = f"127.0.0.1:{port}"
            self._gcs("register_node", self.node_id, address="",
                      num_chips=self.num_chips)
            # airlint: disable=CC001 — shutdown may miss a heartbeat that
            # starts mid-build; the thread is daemonic and its daemon is
            # killed at exit anyway
            self._gcs_heartbeat = HeartbeatThread(
                self.gcs_address, self.node_id, interval=0.5,
                num_chips=self.num_chips,
            )
            self._gcs_heartbeat.start()
        except Exception as e:  # noqa: BLE001 — control plane is best-effort
            print(f"tpu_air_torch: gcs control plane unavailable: {e}", file=sys.stderr)
            self.gcs_address = None

    def _gcs(self, method: str, *args, **kwargs):
        """Resilient GCS RPC: reconnect on failure (the daemon may restart),
        never raise into the scheduler.  The client is shared across the
        listener/placement/driver threads — create/teardown under a lock so
        one thread can't close a socket another is about to use."""
        if self.gcs_address is None:
            return None
        with self._gcs_lock:
            try:
                if self._gcs_client is None:
                    from tpu_air_torch.control import GcsClient

                    self._gcs_client = GcsClient(self.gcs_address)
                return getattr(self._gcs_client, method)(*args, **kwargs)
            except (ConnectionError, OSError, RuntimeError):
                if self._gcs_client is not None:
                    self._gcs_client.close()
                self._gcs_client = None
                return None

    def nodes(self) -> List[Dict]:
        """Cluster membership with heartbeat liveness, from the control plane
        (``ray.nodes()`` analog).  [] when the GCS is unavailable."""
        return self._gcs("list_nodes") or []

    # -- worker management -------------------------------------------------
    def _pick_ctx(self):
        """fork is fast, but a child forked after CUDA is initialized in
        this process inherits a CUDA context it cannot use.  Once CUDA is
        initialized, a ``fork`` runtime switches to a preloaded FORKSERVER:
        the server process imports the heavy module graph once
        (worker_preload.py — torch/pandas/numpy, no CUDA) and children fork
        from it in milliseconds."""
        if self.mp_ctx.get_start_method() == "fork":
            if _cuda_initialized():
                if self._fs_ctx is None:
                    # NB: the forkserver is a process-global singleton; the
                    # preload applies to any other forkserver user in this
                    # process, and if one is already running the preload is
                    # silently skipped (workers then pay the imports — slower,
                    # still correct).  Env snapshot staleness is handled by
                    # shipping the driver's current environ with each worker
                    # (_spawn_worker) and applying it in _worker_main before
                    # any backend init.
                    ctx = mp.get_context("forkserver")
                    ctx.set_forkserver_preload(["tpu_air_torch.core.worker_preload"])
                    self._fs_ctx = ctx
                return self._fs_ctx
        return self.mp_ctx

    def _spawn_worker(self, actor_id: Optional[str] = None) -> _WorkerState:
        wid = next(self._next_worker_id)
        parent, child = mp.Pipe(duplex=True)
        # Ship the driver's CURRENT environ: forkserver children inherit the
        # env frozen at server start, so vars set since (CUDA_VISIBLE_DEVICES,
        # the tracing flag, …) must be re-applied in the worker before it
        # initializes CUDA.
        proc = self._pick_ctx().Process(
            target=_worker_main,
            args=(wid, self.store_root, child, dict(os.environ)),
            daemon=True,
            name=f"tpu_air_torch-worker-{wid}",
        )
        proc.start()
        child.close()
        ws = _WorkerState(worker_id=wid, proc=proc, conn=parent, actor_id=actor_id)
        with self.lock:
            self.workers[wid] = ws
        self._poke_listener()
        return ws

    def _poke_listener(self):
        try:
            self._wakeup_w.send(b"x")
        except OSError:
            pass

    # -- listener thread ----------------------------------------------------
    def _listen(self):
        while not self._stop.is_set():
            with self.lock:
                conns = [w.conn for w in self.workers.values() if w.alive]
                conn_owner = {id(w.conn): w for w in self.workers.values() if w.alive}
            ready = mpc.wait(conns + [self._wakeup_r], timeout=0.2)
            for conn in ready:
                if conn is self._wakeup_r:
                    try:
                        self._wakeup_r.recv()
                    except (EOFError, OSError):
                        pass
                    continue
                owner = conn_owner.get(id(conn))
                if owner is None:
                    continue
                try:
                    msg = conn.recv()
                except (EOFError, OSError):
                    self._on_worker_death(owner)
                    continue
                try:
                    self._handle_msg(owner, msg)
                except Exception:  # noqa: BLE001 - listener must survive
                    traceback.print_exc(file=sys.stderr)

    def _handle_msg(self, worker: _WorkerState, msg):
        kind = msg[0]
        if kind == "done":
            _, wid, task_id = msg[:3]
            # traced tasks piggyback their worker-side spans on the done
            # message; fold them into the driver recorder, one merged
            # timeline
            if len(msg) > 3 and msg[3]:
                _tracing.recorder().record_many(msg[3])
            with self.lock:
                res = self.task_resources.pop(task_id, None)
                self.task_worker.pop(task_id, None)
                self.task_trace.pop(task_id, None)
                if res:
                    self._release(res)
                if worker.busy_task == task_id:
                    worker.busy_task = None
                st = self.actors.get(worker.actor_id) if worker.actor_id else None
                if st:
                    st.pending = max(0, st.pending - 1)
            self._notify_objects()
            self._schedule()
        elif kind == "submit":
            spec = _TaskSpec(**msg[1])
            spec.from_worker = True
            if spec.trace_ctx:
                with self.lock:
                    self.task_trace[spec.task_id] = spec.trace_ctx["trace_id"]
            self._enqueue(spec)
        elif kind == "create_actor":
            # Non-blocking: the creation queues for resources in _schedule.
            self._create_actor(**msg[1], from_worker=True, creator=worker.actor_id)
        elif kind == "actor_call":
            spec = _TaskSpec(**msg[1])
            spec.from_worker = True
            if spec.trace_ctx:
                with self.lock:
                    self.task_trace[spec.task_id] = spec.trace_ctx["trace_id"]
            self._submit_actor_task_spec(spec)
        elif kind == "kill_actor":
            # off the listener thread: a kill waits for the process to exit,
            # and the listener must keep reading every worker's messages
            threading.Thread(target=self.kill_actor, args=(msg[1],), daemon=True,
                             name="tpu_air_torch-kill").start()

    def _on_worker_death(self, worker: _WorkerState):
        crashed_traces = []
        chip_ids: List[int] = []
        dead_actor = None
        orphaned = None
        with self.lock:
            worker.alive = False
            outstanding = [
                t for t, wid in self.task_worker.items() if wid == worker.worker_id
            ]
            for task_id in outstanding:
                self.task_worker.pop(task_id, None)
                res = self.task_resources.pop(task_id, None)
                if res:
                    self._release(res)
                if not self.store.contains(task_id):
                    trace_id = self.task_trace.pop(task_id, None)
                    if trace_id:
                        crashed_traces.append(trace_id)
                    self.store.put(  # airlint: disable=CC003 — chaos-only: the fault-plan delay inside put models the slow-disk stall this bounded error-sentinel write already risks under the lock; zero cost with no plan installed
                        _ErrorSentinel(
                            f"WorkerCrashed(worker={worker.worker_id})",
                            "worker process died while executing this task",
                            trace_id=trace_id,
                        ),
                        task_id,
                    )
            if worker.actor_id and worker.actor_id in self.actors:
                st = self.actors[worker.actor_id]
                # st.dead means kill_actor already released the claim — a
                # killed worker's pipe-close lands here too, and releasing
                # twice inflates avail until free_chips.pop underflows
                if not st.dead:
                    st.dead = True
                    dead_actor = worker.actor_id
                    if st.name:
                        self.named_actors.pop(st.name, None)
                    chip_ids = list(st.chip_ids)
                    children = self._retire_children_locked(st)
                    if children:
                        # the claim returns once the actors placed on it
                        # have exited (below, off the listener thread)
                        orphaned = (children, st.resources, st.chip_ids)
                    else:
                        # release the FULL claim (cpu + chip), exactly like
                        # kill_actor — chip avail comes back via
                        # st.resources, the physical ids via free_chips
                        self._release(st.resources)
                        self.free_chips.extend(st.chip_ids)
                    st.resources = {}
                    st.chip_ids = []
            self.workers.pop(worker.worker_id, None)
        if dead_actor:
            self._gcs("mark_actor_dead", dead_actor)
        if orphaned is not None:
            for w in orphaned[0]:
                self._gcs("mark_actor_dead", w.actor_id)
            threading.Thread(target=self._stop_then_release, args=orphaned,
                             daemon=True, name="tpu_air_torch-orphans").start()
        # flight recorder (outside the lock: dump() scrapes snapshot()/
        # engine_stats(), which re-take it); no-op unless
        # TPU_AIR_POSTMORTEM_DIR is set, and dump() never raises.  The
        # context adds the dead actor's leased card ids to the JAX
        # package's keys: the cluster snapshot is taken after their release
        from tpu_air_torch.observability import postmortem as _postmortem

        if _postmortem.enabled():
            _postmortem.dump(
                f"WorkerCrashed(worker={worker.worker_id})",
                {
                    "worker_id": worker.worker_id,
                    "pid": worker.proc.pid,
                    "actor_id": worker.actor_id,
                    "busy_task": worker.busy_task,
                    "outstanding_tasks": outstanding,
                    "trace_ids": crashed_traces,
                    "chip_ids": chip_ids,
                },
            )
        self._notify_objects()
        self._schedule()

    # -- resources ----------------------------------------------------------
    def _can_fit(self, res: Dict[str, float]) -> bool:
        return all(self.avail.get(k, 0.0) >= v for k, v in res.items())

    def _claim_chips(
        self, n: int, exclude_hosts: frozenset = frozenset()
    ) -> Optional[List[int]]:
        """Topology-aware lease allocation (the JAX package's).

        Shapes: a lease of ``n <= chips_per_host`` devices lives entirely on
        ONE host (best fit: the feasible host with the fewest free devices,
        so big leases are not starved by fragmentation); a larger lease is
        built from WHOLE free hosts (a contiguous host range preferred), so
        it is always a sub-slice rather than an arbitrary k-subset.  Returns
        None when the request does not tile the free topology right now
        (the caller keeps it queued, FIFO).  ``exclude_hosts``: hosts
        reserved for an earlier shape-blocked request in the queue (see
        ``_claim_queued_actors``); their free devices are invisible to this
        claim.  With one host this is the lowest ``n`` free ids.  Caller
        holds the lock."""
        if n == 0:
            return []
        cph = self.chips_per_host
        by_host: Dict[int, List[int]] = {}
        for c in sorted(self.free_chips):
            if c // cph not in exclude_hosts:
                by_host.setdefault(c // cph, []).append(c)
        if n <= cph:
            fitting = [h for h, f in by_host.items() if len(f) >= n]
            if not fitting:
                return None
            host = min(fitting, key=lambda h: (len(by_host[h]), h))
            ids = by_host[host][:n]
        else:
            if n % cph != 0:
                return None
            k = n // cph
            full = sorted(h for h, f in by_host.items() if len(f) == cph)
            if len(full) < k:
                return None
            # prefer a contiguous run of k hosts; fall back to any k full
            # hosts (strict contiguity could wedge a sweep forever on a
            # fragmented cluster)
            chosen = None
            for i in range(len(full) - k + 1):
                if full[i + k - 1] - full[i] == k - 1:
                    chosen = full[i : i + k]
                    break
            if chosen is None:
                chosen = full[:k]
            ids = [c for h in chosen for c in by_host[h]]
        for c in ids:
            self.free_chips.remove(c)
        return ids

    def _acquire(self, res: Dict[str, float]):
        for k, v in res.items():
            self.avail[k] = self.avail.get(k, 0.0) - v

    def _release(self, res: Dict[str, float]):
        for k, v in res.items():
            self.avail[k] = self.avail.get(k, 0.0) + v

    def _reserve_closest(self, nchips: int, reserved: set) -> None:
        """Reserve the hosts a shape-blocked request is closest to
        recombining (the whole free hosts for a multi-host span; the
        freest host for a single-host lease).  Shared by the real queue
        scan and its ``_queued_reservations`` simulation.  Caller holds
        the lock; mutates ``reserved`` in place."""
        cph = self.chips_per_host
        free_by_host: Dict[int, int] = {}
        for c in self.free_chips:
            h = c // cph
            if h not in reserved:
                free_by_host[h] = free_by_host.get(h, 0) + 1
        if nchips > cph:
            need = nchips // cph
            whole = sorted(h for h, f in free_by_host.items() if f == cph)
            if whole:
                # some whole hosts are free: reserve only those; partial
                # hosts stay for the smaller shape-blocked requests behind
                # this head to reserve for themselves
                reserved.update(whole[:need])
            else:
                # no whole host free: reserve the hosts with the most free
                # devices, the ones closest to recombining, so a stream of
                # small leases cannot keep nibbling them
                partial = sorted(free_by_host, key=lambda h: (-free_by_host[h], h))
                reserved.update(partial[:need])
        elif free_by_host:
            reserved.add(max(free_by_host, key=lambda h: (free_by_host[h], -h)))

    def _queued_reservations(self) -> set:
        """Hosts queued actor requests are entitled to, per the same FIFO
        scan ``_claim_queued_actors`` runs, simulated without claiming
        (feasible requests consume devices from a scratch copy of the free
        list; shape-blocked ones reserve recombination hosts; the scan stops
        at the first head whose count does not fit, like the real one).
        Driver-level ``lease_chips`` consults this so it can neither nibble
        capacity a shape-blocked queued request waits to recombine nor
        outrace a feasible queue head.  With one host, any queued request
        that fits and takes a device id reserves the host.  Caller holds
        the lock."""
        saved = list(self.free_chips)
        avail = dict(self.avail)
        reserved: set = set()
        try:
            for rec in self.actor_queue:
                if not all(avail.get(kk, 0.0) >= vv for kk, vv in rec["resources"].items()):
                    break
                nchips = int(rec["resources"].get("chip", 0))
                ids = self._claim_chips(nchips, frozenset(reserved))
                if ids is None:
                    self._reserve_closest(nchips, reserved)
                else:
                    for kk, vv in rec["resources"].items():
                        avail[kk] = avail.get(kk, 0.0) - vv
                    reserved.update(c // self.chips_per_host for c in ids)
        finally:
            self.free_chips = saved
        return reserved

    def lease_chips(self, n: int, timeout: Optional[float] = None) -> ChipLease:
        """Driver-level device lease (shape-aware) for work that runs on
        the driver itself rather than in an actor: the multi-host trainer
        path.  Blocks until a correctly shaped lease frees up, honouring
        the hosts reserved for queued actor requests
        (``_queued_reservations``), so driver leases cannot starve a
        shape-blocked queue head nor outrace a feasible one.  Returns a
        :class:`ChipLease` (a list of device ids carrying ``on_revoke``
        preemption plumbing).  Pair with :meth:`release_chips`."""
        self._check_satisfiable({"chip": float(n)})
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            ids = None
            with self.lock:
                if self._can_fit({"chip": float(n)}):
                    ids = self._claim_chips(n, frozenset(self._queued_reservations()))
                    if ids is not None:
                        self._acquire({"chip": float(n)})
            if ids is not None:
                lease = ChipLease(ids)
                if _faults.enabled():
                    try:
                        spec = _faults.perturb("runtime.lease", key=str(n))
                    except _faults.LeaseRevokedError:
                        # the claim must not leak: hand the devices back
                        # before surfacing the revocation
                        self.release_chips(ids)
                        raise
                    if spec is not None and spec.action == "notice":
                        # graceful preemption: grant the lease, then
                        # delay_s later deliver notice_s of warning via
                        # the handle (preemption lands mid-work, not at
                        # acquisition)
                        t = threading.Timer(
                            spec.delay_s, lease.deliver_notice,
                            args=(spec.notice_s,))
                        t.daemon = True
                        t.start()
                return lease
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"no {n}-chip lease available after {timeout}s")
            time.sleep(0.05)

    def revoke_lease(self, lease: ChipLease, notice_s: float = 0.0) -> None:
        """Programmatic preemption: deliver a revocation notice to a lease
        this runtime granted.  The holder's ``on_revoke`` callbacks fire
        with ``notice_s`` of warning; the holder still calls
        :meth:`release_chips` when its drain completes."""
        lease.deliver_notice(notice_s)

    def release_chips(self, chip_ids: List[int]) -> None:
        with self.lock:
            self._release({"chip": float(len(chip_ids))})
            self.free_chips.extend(chip_ids)
        self._schedule()

    def _check_satisfiable(self, res: Dict[str, float]):
        total = {"cpu": float(self.num_cpus), "chip": float(self.num_chips)}
        for k, v in res.items():
            if v > total.get(k, 0.0):
                raise TpuAirError(
                    f"resource request {res} exceeds cluster total {total}"
                )
        nchips = int(res.get("chip", 0))
        if nchips > self.chips_per_host and nchips % self.chips_per_host != 0:
            raise TpuAirError(
                f"chip lease of {nchips} spans hosts and must be a multiple of "
                f"chips_per_host={self.chips_per_host} (whole-host lease shapes)")

    # -- task submission -----------------------------------------------------
    def _pack_payload(self, payload_tuple) -> Tuple[Optional[bytes], Optional[str]]:
        blob = serialization.dumps(payload_tuple)
        if len(blob) <= _INLINE_LIMIT:
            return blob, None
        ref = self.store.put(blob)
        return None, ref.id

    def submit_task(self, fn, args, kwargs, resources: Dict[str, float],
                    trace_ctx: Optional[Dict[str, str]] = None) -> ObjectRef:
        if _faults.enabled():
            _faults.perturb(
                "runtime.task", key=getattr(fn, "__name__", "") or "")
        self._check_satisfiable(resources)
        task_id = new_object_id()
        payload, payload_ref = self._pack_payload((fn, args, kwargs))
        spec = _TaskSpec(task_id, payload, payload_ref, resources,
                         trace_ctx=trace_ctx)
        if trace_ctx:
            with self.lock:
                self.task_trace[task_id] = trace_ctx["trace_id"]
        self._enqueue(spec)
        return ObjectRef(task_id)

    def _enqueue(self, spec: _TaskSpec):
        with self.lock:
            self.queue.append(spec)
        self._schedule()

    def _placement_loop(self):
        """Dedicated thread for anything that spawns worker processes:
        queued-actor placement and deadlock-avoidance spawns.  Fed by
        ``_placement_event`` from ``_schedule`` (which may run on the
        listener thread and must never block on a process spawn)."""
        while not self._stop.is_set():
            self._placement_event.wait(timeout=0.2)
            if self._stop.is_set():
                return
            self._placement_event.clear()
            try:
                self._place_queued_actors()
                with self.lock:
                    n = self._spawn_requests
                    self._spawn_requests = 0
                for _ in range(n):
                    self._spawn_worker()
                if n:
                    self._schedule()  # fresh workers can take queued tasks
            except Exception:  # noqa: BLE001 - placement must survive
                traceback.print_exc(file=sys.stderr)

    def _schedule(self):
        spawn_needed = 0
        # claim actor resources FIRST (fast, synchronous) so queued tasks
        # can't outrace a queued actor lease; only the spawn is deferred
        self._claim_queued_actors()
        with self.lock:
            remaining: List[_TaskSpec] = []
            idle = [
                w
                for w in self.workers.values()
                if w.alive and w.busy_task is None and w.actor_id is None
            ]
            for spec in self.queue:
                if not idle or not self._can_fit(spec.resources):
                    remaining.append(spec)
                    continue
                worker = idle.pop()
                self._acquire(spec.resources)
                self.task_resources[spec.task_id] = spec.resources
                self.task_worker[spec.task_id] = worker.worker_id
                worker.busy_task = spec.task_id
                worker.conn.send(
                    (
                        "task",
                        {
                            "task_id": spec.task_id,
                            "payload": spec.payload,
                            "payload_ref": spec.payload_ref,
                            "trace_ctx": spec.trace_ctx,
                        },
                    )
                )
            self.queue = remaining
            stuck = [s for s in remaining if self._can_fit(s.resources)]
            if stuck and not idle:
                # Grow the pool toward num_cpus for ANY dispatchable queued
                # task: the initial pool is only min(2, num_cpus), and
                # without growth driver-submitted parallelism stays capped
                # at 2 workers regardless of num_cpus (the W9 20-parallel-
                # tasks contract needs the full width).  Workers persist
                # once spawned, so this converges after the first burst.
                pool = sum(
                    1 for w in self.workers.values()
                    if w.alive and w.actor_id is None
                )
                headroom = max(0, int(self.num_cpus) - pool)
                # Deadlock avoidance: a worker blocked on a nested task's
                # result occupies its process slot, so nested submissions
                # get fresh workers (beyond num_cpus if needed) when the
                # pool is saturated.
                nested = sum(1 for s in stuck if s.from_worker)
                # cap each spawn burst: _placement_loop re-runs _schedule
                # after the burst, so already-spawned workers start taking
                # tasks between bursts instead of idling behind a serial
                # spawn of num_cpus processes
                spawn_needed = min(len(stuck), max(headroom, nested), 4)
        if spawn_needed:
            with self.lock:
                self._spawn_requests = max(self._spawn_requests, spawn_needed)
            self._placement_event.set()

    # -- actors --------------------------------------------------------------
    def create_actor(
        self,
        cls,
        args,
        kwargs,
        resources: Dict[str, float],
        name: Optional[str] = None,
        trace_ctx: Optional[Dict[str, str]] = None,
    ) -> Tuple[str, ObjectRef]:
        actor_id = new_object_id()
        ready_id = new_object_id()
        payload, payload_ref = self._pack_payload((cls, args, kwargs))
        self._create_actor(
            actor_id=actor_id,
            ready_id=ready_id,
            payload=payload,
            payload_ref=payload_ref,
            resources=resources,
            name=name,
            trace_ctx=trace_ctx,
        )
        return actor_id, ObjectRef(ready_id)

    def _create_actor(
        self,
        actor_id: str,
        ready_id: str,
        payload,
        payload_ref,
        resources: Dict[str, float],
        name: Optional[str],
        from_worker: bool = False,
        trace_ctx: Optional[Dict[str, str]] = None,
        sublease: Optional[List[int]] = None,
        creator: Optional[str] = None,
    ):
        if sublease is not None:
            self._place_on_lease(actor_id, ready_id, payload, payload_ref, name,
                                 trace_ctx, list(sublease), creator)
            return
        try:
            self._check_satisfiable(resources)
        except TpuAirError:
            if not from_worker:
                raise
            # worker-originated creation: surface the error through the ready ref
            self.store.put(
                _ErrorSentinel(f"resource request {resources} unsatisfiable", ""),
                ready_id,
            )
            self._notify_objects()
            return
        # Actors hold their resources for their whole lifetime; creation
        # QUEUES for them (FIFO) like a task rather than spin-waiting in the
        # caller — an oversubscribed sweep waits its turn instead of timing
        # out (SURVEY.md §7 hard-part 1).
        rec = {
            "actor_id": actor_id,
            "ready_id": ready_id,
            "payload": payload,
            "payload_ref": payload_ref,
            "resources": resources,
            "name": name,
            "trace_ctx": trace_ctx,
        }
        if trace_ctx:
            with self.lock:
                self.task_trace[ready_id] = trace_ctx["trace_id"]
        with self.lock:
            self.actor_queue.append(rec)
            self.pending_actors[actor_id] = rec
        self._schedule()

    def _place_on_lease(self, actor_id, ready_id, payload, payload_ref, name,
                        trace_ctx, ids: List[int], creator: Optional[str]) -> None:
        """An actor placed on ``ids``, a part of its creating actor's own
        lease (``options(chip_ids=...)`` inside an actor): no claim on the
        pool, and no place in the FIFO queue, where it could wait behind a
        request for the very devices its creator holds.  It dies with its
        creator, whose claim returns to the pool only after this actor's
        process has exited."""
        with self.lock:
            parent = self.actors.get(creator) if creator else None
            why = None
            if parent is None or parent.dead:
                why = "only a live actor may place actors on its own lease"
            elif not set(ids) <= set(parent.lease):
                why = f"chip_ids {ids} are not a part of the creating actor's lease {parent.lease}"
            if why is None:
                rec = {"actor_id": actor_id, "ready_id": ready_id, "payload": payload,
                       "payload_ref": payload_ref, "resources": {}, "name": name,
                       "trace_ctx": trace_ctx, "parent": creator}
                self.pending_actors[actor_id] = rec
                self._to_spawn.append((rec, ids))
        if why is not None:
            sentinel = _ErrorSentinel(f"ActorPlacementFailed(actor={actor_id})", why)
            with self.lock:
                # its method calls raise the reason too
                self._refused_actors[actor_id] = sentinel
            self.store.put(sentinel, ready_id)
            self._notify_objects()
            return
        self._placement_event.set()

    def _retire_children_locked(self, st: _ActorState) -> List[_WorkerState]:
        """Mark every actor placed on ``st``'s lease (and theirs) dead and
        return their workers, for :meth:`_stop_processes`.  Caller holds
        the lock."""
        workers = []
        for child in st.children:
            workers.extend(self._retire_children_locked(child))
            workers.append(child.worker)
            if not child.dead:
                child.dead = True
                if child.name:
                    self.named_actors.pop(child.name, None)
                child.worker.alive = False
                self.workers.pop(child.worker.worker_id, None)
        st.children = []
        return workers

    @staticmethod
    def _stop_processes(workers: List[_WorkerState]) -> None:
        """Ask each worker to exit, then terminate, then kill: every process
        has exited when this returns."""
        for w in workers:
            try:
                w.conn.send(("shutdown",))
            except OSError:
                pass
        for w in workers:
            w.proc.join(timeout=2)
            if w.proc.is_alive():
                w.proc.terminate()
        for w in workers:
            w.proc.join(timeout=10)
            if w.proc.is_alive():
                _kill_quietly(w.proc)
                w.proc.join(timeout=10)

    def _stop_then_release(self, children: List[_WorkerState], resources: Dict[str, float],
                           chip_ids: List[int]) -> None:
        """A dead actor's claim, once the actors placed on it have exited."""
        self._stop_processes(children)
        with self.lock:
            self._release(resources)
            self.free_chips.extend(chip_ids)
        self._schedule()

    def _claim_queued_actors(self):
        """FAST phase, runs synchronously inside ``_schedule`` (any thread):
        claim resources for queued actor creations that now fit, FIFO with
        one carve-out.  If the head's device COUNT does not fit, later
        (smaller) requests do not jump it, so a big lease cannot be starved
        by a stream of small ones; but a head whose count fits while no
        valid lease SHAPE exists (4 devices free as 2 + 2 across hosts
        cannot serve a 4-device single-host lease) is scanned past, so
        fragmentation cannot stall unrelated work.  The skipped request
        reserves the hosts closest to its shape (``_reserve_closest``),
        which requests behind it cannot claim from; reservations are
        recomputed on every pass in FIFO order, so the moment the shape
        exists the blocked request claims first.  Because the claim
        happens before ``_schedule`` dispatches tasks, a stream of chip
        tasks cannot outrace a queued chip lease either.  The slow process
        spawn is handed to the placement thread via ``_to_spawn``."""
        claimed = False
        with self.lock:
            reserved: set = set()
            i = 0
            while i < len(self.actor_queue):
                rec = self.actor_queue[i]
                if not self._can_fit(rec["resources"]):
                    break
                nchips = int(rec["resources"].get("chip", 0))
                chip_ids = self._claim_chips(nchips, frozenset(reserved))
                if chip_ids is None:
                    # shape-blocked: reserve what it is closest to
                    # recombining, then keep scanning
                    self._reserve_closest(nchips, reserved)
                    i += 1
                    continue
                self.actor_queue.pop(i)
                self._acquire(rec["resources"])
                self._to_spawn.append((rec, chip_ids))
                claimed = True
        if claimed:
            self._placement_event.set()

    def _place_queued_actors(self):
        """SLOW phase (placement thread only): spawn a worker process for
        each claimed creation and register the actor."""
        while True:
            with self.lock:
                if not self._to_spawn:
                    return
                rec, chip_ids = self._to_spawn.pop(0)
            try:
                worker = self._spawn_worker(actor_id=rec["actor_id"])
            except Exception as e:  # noqa: BLE001 - spawn failure (EAGAIN/OOM)
                # the claim already happened — it MUST be rolled back and the
                # ready ref resolved, or callers blocked on the actor (some
                # deliberately without timeout) hang forever on a leaked lease
                with self.lock:
                    if not rec.get("parent"):
                        self._release(rec["resources"])
                        self.free_chips.extend(chip_ids)
                    self.pending_actors.pop(rec["actor_id"], None)
                    buffered = self.pending_actor_tasks.pop(rec["actor_id"], [])
                sentinel = _ErrorSentinel(
                    f"ActorPlacementFailed(actor={rec['actor_id']})",
                    f"worker spawn failed: {type(e).__name__}: {e}",
                )
                # resolve the ready ref AND every method call buffered while
                # the actor was queued — a caller blocked (often without
                # timeout) on a buffered call must not hang forever
                for tid in [rec["ready_id"]] + [s.task_id for s in buffered]:
                    self.store.put(sentinel, tid)
                self._notify_objects()
                continue
            orphan: List[str] = []
            with self.lock:
                parent_id = rec.get("parent")
                parent = self.actors.get(parent_id) if parent_id else None
                if parent_id and (parent is None or parent.dead) and not rec.get("cancelled"):
                    # its creator died while this actor was being spawned:
                    # nobody is left to kill it, so it is never registered
                    rec["cancelled"] = True
                    self.pending_actors.pop(rec["actor_id"], None)
                    orphan = [rec["ready_id"]] + [
                        t.task_id for t in self.pending_actor_tasks.pop(rec["actor_id"], [])]
                if rec.get("cancelled") or self._stop.is_set():
                    # kill_actor() cancelled this creation while we were
                    # spawning (lock released around the process spawn), or
                    # the runtime is shutting down and must not register a
                    # worker after shutdown() cleared the table — undo the
                    # placement so nothing leaks (an actor on its creator's
                    # lease claimed nothing)
                    if not parent_id:
                        self._release(rec["resources"])
                        self.free_chips.extend(chip_ids)
                    worker.alive = False
                    self.workers.pop(worker.worker_id, None)
                    try:
                        worker.conn.send(("shutdown",))
                    except OSError:
                        pass
                    cancelled = True
                else:
                    cancelled = False
                    actor_id, ready_id = rec["actor_id"], rec["ready_id"]
                    st = _ActorState(actor_id, worker, rec["name"],
                                     [] if parent_id else chip_ids, rec["resources"],
                                     lease=list(chip_ids), parent=parent_id)
                    if parent is not None:
                        parent.children.append(st)
                    self.actors[actor_id] = st
            if cancelled:
                for tid in orphan:
                    self.store.put(_ErrorSentinel(f"ActorDiedError(actor={rec['actor_id']})",
                                                  "its creating actor died"), tid)
                if orphan:
                    self._notify_objects()
                continue
            with self.lock:
                if st.dead:
                    # its creator was killed in the moment the lock was free:
                    # kill_actor retired it and stops its process
                    self.pending_actors.pop(st.actor_id, None)
                    continue
                if rec["name"]:
                    self.named_actors[rec["name"]] = actor_id
                worker.busy_task = ready_id
                st.pending += 1
                self.task_resources[ready_id] = {}
                self.task_worker[ready_id] = worker.worker_id
                worker.conn.send(
                    (
                        "actor_create",
                        {
                            "task_id": ready_id,
                            "payload": rec["payload"],
                            "payload_ref": rec["payload_ref"],
                            "actor_id": actor_id,
                            "chip_ids": chip_ids,
                            "trace_ctx": rec.get("trace_ctx"),
                        },
                    )
                )
                # Flush method calls buffered while the actor was queued
                # BEFORE leaving pending state, all under the lock: a
                # concurrent direct submit must not reach the worker pipe
                # ahead of earlier buffered calls (per-caller FIFO).
                for spec in self.pending_actor_tasks.pop(actor_id, []):
                    st.pending += 1
                    self.task_resources[spec.task_id] = {}
                    self.task_worker[spec.task_id] = worker.worker_id
                    worker.conn.send(
                        (
                            "actor_task",
                            {
                                "task_id": spec.task_id,
                                "payload": spec.payload,
                                "payload_ref": spec.payload_ref,
                                "actor_id": spec.actor_id,
                                "method": spec.method,
                                "trace_ctx": spec.trace_ctx,
                            },
                        )
                    )
                self.pending_actors.pop(actor_id, None)
            # publish to the GCS actor directory (outside the lock: localhost
            # RPC, best-effort, must never stall the placement thread's lock)
            self._gcs("register_actor", actor_id, node_id=self.node_id,
                      name=rec["name"] or "", chip_ids=list(chip_ids))

    def submit_actor_task(self, actor_id, method, args, kwargs,
                          trace_ctx: Optional[Dict[str, str]] = None) -> ObjectRef:
        task_id = new_object_id()
        payload, payload_ref = self._pack_payload((None, args, kwargs))
        spec = _TaskSpec(
            task_id, payload, payload_ref, {}, kind="actor_task",
            actor_id=actor_id, method=method, trace_ctx=trace_ctx,
        )
        if trace_ctx:
            with self.lock:
                self.task_trace[task_id] = trace_ctx["trace_id"]
        self._submit_actor_task_spec(spec)
        return ObjectRef(task_id)

    def _submit_actor_task_spec(self, spec: _TaskSpec):
        with self.lock:
            if spec.actor_id in self.pending_actors:
                # actor is still queued for resources — buffer the call
                self.pending_actor_tasks.setdefault(spec.actor_id, []).append(spec)
                return
            st = self.actors.get(spec.actor_id)
            if st is None or st.dead or not st.worker.alive:
                self.store.put(  # airlint: disable=CC003 — chaos-only: the fault-plan delay inside put models the slow-disk stall this bounded error-sentinel write already risks under the lock; zero cost with no plan installed
                    self._refused_actors.get(spec.actor_id) or _ErrorSentinel(
                        f"ActorDiedError(actor={spec.actor_id})", "",
                        trace_id=(spec.trace_ctx or {}).get("trace_id"),
                    ),
                    spec.task_id,
                )
                self._notify_objects()
                return
            st.pending += 1
            self.task_resources[spec.task_id] = {}
            self.task_worker[spec.task_id] = st.worker.worker_id
            try:
                st.worker.conn.send(
                    (
                        "actor_task",
                        {
                            "task_id": spec.task_id,
                            "payload": spec.payload,
                            "payload_ref": spec.payload_ref,
                            "actor_id": spec.actor_id,
                            "method": spec.method,
                            "trace_ctx": spec.trace_ctx,
                        },
                    )
                )
            except OSError:
                # the worker died between the liveness check and the send
                # (broken pipe before the listener reaps it) — resolve the
                # call as actor death instead of leaking an OSError into
                # the caller (serve failover keys off ActorDiedError); the
                # listener's death path does the full cleanup when it lands
                st.pending -= 1
                self.task_resources.pop(spec.task_id, None)
                self.task_worker.pop(spec.task_id, None)
                self.store.put(  # airlint: disable=CC003 — chaos-only: the fault-plan delay inside put models the slow-disk stall this bounded error-sentinel write already risks under the lock; zero cost with no plan installed
                    _ErrorSentinel(
                        f"ActorDiedError(actor={spec.actor_id})",
                        "worker pipe broken at submit",
                        trace_id=(spec.trace_ctx or {}).get("trace_id"),
                    ),
                    spec.task_id,
                )
                self._notify_objects()

    def actor_pending_placement(self, actor_id: str) -> bool:
        """True while the actor's creation is still queued for resources
        (no lease claimed yet).  Once False, the actor owns its lease and
        only construction time separates it from serving calls."""
        with self.lock:
            return any(r["actor_id"] == actor_id for r in self.actor_queue)

    def crash_actor(self, actor_id: str) -> bool:
        """Hard-kill an actor's worker process with NO bookkeeping — unlike
        :meth:`kill_actor` there is no shutdown message, no join, and no
        resource release here.  The listener thread discovers the corpse via
        pipe EOF and runs the real ``_on_worker_death`` path, which is
        exactly what fault injection needs: a crash indistinguishable from
        an involuntary one.  Returns False if the actor is unknown/dead."""
        with self.lock:
            st = self.actors.get(actor_id)
            if st is None or st.dead:
                return False
            proc = st.worker.proc
        _kill_quietly(proc)
        return True

    def kill_actor(self, actor_id: str, no_restart: bool = True):
        with self.lock:
            rec = self.pending_actors.pop(actor_id, None)
            if rec is not None:
                # Still queued (or mid-placement) — cancel.  The cancelled
                # flag covers the race where _place_queued_actors already
                # popped the record and is spawning the worker: it checks the
                # flag under the lock before registering and rolls back.
                rec["cancelled"] = True
                self.actor_queue = [r for r in self.actor_queue if r["actor_id"] != actor_id]
                buffered = self.pending_actor_tasks.pop(actor_id, [])
                for tid in [rec["ready_id"]] + [s.task_id for s in buffered]:
                    self.store.put(  # airlint: disable=CC003 — chaos-only: the fault-plan delay inside put models the slow-disk stall this bounded error-sentinel write already risks under the lock; zero cost with no plan installed
                        _ErrorSentinel(f"ActorDiedError(actor={actor_id})", ""), tid
                    )
                self._notify_objects()
                return
            st = self.actors.get(actor_id)
            if st is None or st.dead:  # already released (double-kill / crash)
                return
            st.dead = True
            if st.name:
                self.named_actors.pop(st.name, None)
            resources, chips = st.resources, st.chip_ids
            st.resources = {}
            st.chip_ids = []
            children = self._retire_children_locked(st)
            if not chips and not children:
                self._release(resources)
            worker = st.worker
            worker.alive = False
            self.workers.pop(worker.worker_id, None)
        for w in [worker] + children:
            self._gcs("mark_actor_dead", w.actor_id)
        if chips or children:
            # a card's lease returns only once the process that holds its
            # CUDA context has exited, and the processes of the actors
            # placed on that lease too: the next actor placed on the card
            # must not share it with a context still being torn down
            self._stop_processes([worker] + children)
            with self.lock:
                self._release(resources)
                self.free_chips.extend(chips)
        else:
            try:
                worker.conn.send(("shutdown",))
            except OSError:
                pass
            worker.proc.join(timeout=2)
            if worker.proc.is_alive():
                worker.proc.terminate()
        self._schedule()  # freed chips/cpus may place queued actors

    # -- object plane ---------------------------------------------------------
    def _notify_objects(self):
        with self._obj_cv:
            self._obj_cv.notify_all()

    def put(self, value) -> ObjectRef:
        ref = self.store.put(value)
        self._notify_objects()
        return ref

    def get(self, ref, timeout: Optional[float] = None):
        if isinstance(ref, list):
            return [self.get(r, timeout) for r in ref]
        if not isinstance(ref, ObjectRef):
            raise TypeError(f"get() expects ObjectRef(s), got {type(ref)}")
        return _resolve_if_error(self.store.get(ref.id, timeout=timeout))

    def wait(self, refs, num_returns=1, timeout=None):
        if not isinstance(refs, list):
            raise TypeError("wait() expects a list of ObjectRefs")
        if num_returns > len(refs):
            raise ValueError("num_returns may not exceed len(refs)")
        deadline = None if timeout is None else time.monotonic() + timeout
        pending = list(refs)
        ready: List[ObjectRef] = []
        while True:
            still = []
            for r in pending:
                if self.store.contains(r.id):
                    ready.append(r)
                else:
                    still.append(r)
            pending = still
            if len(ready) >= num_returns:
                break
            if deadline is not None and time.monotonic() >= deadline:
                break
            # Event-driven: task completions / worker deaths / driver puts
            # notify _obj_cv, so the hot ray.wait load-balance loop (W7,
            # Scaling_batch_inference.ipynb:cc-115) wakes with no poll
            # latency.  The 50ms cap covers objects sealed out-of-band
            # (e.g. a worker's own store.put with no control message).
            slot = 0.05
            if deadline is not None:
                slot = min(slot, max(deadline - time.monotonic(), 0.0))
            with self._obj_cv:
                self._obj_cv.wait(timeout=slot)
        return ready, pending

    # -- lifecycle -------------------------------------------------------------
    def shutdown(self):
        self._stop.set()
        self._placement_event.set()  # wake the placement thread to exit
        self._poke_listener()
        self._listener.join(timeout=2)
        self._placement_thread.join(timeout=2)
        with self.lock:
            workers = list(self.workers.values())
            self.workers.clear()
            self.actors.clear()
        for w in workers:
            try:
                w.conn.send(("shutdown",))
            except OSError:
                pass
        for w in workers:
            w.proc.join(timeout=1)
            if w.proc.is_alive():
                w.proc.terminate()
        for w in workers:  # a worker that tears down a CUDA context takes a while
            w.proc.join(timeout=10)
            if w.proc.is_alive():
                w.proc.kill()
                w.proc.join(timeout=10)
        if self._gcs_heartbeat is not None:
            self._gcs_heartbeat.stop()
        # airlint: disable=CC001 — shutdown-time teardown: _gcs() holds
        # _gcs_lock for create/use and tolerates a concurrently closed
        # client (reconnect-or-None path), so an unlocked read is safe here
        if self._gcs_client is not None:
            self._gcs_client.close()
            self._gcs_client = None
        if self._gcs_proc is not None:
            self._gcs_proc.kill()
            self._gcs_proc.wait()
            self._gcs_proc = None
        self.store.destroy()


# --------------------------------------------------------------------------
# module-level singleton API
# --------------------------------------------------------------------------

_runtime: Optional[Runtime] = None


def init(
    num_cpus: Optional[int] = None,
    num_chips: Optional[int] = None,
    ignore_reinit_error: bool = True,
    include_dashboard: Optional[bool] = None,
    dashboard_port: int = 8265,
    **kwargs,
) -> Runtime:
    """Start the port's runtime (the ``ray.init()`` analog).  Idempotent by
    default.  ``num_chips`` defaults to the CUDA device count and must be
    given where there is none.

    ``include_dashboard=True`` starts the status service at
    127.0.0.1:<dashboard_port> (0 picks a free port) and prints the URL.
    Default off (None) to keep tests quiet; set env TPU_AIR_DASHBOARD=1 to
    default on.
    """
    global _runtime
    if _runtime is not None:
        if not ignore_reinit_error:
            raise TpuAirError("tpu_air_torch.init() called twice")
        if include_dashboard:  # honor an explicit request on reinit too
            _start_dashboard(dashboard_port)
        return _runtime
    # multi-host rendezvous first (a no-op unless the TPU_AIR_COORDINATOR
    # env contract is set); a failed one raises rather than run this host
    # alone in a run shaped for several
    from tpu_air_torch.parallel import distributed as _dist

    _dist.ensure_initialized()
    _runtime = Runtime(num_cpus=num_cpus, num_chips=num_chips, **kwargs)
    if include_dashboard is None:
        include_dashboard = os.environ.get("TPU_AIR_DASHBOARD", "0") == "1"
    if include_dashboard:
        _start_dashboard(dashboard_port)
    return _runtime


def _start_dashboard(port: int) -> None:
    try:
        from tpu_air_torch.observability import start_dashboard

        url = start_dashboard(port=port)
        print(f"tpu_air_torch dashboard: {url}")
    except OSError as e:
        print(f"tpu_air_torch dashboard failed to start: {e}")


def is_initialized() -> bool:
    return _runtime is not None


def shutdown():
    global _runtime
    if _runtime is not None:
        from tpu_air_torch.observability import stop_dashboard

        stop_dashboard()
        _runtime.shutdown()
        _runtime = None


def get_runtime() -> Runtime:
    """Return the active runtime, auto-initializing like Ray does on first
    ``.remote()`` call."""
    if _runtime is None:
        init()
    return _runtime


def attach_chip_lease(chip_ids: Optional[List[int]] = None) -> ChipLease:
    """ACTOR-side lease attachment: wrap the devices this process was
    placed on (``TPU_AIR_CHIP_IDS``, set by the worker loop at actor
    creation, or an explicit ``chip_ids``) in a :class:`ChipLease` so
    in-actor holders (the serving engine) get the same ``on_revoke``
    preemption surface as driver-side :meth:`Runtime.lease_chips` holders.
    A fractional (``num_chips < 1``) actor holds no id: its lease is empty
    and revocable all the same.

    Consults the ``runtime.lease`` fault site exactly like the driver
    path, with one difference: a cold ``revoke`` here delivers an
    immediate zero-notice revocation through the handle instead of
    raising, because the actor is already *placed* on the devices: the
    interesting failure is losing them mid-work, not failing to get
    them."""
    if chip_ids is None:
        raw = os.environ.get("TPU_AIR_CHIP_IDS", "")
        chip_ids = [int(c) for c in raw.split(",") if c.strip()]
    lease = ChipLease(chip_ids)
    if _faults.enabled():
        try:
            # keyed by the device ids so a plan's ``match`` can aim a
            # preemption at the replica holding a specific device
            spec = _faults.perturb(
                "runtime.lease",
                key="chips=" + ",".join(str(c) for c in lease),
            )
        except _faults.LeaseRevokedError:
            spec = None
            lease.deliver_notice(0.0)
        if spec is not None and spec.action == "notice":
            t = threading.Timer(spec.delay_s, lease.deliver_notice,
                                args=(spec.notice_s,))
            t.daemon = True
            t.start()
    return lease
