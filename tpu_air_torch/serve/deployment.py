"""Deployment / Application / DeploymentHandle.  Copied from
``tpu_air/serve/deployment.py`` (the port imports nothing of ``tpu_air``).

A Deployment is "a managed group of Ray actors that ... handle requests
load-balanced across them" (Introduction_to_Ray_AI_Runtime.ipynb:cc-79).
``.options(name=..., num_replicas=..., route_prefix=...)`` + ``.bind(*args)``
mirror the reference call shape (cc-71).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field, replace
from typing import Any, Callable, Dict, List, Optional

from tpu_air_torch.core import api as core_api
from tpu_air_torch.core.runtime import RemoteError, TpuAirError


class NoLiveReplicasError(TpuAirError):
    """Every replica of a deployment is dead (the proxy maps this to 503)."""


class ReplicaGoneError(TpuAirError):
    """A request pinned to a specific replica (streaming poll via the
    ``x-tpu-air-replica`` header) found that replica out of rotation.  The
    proxy maps this to 503: the stream's state died with the replica, so
    the client must re-submit — rollouts drain before killing precisely so
    admitted streams never hit this."""


def _is_death(e: Exception) -> bool:
    """True when a RemoteError means the replica process died (crash /
    kill / placement failure) rather than the application code raising."""
    return isinstance(e, RemoteError) and e.cause_repr.startswith(
        ("WorkerCrashed", "ActorDiedError", "ActorPlacementFailed")
    )


def _actor_dead(replica) -> bool:
    """Liveness of a replica actor straight from the runtime's actor table —
    no ping task needed (worker death is detected on pipe close)."""
    from tpu_air_torch.core import runtime as rt_mod

    rt = rt_mod.get_runtime()
    with rt.lock:
        st = rt.actors.get(replica._actor_id)
        if st is None:
            # not in the table: dead unless its creation is still queued
            return replica._actor_id not in rt.pending_actors
        # st.worker.alive is the LISTENER's view and lags a kill by one
        # pipe-EOF detection; /-/healthz right after a replica dies must
        # not report 200, so ask the process itself
        return st.dead or not st.worker.alive or not st.worker.proc.is_alive()


@dataclass(frozen=True)
class Deployment:
    """A replicated callable class. ``func_or_class`` instances run as core
    runtime actors; each instance handles requests via ``__call__`` (or a
    named method through the handle)."""

    func_or_class: Any
    name: str = ""
    num_replicas: int = 1
    route_prefix: Optional[str] = None
    num_cpus: float = 0.0
    num_chips: float = 0.0
    # dead-replica restart budget: -1 = unlimited (default), 0 = never
    max_restarts: int = -1

    def options(
        self,
        name: Optional[str] = None,
        num_replicas: Optional[int] = None,
        route_prefix: Optional[str] = None,
        num_cpus: Optional[float] = None,
        num_chips: Optional[float] = None,
        ray_actor_options: Optional[Dict[str, Any]] = None,
        max_restarts: Optional[int] = None,
        **_ignored,
    ) -> "Deployment":
        kw: Dict[str, Any] = {}
        if name is not None:
            kw["name"] = name
        if num_replicas is not None:
            kw["num_replicas"] = num_replicas
        if route_prefix is not None:
            kw["route_prefix"] = route_prefix
        if max_restarts is not None:
            kw["max_restarts"] = max_restarts
        opts = dict(ray_actor_options or {})
        if num_cpus is not None or "num_cpus" in opts:
            kw["num_cpus"] = float(num_cpus if num_cpus is not None else opts["num_cpus"])
        if num_chips is not None or "num_chips" in opts:
            kw["num_chips"] = float(num_chips if num_chips is not None else opts["num_chips"])
        return replace(self, **kw)

    def bind(self, *args, **kwargs) -> "Application":
        return Application(self, args, kwargs)


def deployment(
    _func_or_class=None,
    *,
    name: Optional[str] = None,
    num_replicas: int = 1,
    route_prefix: Optional[str] = None,
    num_cpus: float = 0.0,
    num_chips: float = 0.0,
    max_restarts: int = -1,
    **_ignored,
):
    """``@serve.deployment`` decorator (bare or parameterized)."""

    def make(obj):
        return Deployment(
            func_or_class=obj,
            name=name or getattr(obj, "__name__", "deployment"),
            num_replicas=num_replicas,
            route_prefix=route_prefix,
            num_cpus=num_cpus,
            num_chips=num_chips,
            max_restarts=max_restarts,
        )

    if _func_or_class is not None:
        return make(_func_or_class)
    return make


@dataclass
class Application:
    """A Deployment bound to constructor args — what ``serve.run`` deploys."""

    deployment: Deployment
    init_args: tuple = ()
    init_kwargs: Dict[str, Any] = field(default_factory=dict)


class _Replica:
    """Actor body wrapping one instance of the deployment class."""

    def __init__(self, cls, init_args, init_kwargs):
        self._obj = cls(*init_args, **init_kwargs)

    def handle(self, method: Optional[str], args, kwargs):
        target = self._obj if method is None else getattr(self._obj, method)
        return target(*args, **kwargs)

    def handle_http(self, body: bytes):
        """Adapt the raw request body and invoke the deployment object."""
        from .http_adapters import json_request

        obj = self._obj
        if hasattr(obj, "handle_http"):
            return obj.handle_http(body)
        adapter = getattr(obj, "_http_adapter", None) or json_request
        return obj(adapter(body))

    def ping(self):
        return "ok"

    def drain(self):
        """Forward a drain to the wrapped object (EngineDeployment stops
        admitting; a plain deployment has nothing to drain)."""
        fn = getattr(self._obj, "drain", None)
        if callable(fn):
            fn()
        return "ok"

    def drain_status(self) -> Dict[str, Any]:
        """Whether the wrapped object finished draining.  Objects without
        the protocol are stateless per-request handlers: always drained."""
        fn = getattr(self._obj, "drain_status", None)
        if callable(fn):
            out = fn()
            if isinstance(out, dict):
                return out
        return {"draining": True, "drained": True}

    def engine_stats(self) -> Dict[str, Any]:
        """Engine-metrics snapshot from the wrapped object, when it exposes
        one (``EngineDeployment``'s ``stats``); ``{}`` for plain deployments.
        The dashboard merges these into ``/api/engines`` and ``/metrics``."""
        stats = getattr(self._obj, "stats", None)
        if not callable(stats):
            return {}
        out = stats()
        return out if isinstance(out, dict) else {}


class DeploymentHandle:
    """Least-loaded handle over a deployment's live replica actors, with
    failure semantics (reference: "a managed group of Ray actors that ...
    handle requests load-balanced across them", cc-79):

    * replica choice is LEAST-LOADED over the engine gauges the last
      ``engine_stats`` scrape recorded (queue depth + slot occupancy,
      adjusted by this handle's own in-flight call counts); when the
      scrape is stale (> ``_loads_ttl``) it falls back to round-robin;
    * a replica that died (crash or kill) is dropped from rotation as soon
      as a call to it fails or the restart controller notices;
    * synchronous calls fail over to the remaining live replicas — an
      application-level exception is NOT retried, only replica death; a
      call PINNED to one replica (streaming poll) never fails over — its
      state lived there — and raises :class:`ReplicaGoneError` instead;
    * a background controller respawns dead replicas back up to the
      handle's replica TARGET (initially ``num_replicas``; the autoscaler
      moves it via :meth:`scale_up` / :meth:`scale_down`), bounded by the
      deployment's ``max_restarts``;
    * :meth:`rollout` swaps every replica with a freshly spawned one,
      draining each old replica before killing it — in-flight streams
      keep polling the draining replica through their pin, so a deploy
      under load loses zero admitted streams;
    * when nothing is live, :class:`NoLiveReplicasError` (proxy → 503).
    """

    def __init__(self, app: Application, replicas: List[Any]):
        d = app.deployment
        self.deployment_name = d.name
        self._app = app
        self._replicas = list(replicas)  # live rotation
        self._rr = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._restarts_left = d.max_restarts  # -1 = unlimited
        self._target = d.num_replicas    # autoscaler-mutable replica target
        self._spawning = 0               # scale_up spawns in flight (not yet in rotation)
        self._draining: List[Any] = []   # out of rotation, pinned-reachable
        self._inflight: Dict[str, int] = {}  # actor id -> in-flight calls
        self._loads: Dict[str, float] = {}   # actor id -> scraped load
        self._loads_at = 0.0
        self._loads_ttl = 3.0            # stale loads → round-robin fallback
        self._controller = None
        if d.max_restarts != 0:
            import weakref

            # the thread holds only a weakref: a handle the application
            # dropped must be collectable (and its controller must exit),
            # not kept alive forever by its own controller's bound method
            self._controller = threading.Thread(
                target=_controller_main, args=(weakref.ref(self),),
                daemon=True, name=f"serve-controller-{d.name}",
            )
            self._controller.start()

    # -- replica selection ---------------------------------------------------
    def _next_replica(self, pin: Optional[str] = None):
        with self._lock:
            if pin is not None:
                # pinned (streaming poll): the stream's state lives on ONE
                # replica — in rotation or draining, never a different one
                for r in self._replicas + self._draining:
                    if r._actor_id == pin:
                        return r
                raise ReplicaGoneError(
                    f"deployment {self.deployment_name!r}: pinned replica "
                    f"{pin!r} is gone (crashed or already retired)"
                )
            if not self._replicas:
                raise NoLiveReplicasError(
                    f"deployment {self.deployment_name!r}: all replicas dead"
                )
            n = len(self._replicas)
            self._rr = (self._rr + 1) % n
            if self._loads and time.monotonic() - self._loads_at <= self._loads_ttl:
                # least-loaded: last scraped engine load plus our own
                # in-flight calls (covers load the scrape hasn't seen yet);
                # ties rotate with the round-robin cursor so equally idle
                # replicas still alternate
                rr = self._rr

                def load_key(ir):
                    i, r = ir
                    return (self._loads.get(r._actor_id, 0.0)
                            + self._inflight.get(r._actor_id, 0),
                            (i - rr) % n)

                _, best = min(enumerate(self._replicas), key=load_key)
                return best
            return self._replicas[self._rr]  # stats stale: round-robin

    def mark_dead(self, replica) -> None:
        """Drop a replica from rotation (called on observed death)."""
        with self._lock:
            self._replicas = [r for r in self._replicas if r is not replica]
            self._draining = [r for r in self._draining if r is not replica]

    def num_replicas(self) -> int:
        """Cheap rotation size (no liveness probe — used on the request
        hot path to bound failover retries)."""
        with self._lock:
            return len(self._replicas)

    def live_replicas(self) -> int:
        """Count of LIVE replicas, pruning dead ones.  Used by health/status
        endpoints so reporting is accurate even with the restart controller
        disabled (max_restarts=0) and no traffic since a replica died.  Not
        for the request path: each liveness check takes the runtime lock."""
        with self._lock:
            self._replicas = [r for r in self._replicas if not _actor_dead(r)]
            return len(self._replicas)

    def engine_stats(self, timeout: float = 10.0) -> Dict[str, Dict[str, Any]]:
        """Engine-metrics snapshots from every replica in rotation, keyed
        ``<deployment>/<replica-idx>/<engine-name>``.  Replicas without an
        engine (plain deployments, or an EngineDeployment that hasn't built
        yet) contribute nothing; a dying replica must not fail the scrape."""
        with self._lock:
            replicas = list(self._replicas)
        out: Dict[str, Dict[str, Any]] = {}
        loads: Dict[str, float] = {}
        for i, replica in enumerate(replicas):
            try:
                snap = core_api.get(replica.engine_stats.remote(),
                                    timeout=timeout)
            except Exception:  # noqa: BLE001 — scrape is best-effort
                continue
            # even an empty snap ({} — engine not built yet) is a load
            # sample: an idle replica should attract traffic
            loads[replica._actor_id] = (
                float(snap.get("queue_depth", 0))
                + float(snap.get("slot_occupancy", 0)))
            if snap:
                key = f"{self.deployment_name}/{i}/{snap.get('name', 'engine')}"
                out[key] = snap
        if loads:
            # side effect: the scrape doubles as the least-loaded routing
            # signal (_next_replica); staleness re-enables round-robin
            with self._lock:
                self._loads = loads
                self._loads_at = time.monotonic()
        return out

    # -- calls ---------------------------------------------------------------
    def remote(self, *args, **kwargs):
        """Call the replica object (``__call__``); returns an ObjectRef."""
        return self._next_replica().handle.remote(None, args, kwargs)

    def method(self, name: str) -> Callable:
        def call(*args, **kwargs):
            return self._next_replica().handle.remote(name, args, kwargs)

        return call

    def remote_http(self, body: bytes):
        """Route raw HTTP body bytes to a replica's adapter + callable."""
        return self._next_replica().handle_http.remote(body)

    def call_http_sync(self, body: bytes, timeout: float = 300.0):
        """HTTP-path call with failover: a request in flight on a replica
        that crashes is transparently retried on the next live one."""
        return self.call_http_sync_tagged(body, timeout=timeout)[0]

    def call_http_sync_tagged(self, body: bytes, timeout: float = 300.0,
                              pin: Optional[str] = None):
        """Like :meth:`call_http_sync` but returns ``(result, replica_tag)``
        so the proxy can round-trip the serving replica to the client
        (``x-tpu-air-replica``).  ``pin`` routes to that exact replica —
        required for streaming polls, whose cursor state lives on the
        replica that took the submit; a pinned call never fails over
        (:class:`ReplicaGoneError` if the replica left)."""
        # bound retries by the starting live count + respawn headroom so a
        # crash-looping deployment can't loop forever
        for _ in range(max(self.num_replicas(), 1) + 2):
            replica = self._next_replica(pin=pin)
            tag = replica._actor_id
            with self._lock:
                self._inflight[tag] = self._inflight.get(tag, 0) + 1
            try:
                return (
                    core_api.get(replica.handle_http.remote(body),
                                 timeout=timeout),
                    tag,
                )
            except RemoteError as e:
                if not _is_death(e):
                    raise  # application error: surface, don't failover
                self.mark_dead(replica)
                if pin is not None:
                    raise ReplicaGoneError(
                        f"deployment {self.deployment_name!r}: pinned "
                        f"replica {pin!r} died mid-call"
                    )
            finally:
                with self._lock:
                    left = self._inflight.get(tag, 1) - 1
                    if left <= 0:
                        self._inflight.pop(tag, None)
                    else:
                        self._inflight[tag] = left
        raise NoLiveReplicasError(
            f"deployment {self.deployment_name!r}: replicas keep dying"
        )

    # -- scaling (autoscaler entry points) -----------------------------------
    def target_replicas(self) -> int:
        """The replica count the restart controller maintains (starts at
        the deployment's ``num_replicas``; scale_up/scale_down move it)."""
        with self._lock:
            return self._target

    def scale_up(self, timeout: float = 120.0) -> bool:
        """Add one replica: a fresh actor through the runtime's normal
        placement path (process + chip lease), pinged live, then entered
        into rotation.  Returns False (and restores the target) when the
        spawn fails — the autoscaler treats that as "hold"."""
        with self._lock:
            if self._stop.is_set():
                return False
            self._target += 1
            # the restart controller must not read target-minus-live as a
            # deficit while THIS spawn is still pinging — it would spawn a
            # phantom second replica nothing ever retires
            self._spawning += 1
        replica = None
        try:
            replica = _spawn_replica(self._app)
            core_api.get(replica.ping.remote(), timeout=timeout)
            with self._lock:
                if self._stop.is_set():
                    raise NoLiveReplicasError("handle retired during scale-up")
                self._replicas.append(replica)
                self._spawning -= 1
            return True
        except Exception:  # noqa: BLE001 — failed scale-up must not leak the spawn
            with self._lock:
                self._target -= 1
                self._spawning -= 1
            if replica is not None:
                from tpu_air_torch.core.remote import kill

                try:
                    kill(replica)
                except Exception:  # noqa: BLE001 — best-effort kill; replica may already be dead
                    pass
            return False

    def shrink_target(self) -> int:
        """Lower the restart controller's replica target by one (floor 1)
        WITHOUT retiring anyone here — for callers already retiring a
        specific replica through another path (the batch lane's borrow
        return rides the preemption watcher's drain; without this the
        controller would respawn the returned replica right back).
        Returns the new target."""
        with self._lock:
            if self._target > 1:
                self._target -= 1
            return self._target

    def scale_down(self, timeout: float = 120.0) -> bool:
        """Remove one replica, gracefully: out of rotation FIRST (no new
        work routes to it; its in-flight streams keep polling it through
        their pin), then drain, then kill — which releases its process and
        chip lease.  Never drops the last replica."""
        with self._lock:
            if len(self._replicas) <= 1 or self._target <= 1:
                return False
            self._target -= 1
            victim = min(
                self._replicas,
                key=lambda r: (self._inflight.get(r._actor_id, 0)
                               + self._loads.get(r._actor_id, 0.0)),
            )
            self._replicas = [r for r in self._replicas if r is not victim]
            self._draining.append(victim)
        self._drain_and_kill(victim, timeout)
        return True

    def rollout(self, timeout: float = 120.0) -> int:
        """Zero-downtime replica swap: for every replica in rotation at
        call time, spawn-and-ping a replacement, enter it into rotation,
        pull the old one out, DRAIN it (admitted streams keep polling it
        via their pin until every token is delivered), then kill it.
        Returns the number of replicas swapped."""
        with self._lock:
            old = list(self._replicas)
        swapped = 0
        for replica in old:
            fresh = _spawn_replica(self._app)
            try:
                core_api.get(fresh.ping.remote(), timeout=timeout)
            except Exception:  # noqa: BLE001 — ANY spawn/ping failure (death, timeout, init error) must abort the rollout before the old replica is touched; re-raised below
                from tpu_air_torch.core.remote import kill

                try:
                    kill(fresh)
                except Exception:  # noqa: BLE001 — best-effort kill; replica may already be dead
                    pass
                raise  # a rollout that can't spawn must fail loudly
            with self._lock:
                self._replicas.append(fresh)
                if replica in self._replicas:
                    self._replicas.remove(replica)
                    self._draining.append(replica)
                else:
                    # crashed (or scaled away) since the snapshot: the
                    # replacement still counts, nothing left to drain
                    swapped += 1
                    continue
            self._drain_and_kill(replica, timeout)
            swapped += 1
        return swapped

    def _drain_and_kill(self, replica, timeout: float = 120.0) -> None:
        """Drain one out-of-rotation replica, wait until it reports
        ``drained`` AND this handle has zero in-flight calls on it (a
        request could have picked it just before it left rotation), then
        kill it.  The timeout bounds an abandoned stream's hold."""
        from tpu_air_torch.core.remote import kill

        tag = replica._actor_id
        try:
            core_api.get(replica.drain.remote(), timeout=30.0)
            deadline = time.monotonic() + timeout
            while time.monotonic() < deadline:
                with self._lock:
                    inflight = self._inflight.get(tag, 0)
                st = core_api.get(replica.drain_status.remote(), timeout=10.0)
                if st.get("drained") and inflight == 0:
                    break
                time.sleep(0.05)
        except Exception:  # noqa: BLE001 — a dying/dead replica can't block the drain
            pass
        try:
            kill(replica)
        except Exception:  # noqa: BLE001 — best-effort kill; replica may already be dead
            pass
        with self._lock:
            self._draining = [r for r in self._draining if r is not replica]

    # -- restart controller --------------------------------------------------
    def _control_tick(self, backoff: float) -> float:
        """One controller iteration: prune dead replicas, respawn the
        deficit vs the handle's replica TARGET (``num_replicas`` until the
        autoscaler moves it).  Returns the next crash-loop backoff."""
        with self._lock:
            live = [r for r in self._replicas if not _actor_dead(r)]
            pruned = len(self._replicas) - len(live)
            self._replicas = live
            # in-flight scale_up spawns already cover part of the target
            deficit = self._target - len(live) - self._spawning
        if pruned:
            backoff = 0.25  # fresh death: reset the crash-loop backoff
        if deficit <= 0 or self._restarts_left == 0:
            return backoff
        replica = None
        try:
            replica = _spawn_replica(self._app)
            core_api.get(replica.ping.remote(), timeout=60.0)
            with self._lock:
                if self._stop.is_set():
                    # _retire snapshotted-and-killed the rotation while we
                    # were pinging: this fresh replica must not outlive it
                    raise NoLiveReplicasError("handle retired during respawn")
                self._replicas.append(replica)
            if self._restarts_left > 0:
                self._restarts_left -= 1
            return 0.25
        except Exception:  # noqa: BLE001 — crash loop: back off, retry
            if replica is not None:
                # a replica that failed/timed-out its ping still holds a
                # worker process + lease — it must not leak per attempt
                from tpu_air_torch.core.remote import kill

                try:
                    kill(replica)
                except Exception:  # noqa: BLE001 — best-effort kill; replica may already be dead
                    pass
            self._stop.wait(backoff)
            return min(backoff * 2, 10.0)

    def stop(self):
        self._stop.set()


def _controller_main(handle_ref) -> None:
    """Controller thread body.  Re-derefs the weakref each tick so a handle
    with no other referents is GC'd and the thread exits."""
    backoff = 0.25
    while True:
        handle = handle_ref()
        if handle is None:
            return
        stop_evt = handle._stop
        del handle  # don't pin the handle across the wait
        if stop_evt.wait(0.25):
            return
        handle = handle_ref()
        if handle is None:
            return
        try:
            backoff = handle._control_tick(backoff)
        finally:
            del handle


def _spawn_replica(app: Application):
    from tpu_air_torch.core.remote import remote

    d = app.deployment
    actor_cls = remote(num_cpus=d.num_cpus, num_chips=d.num_chips)(_Replica)
    return actor_cls.remote(d.func_or_class, app.init_args, app.init_kwargs)


def start_replicas(app: Application) -> DeploymentHandle:
    """Instantiate the application's replica actors and wait until live."""
    replicas = [_spawn_replica(app) for _ in range(app.deployment.num_replicas)]
    core_api.get([r.ping.remote() for r in replicas])  # surface init errors now
    return DeploymentHandle(app, replicas)
