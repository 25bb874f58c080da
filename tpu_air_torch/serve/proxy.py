"""HTTP proxy + serve.run/shutdown, copied from ``tpu_air/serve/proxy.py``
over the port's runtime (the port imports nothing of ``tpu_air``).

Request path (SURVEY.md §3.5): client POST :8000 → proxy → route match →
SLO admission (priority class + token budget, serve/admission.py) →
least-loaded replica actor → http_adapter(body) → predictor/callable →
JSON response.  The proxy is a threaded HTTP server owned by the driver
process (the "HTTP proxy actor" of the reference, cc-71,74,79).

Serving contract under load (docs/SERVING.md §SLO-aware serving):

* new work (blocking generate, or a streaming ``{"action": "submit"}``)
  passes the route's :class:`~tpu_air_torch.serve.admission.AdmissionController`
  first — best-effort/batch queue proxy-side or shed (503 +
  ``Retry-After``) as engine queue depth climbs, interactive admits;
* streaming polls BYPASS admission (the work is already admitted) and PIN
  to the replica that took the submit via the ``x-tpu-air-replica``
  header, which the proxy round-trips on every routed response;
* replica-side backpressure (``EngineOverloadedError``) and drain refusal
  (``EngineDrainingError``) both map to 503 — retry semantics, nothing
  broken;
* every streaming submit with an explicit token budget is JOURNALED
  (serve/supervisor.py): when a pinned poll finds its replica dead, the
  proxy REPLAYS the request on a live replica with the already-streamed
  tokens as a forced prefix — the client sees a stall, never a 5xx, and
  greedy decoding keeps the stream token-identical;
* clients may send ``deadline_ms`` (a RELATIVE budget in ms) on new work;
  the proxy stamps the ABSOLUTE deadline at admission and propagates it
  end-to-end — queue expiry, re-routes and replays all respect it, and an
  exhausted budget maps to 504 + ``Retry-After``;
* ``serve.rollout(prefix)`` swaps every replica zero-downtime (drain
  before kill — pinned polls keep landing on the draining replica until
  its streams are fully delivered).

Deterministic chaos: ``serve.run(..., fault_plan=FaultPlan(...))``
installs a seeded fault plan (tpu_air_torch.faults) before replicas spawn, so
the whole serve plane — proxy hooks, replicas, prefill workers — runs the
same fault schedule for the same seed (docs/RESILIENCE.md).
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional

from tpu_air_torch.core.runtime import RemoteError
from tpu_air_torch.faults import plan as _faults
from tpu_air_torch.faults.retry import DeadlineExceededError
from tpu_air_torch.observability import tracing as _tracing

from .admission import (
    AdmissionController,
    AdmissionPolicy,
    AdmissionShedError,
    QuotaExceededError,
)
from .autoscaler import Autoscaler, AutoscalerConfig
from .deployment import (
    Application,
    DeploymentHandle,
    NoLiveReplicasError,
    ReplicaGoneError,
    start_replicas,
)
from .supervisor import PreemptionWatcher, RequestJournal, journaled_poll
from .weights import controller_stats

#: request header that pins streaming polls to the replica holding their
#: stream; the proxy sets it on every routed response
REPLICA_HEADER = "x-tpu-air-replica"


def _to_jsonable(obj: Any) -> Any:
    import numpy as np

    try:
        import pandas as pd

        if isinstance(obj, pd.DataFrame):
            return obj.to_dict(orient="records")
        if isinstance(obj, pd.Series):
            return obj.tolist()
    except ImportError:
        pass
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if isinstance(obj, dict):
        return {k: _to_jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_to_jsonable(v) for v in obj]
    return obj


class _ServeState:
    def __init__(self):
        self.routes: Dict[str, DeploymentHandle] = {}
        self.admission: Dict[str, AdmissionController] = {}
        self.autoscalers: Dict[str, Autoscaler] = {}
        self.watchers: Dict[str, PreemptionWatcher] = {}
        self.server: Optional[ThreadingHTTPServer] = None
        self.thread: Optional[threading.Thread] = None
        self.port: Optional[int] = None
        self.lock = threading.Lock()
        # in-flight streaming requests (prompt + delivered prefix) for
        # crash replay — serve/supervisor.py
        self.journal = RequestJournal()
        # metered-tenant streams holding an in-flight quota unit:
        # (prefix, pin, request_id) -> (controller, adapter_id); released
        # when a poll observes the stream's end (or its terminal error)
        self.tenant_streams: Dict[tuple, tuple] = {}

    def match(self, path: str):
        """Longest-prefix route match → ``(prefix, handle)`` (the prefix
        keys the route's admission controller/autoscaler), or None."""
        best = None
        for prefix, handle in self.routes.items():
            norm = prefix.rstrip("/") or "/"
            if path == norm or path.startswith(norm + "/") or norm == "/":
                if best is None or len(norm) > len(best[2]):
                    best = (prefix, handle, norm)
        return (best[0], best[1]) if best else None


_state = _ServeState()


class _Handler(BaseHTTPRequestHandler):
    # HTTP/1.1 keep-alive: streaming clients poll at high frequency, and a
    # connection per poll costs a proxy thread spawn each (ThreadingHTTPServer
    # is thread-per-CONNECTION) — persistent connections amortize it to one
    # thread per client.  Safe because _respond always sends Content-Length.
    # Nagle must be off or small responses on the reused socket wait out the
    # peer's delayed ACK (~40ms per poll).
    protocol_version = "HTTP/1.1"
    disable_nagle_algorithm = True

    def log_message(self, *args):  # quiet
        pass

    def _respond(self, code: int, payload: Any,
                 headers: Optional[Dict[str, str]] = None):
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, str(v))
        # surface the request's trace to the client: curl the trace id
        # straight into /api/traces?trace_id=... (docs/OBSERVABILITY.md)
        ctx = _tracing.current_context()
        if ctx is not None:
            self.send_header("traceparent", _tracing.format_traceparent(ctx))
            self.send_header("x-tpu-air-trace-id", ctx.trace_id)
        self.end_headers()
        self.wfile.write(body)

    def _dispatch(self):
        if not _tracing.enabled():
            self._dispatch_inner()
            return
        # root span per HTTP request; an inbound W3C traceparent header
        # continues the caller's trace instead of rooting a new one
        parent = _tracing.extract_traceparent(self.headers.get("traceparent"))
        with _tracing.span(
            "http.request", parent=parent,
            attrs={"path": self.path.split("?")[0],
                   "method": self.command},
        ) as sp:
            self._dispatch_inner(sp)

    def _dispatch_inner(self, sp=None):
        from urllib.parse import urlsplit

        self.path = urlsplit(self.path).path
        if self.path.rstrip("/") == "/-/routes":
            self._respond(200, {p: h.deployment_name for p, h in _state.routes.items()})
            return
        if self.path.rstrip("/") == "/-/healthz":
            # per-deployment replica health: degraded (any route with zero
            # live replicas) is a 503 so load balancers can act on it
            detail = {
                p: {"name": h.deployment_name, "live_replicas": h.live_replicas()}
                for p, h in _state.routes.items()
            }
            healthy = all(d["live_replicas"] > 0 for d in detail.values())
            self._respond(
                200 if healthy else 503,
                {"status": "ok" if healthy else "degraded", "deployments": detail},
            )
            return
        if self.path.rstrip("/") == "/-/stats":
            # serve-plane control state per route: admission outcomes and
            # gauges, autoscaler decisions (docs/OBSERVABILITY.md)
            self._respond(200, serve_control_stats())
            return
        matched = _state.match(self.path)
        if matched is None:
            self._respond(404, {"error": f"no deployment for route {self.path!r}"})
            return
        prefix, handle = matched
        length = int(self.headers.get("Content-Length") or 0)
        body = self.rfile.read(length) if length else b""
        pin = None
        # a metered tenant's in-flight quota unit taken at admit and owed
        # a release by THIS request (blocking calls release on response;
        # streaming submits hand the unit to the stream's lifetime)
        quota_hold = None
        try:
            try:
                payload = json.loads(body) if body else None
            except ValueError:
                payload = None  # non-JSON body: the replica's adapter decides
            action = payload.get("action") if isinstance(payload, dict) else None
            call_timeout = 300.0
            if isinstance(payload, dict):
                if action == "poll":
                    # already-admitted work: no admission, and the poll must
                    # land on the replica holding the stream's state
                    pin = self.headers.get(REPLICA_HEADER) or None
                    if _faults.enabled():
                        # deterministic chaos: delay this poll, or kill the
                        # pinned replica out from under it — the replay
                        # path's regression surface
                        spec = _faults.perturb("proxy.poll", key=prefix)
                        if (spec is not None and spec.action == "kill"
                                and pin):
                            from tpu_air_torch.core.runtime import get_runtime
                            get_runtime().crash_actor(pin)
                else:
                    if _faults.enabled():
                        # deterministic chaos: delay this request, or crash
                        # a serving replica at admission time — the fleet
                        # loses capacity exactly when load arrives, the
                        # step change airwatch's detector must catch
                        spec = _faults.perturb("proxy.request", key=prefix)
                        if spec is not None and spec.action == "kill":
                            with handle._lock:
                                victims = [r._actor_id
                                           for r in handle._replicas]
                            if victims:
                                from tpu_air_torch.core.runtime import get_runtime
                                get_runtime().crash_actor(victims[0])
                    dirty = False
                    controller = _state.admission.get(prefix)
                    if controller is not None:
                        priority = str(
                            payload.get("priority") or "interactive")
                        adapter_id = payload.get("adapter_id")
                        if adapter_id is not None:
                            adapter_id = str(adapter_id)
                        tenant = payload.get("tenant")
                        if tenant is not None:
                            tenant = str(tenant)
                        # raises QuotaExceededError (429) / shed (503);
                        # ``tenant`` only relabels billing attribution —
                        # quota metering stays keyed on adapter_id
                        controller.admit(priority, adapter_id=adapter_id,
                                         tenant=tenant)
                        if adapter_id is not None:
                            quota_hold = (controller, adapter_id)
                        clamped = controller.policy.clamp_budget(
                            priority, payload.get("max_new_tokens"),
                            adapter_id)
                        if clamped is not None and clamped != payload.get(
                                "max_new_tokens"):
                            payload["max_new_tokens"] = clamped
                            dirty = True
                    budget_ms = payload.get("deadline_ms")
                    if budget_ms is not None:
                        # clients send a RELATIVE budget; the proxy stamps
                        # the ABSOLUTE unix-epoch deadline at admission so
                        # every downstream hop (queue sweep, re-route,
                        # replay) measures against one clock instead of
                        # re-extending the budget per hop
                        budget_ms = float(budget_ms)
                        if budget_ms <= 0:
                            raise DeadlineExceededError(
                                "deadline_ms must be a positive budget in "
                                f"milliseconds, got {budget_ms:g}")
                        payload["deadline_ms"] = (
                            time.time() * 1000.0 + budget_ms)
                        dirty = True
                        # the routed call itself must not outlive the budget
                        call_timeout = min(300.0, budget_ms / 1000.0 + 5.0)
                    if dirty:
                        body = json.dumps(payload).encode()
            # failover path: replica death mid-request retries on a live
            # replica; only application errors surface as 500.  The serving
            # replica's tag rides back so streaming clients can pin polls.
            if action == "poll":
                # journal-aware poll: keeps the delivered prefix current and
                # replays the stream on a live replica if the pin is dead
                rid = payload.get("request_id", -1)
                try:
                    result, tag = journaled_poll(
                        _state.journal, handle, prefix, payload, pin,
                        timeout=call_timeout)
                except Exception:  # terminal for the client either way
                    # hand back the stream's tenant quota unit (idempotent)
                    _drop_stream_hold(prefix, pin, rid)
                    raise
                if isinstance(result, dict) and result.get("done"):
                    _drop_stream_hold(prefix, pin, rid)
            else:
                result, tag = handle.call_http_sync_tagged(
                    body, timeout=call_timeout, pin=pin)
                if (action == "submit" and isinstance(payload, dict)
                        and isinstance(result, dict)
                        and "request_id" in result
                        and payload.get("max_new_tokens") is not None):
                    # journal the admitted stream for crash replay (only
                    # budgeted requests are replayable — see supervisor.py)
                    _state.journal.record_submit(
                        prefix, tag, int(result["request_id"]),
                        prompt=payload.get("prompt") or [],
                        max_new_tokens=payload["max_new_tokens"],
                        priority=str(
                            payload.get("priority") or "interactive"),
                        deadline_ms=payload.get("deadline_ms"),
                        adapter_id=payload.get("adapter_id"),
                        tenant=payload.get("tenant"))
                if (action == "submit" and quota_hold is not None
                        and isinstance(result, dict)
                        and "request_id" in result):
                    # the quota unit now belongs to the STREAM: polls
                    # release it when they observe the stream's end
                    with _state.lock:
                        _state.tenant_streams[
                            (prefix, tag, int(result["request_id"]))
                        ] = quota_hold
                    quota_hold = None
            self._respond(200, _to_jsonable(result),
                          headers={REPLICA_HEADER: tag})
        except QuotaExceededError as e:
            # per-tenant quota, not capacity: 429 tells THIS client to
            # slow down (a 503 would suggest the fleet is the problem)
            self._respond(429, {"error": f"QuotaExceededError: {e}"},
                          headers={"Retry-After": f"{e.retry_after_s:g}"})
        except AdmissionShedError as e:
            self._respond(503, {"error": f"AdmissionShedError: {e}"},
                          headers={"Retry-After": f"{e.retry_after_s:g}"})
        except DeadlineExceededError as e:
            # the end-to-end budget is exhausted: 504, and Retry-After says
            # "re-issue with a fresh budget", distinct from 5xx breakage
            self._respond(504, {"error": f"DeadlineExceededError: {e}"},
                          headers={"Retry-After": "1"})
        except (NoLiveReplicasError, ReplicaGoneError) as e:
            self._respond(503, {"error": str(e)})
        except RemoteError as e:
            # replica-side backpressure (engine admission queue full) and
            # drain refusal (replica retiring mid-rollout) are the same
            # "retry later, nothing is broken" contract as zero live
            # replicas — 503, not 500
            if e.cause_repr.startswith("QuotaExceededError"):
                # a quota shed raised behind the actor boundary keeps the
                # 429 contract of the proxy-side check
                self._respond(429, {"error": e.cause_repr},
                              headers={"Retry-After": "1"})
            elif e.cause_repr.startswith(("EngineOverloadedError",
                                          "EngineDrainingError")):
                self._respond(503, {"error": e.cause_repr})
            elif e.cause_repr.startswith("DeadlineExceededError"):
                # a deadline expiry raised replica-side (queue sweep /
                # failed stream) crosses the actor boundary as RemoteError
                self._respond(504, {"error": e.cause_repr},
                              headers={"Retry-After": "1"})
            elif e.cause_repr.startswith("RequestValidationError"):
                # replica-side request validation (unknown adapter_id) is
                # the client's fault — same 400 the proxy-side ValueError
                # branch below produces.  Deliberately NOT plain ValueError:
                # an application ValueError inside a replica is a server
                # bug and must stay a 500
                self._respond(400, {"error": e.cause_repr})
            else:
                self._respond(500, {"error": f"{type(e).__name__}: {e}"})
        except ValueError as e:
            # malformed request (bad priority / bad payload shape caught
            # proxy-side): client error, not server error
            self._respond(400, {"error": f"ValueError: {e}"})
        except Exception as e:  # noqa: BLE001 — surface the error to the client
            self._respond(500, {"error": f"{type(e).__name__}: {e}"})
        finally:
            if quota_hold is not None:
                # blocking call, or any path that never handed the unit to
                # a stream: the request is over, return the unit
                quota_hold[0].release(quota_hold[1])

    do_POST = _dispatch
    do_GET = _dispatch


def _drop_stream_hold(prefix: str, pin: Optional[str], request_id) -> None:
    """Release the tenant quota unit held by a finished (or terminally
    failed) stream.  Idempotent — re-polls of a done stream pop nothing."""
    try:
        key = (prefix, pin or "", int(request_id))
    except (TypeError, ValueError):
        return
    with _state.lock:
        held = _state.tenant_streams.pop(key, None)
    if held is not None:
        held[0].release(held[1])


def run(
    target: Application,
    *,
    host: str = "127.0.0.1",
    port: int = 8000,
    name: Optional[str] = None,
    route_prefix: Optional[str] = None,
    admission_policy: Optional[AdmissionPolicy] = None,
    autoscaler: Optional[AutoscalerConfig] = None,
    fault_plan=None,
    _blocking: bool = False,
    **_ignored,
) -> DeploymentHandle:
    """Deploy an Application: start its replicas and route HTTP to them.

    Every route gets an :class:`~tpu_air_torch.serve.admission.AdmissionController`
    (``admission_policy`` overrides the default
    :class:`~tpu_air_torch.serve.admission.AdmissionPolicy`; routes without an
    engine see empty gauges and admit everything, so plain deployments are
    unaffected).  Passing ``autoscaler=AutoscalerConfig(...)`` additionally
    starts a gauge-driven replica scaling loop for this route.

    ``fault_plan=FaultPlan(...)`` installs a seeded deterministic fault
    plan (tpu_air_torch.faults) for chaos testing — it must be installed before
    the replicas spawn so they inherit it through the environment."""
    if not isinstance(target, Application):
        raise TypeError(
            "serve.run expects a bound Application — call Deployment.bind(...)"
        )
    if fault_plan is not None:
        _faults.install(fault_plan)
    prefix = route_prefix or target.deployment.route_prefix or "/"
    # Validate the port before starting replicas or mutating routes — a
    # port-mismatch failure must not leave a half-deployed application.
    with _state.lock:
        if _state.server is not None and port != _state.port:
            raise RuntimeError(
                f"serve proxy already running on port {_state.port}; "
                f"cannot also listen on {port} (call serve.shutdown() first)"
            )
    handle = start_replicas(target)
    old = None
    old_scaler = None
    try:
        # validate the autoscaler config (and build the loop) BEFORE any
        # route-table mutation: a bad config must not half-deploy
        scaler = (Autoscaler(handle, autoscaler)
                  if autoscaler is not None else None)
        with _state.lock:
            # re-check under the same lock that creates the server — the
            # early check above is only a fast-fail; this one is authoritative
            if _state.server is not None and port != _state.port:
                raise RuntimeError(
                    f"serve proxy already running on port {_state.port}; "
                    f"cannot also listen on {port} (call serve.shutdown() first)"
                )
            if _state.server is None:
                # bind before touching routes: a failed bind (EADDRINUSE)
                # must not leave a route pointing at soon-dead replicas
                server = ThreadingHTTPServer((host, port), _Handler)
                thread = threading.Thread(target=server.serve_forever, daemon=True)
                thread.start()
                _state.server, _state.thread, _state.port = server, thread, port
            old = _state.routes.get(prefix)
            old_scaler = _state.autoscalers.pop(prefix, None)
            old_watcher = _state.watchers.pop(prefix, None)
            _state.routes[prefix] = handle
            _state.admission[prefix] = AdmissionController(
                handle, admission_policy)
            if scaler is not None:
                _state.autoscalers[prefix] = scaler.start()
            # preemption watcher: polls replicas for lease-revocation
            # notices and orchestrates migrate-or-replay (supervisor.py)
            _state.watchers[prefix] = PreemptionWatcher(
                handle, _state.journal, prefix,
                autoscaler=_state.autoscalers.get(prefix)).start()
    except Exception:  # noqa: BLE001 — ANY failure past replica start must release them
        _retire(handle)  # deployment failed after replicas started
        raise
    if old_scaler is not None:
        old_scaler.stop()  # must not keep scaling the retired handle
    if old_watcher is not None:
        old_watcher.stop()
    if old is not None:
        # Redeploy on an existing route: retire the previous deployment's
        # replicas so their actor processes and chip leases are released.
        _retire(old)
    # airwatch (observability/watch.py): an installed watch gets its fleet
    # scraper thread once replicas exist to scrape; off ⇒ one global read
    from tpu_air_torch.observability import watch as _watch

    if _watch.enabled():
        _watch.current().start_scraper()
    return handle


def _retire(handle: DeploymentHandle) -> None:
    """Kill a deployment's replica actors (releases processes + chip leases)
    and stop its restart controller so nothing respawns them."""
    from tpu_air_torch.core.remote import kill

    handle.stop()
    with handle._lock:
        # draining replicas (mid-rollout/scale-down) hold processes and
        # leases too — a retire must not leak them
        replicas = list(handle._replicas) + list(handle._draining)
        handle._replicas = []
        handle._draining = []
    for replica in replicas:
        try:
            kill(replica)
        except Exception:  # noqa: BLE001 — best-effort kill; replica may already be dead
            pass


def rollout(route_prefix: str = "/", timeout: float = 120.0) -> int:
    """Zero-downtime redeploy of one route's replicas: each is swapped for
    a freshly spawned replica, draining the old one first so in-flight
    streams finish where they started.  Returns the number swapped."""
    with _state.lock:
        handle = _state.routes.get(route_prefix)
    if handle is None:
        raise KeyError(f"no deployment at route {route_prefix!r}")
    return handle.rollout(timeout=timeout)


def shutdown() -> None:
    """Stop the proxy, the control loops, and every replica actor."""
    # the fleet scraper would only see dead replicas from here on
    from tpu_air_torch.observability import watch as _watch

    if _watch.enabled():
        _watch.current().stop_scraper()
    with _state.lock:
        for watcher in _state.watchers.values():
            watcher.stop()
        _state.watchers.clear()
        for scaler in _state.autoscalers.values():
            scaler.stop()
        _state.autoscalers.clear()
        _state.admission.clear()
        _state.tenant_streams.clear()
        for handle in _state.routes.values():
            _retire(handle)
        _state.routes.clear()
        if _state.server is not None:
            _state.server.shutdown()
            _state.server.server_close()
            _state.server = None
            _state.thread = None
            _state.port = None
        # retired replicas take their streams with them — drop the journal
        _state.journal = RequestJournal()


def replica_engine_stats() -> Dict[str, Dict[str, Any]]:
    """Engine-metrics snapshots from every deployed replica, merged across
    routes — the dashboard folds this into ``/api/engines`` + ``/metrics``
    so replica-side engines are visible beyond the driver's own registry."""
    with _state.lock:
        handles = list(_state.routes.values())
        controllers = dict(_state.admission)
    out: Dict[str, Dict[str, Any]] = {}
    for handle in handles:
        try:
            out.update(handle.engine_stats())
        except Exception:  # noqa: BLE001 — scrape is best-effort
            continue
    # proxy-side per-tenant quota sheds ride the ENGINE metric families
    # (``priority.<class>.quota_shed``): a synthetic partial snapshot per
    # route sums into the fleet view via merge_snapshots and renders as
    # tpu_air_engine_priority_quota_shed — both consumers key-guard, so
    # the missing engine gauges are simply absent, not zero
    for prefix, controller in controllers.items():
        qs = controller.stats()["quota_shed"]
        if any(qs.values()):
            name = f"admission{prefix.rstrip('/') or '/'}"
            out[name] = {
                "name": name,
                "priority": {p: {"quota_shed": int(n)}
                             for p, n in qs.items() if n},
            }
    return out


def route_control(route_prefix: str) -> Dict[str, Any]:
    """The driver-side control surface for one deployed route: its
    deployment handle, admission controller, autoscaler (or None),
    preemption watcher, and the shared request journal.  The batch lane's
    :class:`~tpu_air_torch.batch.BatchJob` drives THROUGH these: the same
    admission path, journal replay, and preemption orchestration online
    traffic gets, rather than a parallel offline stack."""
    with _state.lock:
        handle = _state.routes.get(route_prefix)
        if handle is None:
            raise KeyError(f"no deployment at route {route_prefix!r}")
        return {
            "handle": handle,
            "admission": _state.admission.get(route_prefix),
            "autoscaler": _state.autoscalers.get(route_prefix),
            "watcher": _state.watchers.get(route_prefix),
            "journal": _state.journal,
        }


def serve_control_stats() -> Dict[str, Any]:
    """Per-route serve-plane control state (the ``/-/stats`` payload):
    admission outcomes + gauges, autoscaler decisions.  The dashboard folds
    this into ``/api/serve`` + ``/metrics``."""
    with _state.lock:
        controllers = dict(_state.admission)
        scalers = dict(_state.autoscalers)
        watchers = dict(_state.watchers)
        journal = _state.journal
    out: Dict[str, Any] = {
        prefix: {
            "admission": controller.stats(),
            "autoscaler": (scalers[prefix].stats()
                           if prefix in scalers else None),
        }
        for prefix, controller in controllers.items()
    }
    # self-healing counters (route prefixes always start with "/", so the
    # bare key can't collide): journal size, replays, replay failures, and
    # the installed fault plan's injection ledger (docs/RESILIENCE.md);
    # preemption-migration counters sum across routes' watchers
    preempt: Dict[str, int] = {}
    for watcher in watchers.values():
        for k, v in watcher.stats().items():
            preempt[k] = preempt.get(k, 0) + int(v)
    out["recovery"] = {**journal.stats(), **preempt,
                       "faults": _faults.stats()}
    # live-weight canary controllers (serve/weights.py): per-route state
    # machine, promotions and rollbacks, gate failures with reasons
    weights = controller_stats()
    if weights:
        out["weights"] = weights
    # batch lane (tpu_air_torch/batch): per-job progress and borrowing
    # gauges ride the same bare-key convention as "recovery" and "weights"
    from tpu_air_torch.batch import jobs_stats

    batch = jobs_stats()
    if batch:
        out["batch"] = batch
    return out


def status() -> Dict[str, Any]:
    return {
        "proxy": {"port": _state.port, "running": _state.server is not None},
        "deployments": {
            prefix: {
                "name": h.deployment_name,
                "num_replicas": h.live_replicas(),
            }
            for prefix, h in _state.routes.items()
        },
    }
