"""Dashboard: HTTP status service over the port's driver runtime, copied
from ``tpu_air/observability/dashboard.py`` (the port imports nothing of
``tpu_air``; the routes, payloads and ``tpu_air_*`` metric families are the
JAX package's).  ``/api/cluster``'s ``gcs`` holds the GCS daemon's address
and its nodes with their liveness (``{"address": None, "nodes": []}`` with
the control plane off), ``/api/objects`` the shared-memory arena's stats
under ``arena`` (absent where the arena did not build), and ``/metrics``
their ``tpu_air_arena_*`` gauges.

Endpoints (default 127.0.0.1:8265, the reference's dashboard address —
Install_locally.md:64-67):
  /                 tiny HTML overview
  /api/cluster      resources, workers, actors, queue depth
  /api/objects      object-store + arena + spill stats
  /api/engines      per-engine gauges (queue depth, occupancy, tokens/s, TTFT),
                    driver-local engines merged with serve-replica snapshots
  /api/traces       recent trace summaries; ?trace_id=... for one trace's spans
  /api/traces/export  chrome://tracing-loadable JSON (docs/OBSERVABILITY.md)
  /api/slo          airscope SLO burn-rate state (observability/slo.py),
                    evaluated against the live engine gauges on each GET
  /api/tenants      airwatch per-tenant cost ledger (observability/watch.py):
                    tokens, chip-seconds, KV-page-seconds, sheds, and the
                    chip_seconds_per_1k_tokens headline
  /api/watch        airwatch state: scrape/anomaly counters, recent
                    watch.anomaly events (with trace exemplars), detector
                    baselines, time-series store tiers
  /api/batch        airbatch job progress (tpu_air_torch/batch): rows
                    done/total, rows-per-second, in-flight window, borrowed
                    replicas, shed retries — one entry per registered
                    BatchJob
  /api/version      framework version
  /metrics          prometheus text exposition (OpenMetrics-style HELP/TYPE
                    headers; engine TTFT histograms carry trace exemplars)

When airwatch is installed, ``/api/engines`` and ``/metrics`` read replica
snapshots from its scrape cache instead of re-scraping per GET: snapshots
older than one scrape interval carry a ``stale_s`` age-mark and snapshots
older than the scrape TTL are dropped, so a killed replica's gauges leave
the fleet view instead of freezing at their last values.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional


def snapshot() -> Dict[str, Any]:
    """Point-in-time cluster state (the /api/cluster payload)."""
    from tpu_air_torch.core import runtime as rt_mod

    if not rt_mod.is_initialized():
        return {"initialized": False}
    rt = rt_mod.get_runtime()
    with rt.lock:
        workers = {
            wid: {
                "pid": ws.proc.pid,
                "alive": ws.alive,
                "actor_id": ws.actor_id,
                "busy_task": ws.busy_task,
            }
            for wid, ws in rt.workers.items()
        }
        actors = {
            aid: {
                "name": st.name,
                "worker_id": st.worker.worker_id,
                "chip_ids": list(st.chip_ids),
                "dead": st.dead,
                "pending": st.pending,
            }
            for aid, st in rt.actors.items()
        }
        out = {
            "initialized": True,
            "session_id": rt.session_id,
            # one host: every chip is on it
            "resources": {"cpu": rt.num_cpus, "chip": rt.num_chips,
                          "chips_per_host": rt.num_chips},
            "available": dict(rt.avail),
            "free_chips": list(rt.free_chips),
            "queue_depth": len(rt.queue),
            "workers": workers,
            "actors": actors,
        }
    # control-plane membership/liveness (outside the lock: GCS RPC)
    out["gcs"] = {"address": rt.gcs_address, "nodes": rt.nodes()}
    return out


def object_stats() -> Dict[str, Any]:
    import os

    from tpu_air_torch.core import runtime as rt_mod

    if not rt_mod.is_initialized():
        return {"initialized": False}
    rt = rt_mod.get_runtime()
    files = 0
    file_bytes = 0
    try:
        for name in os.listdir(rt.store_root):
            if name.startswith((".", "__")):
                continue
            files += 1
            file_bytes += os.path.getsize(os.path.join(rt.store_root, name))
    except OSError:
        pass
    out: Dict[str, Any] = {
        "store_root": rt.store_root,
        "file_objects": files,
        "file_bytes": file_bytes,
    }
    if rt.store._arena is not None:
        out["arena"] = rt.store._arena.stats()
    out["spill"] = rt.store.spill_stats()
    return out


def engine_stats() -> Dict[str, Any]:
    """Per-engine gauge snapshots (the /api/engines payload): driver-local
    engines (bench/test harness, driver-embedded) merged with serve-replica
    engines scraped over the deployment handles' ``engine_stats`` RPC
    (replica keys: ``deployment/replica-idx/engine-name``).

    With airwatch installed AND scraping, the replica side comes from the
    scraper's TTL-governed cache (see module doc) — stale snapshots age out
    instead of freezing, and a dashboard GET stops costing a fleet scrape."""
    out: Dict[str, Any] = {}
    cache = None
    try:
        from . import watch as watch_mod

        w = watch_mod.current()
        if w is not None and w.scrapes:
            cache = w.cached_engine_stats()
    except Exception:  # noqa: BLE001 — the cache is an optimization, never a 500
        cache = None
    if cache is not None:
        out.update(cache)
    from tpu_air_torch.engine.metrics import snapshot_all

    out.update(snapshot_all())  # driver-local: always live, never stale
    if cache is None:
        from tpu_air_torch.serve.proxy import replica_engine_stats

        out.update(replica_engine_stats())
    return out


def serve_stats() -> Dict[str, Any]:
    """Per-route serve-plane control state (the /api/serve payload):
    admission outcomes + gauges and autoscaler decisions, straight from the
    proxy's controllers.  Only the ``recovery`` counters when serve isn't
    running."""
    from tpu_air_torch.serve.proxy import serve_control_stats

    return serve_control_stats()


def trace_payload(query: Dict[str, Any]) -> Dict[str, Any]:
    """The /api/traces payload: recorder stats + recent trace summaries, or
    one trace's full span list when ``?trace_id=...`` is given."""
    from . import tracing

    trace_id = (query.get("trace_id") or [None])[0]
    rec = tracing.recorder()
    if trace_id:
        return {
            "enabled": tracing.enabled(),
            "trace_id": trace_id,
            "spans": [s.to_dict() for s in rec.for_trace(trace_id)],
        }
    limit = int((query.get("limit") or [64])[0])
    return {
        "enabled": tracing.enabled(),
        "recorder": rec.stats(),
        "traces": tracing.trace_summaries(limit),
    }


def slo_source() -> Dict[str, Any]:
    """Snapshot source for the default SLO monitor: the engine gauges plus
    a ``serve-recovery`` pseudo-snapshot carrying the serve plane's
    self-healing counters (journal, preemption watcher) so the recovery
    SLOs — preemption-recovery, migration-fallbacks, journal-evicted-live —
    are burn-rate-monitorable like any latency objective.  Route prefixes
    always start with ``/`` and engine names never contain one, so the
    bare key cannot collide with a real snapshot."""
    out = dict(engine_stats())
    recovery = (serve_stats() or {}).get("recovery")
    if recovery:
        out["serve-recovery"] = recovery
    return out


def slo_payload() -> Dict[str, Any]:
    """The /api/slo payload: every registered SLO's multi-window burn-rate
    state, freshly evaluated against the live engine gauges.  A scrape IS a
    sample: each GET appends one (good, total) point to the monitor's
    history, so the windows fill at the polling cadence."""
    from . import slo as slo_mod

    mon = slo_mod.ensure_default(slo_source)
    mon.observe()
    return {"slos": mon.state(), "burning": list(mon.burning())}


def tenants_payload() -> Dict[str, Any]:
    """The /api/tenants payload: airwatch's per-tenant cost ledger, or a
    bare ``{"enabled": false}`` when airwatch isn't installed."""
    from . import watch as watch_mod

    w = watch_mod.current()
    if w is None:
        return {"enabled": False, "tenants": {}}
    return {"enabled": True, **w.ledger.snapshot()}


def watch_payload() -> Dict[str, Any]:
    """The /api/watch payload: scrape/anomaly counters, recent events,
    detector baselines and store stats (observability/watch.py)."""
    from . import watch as watch_mod

    w = watch_mod.current()
    if w is None:
        return {"enabled": False}
    return w.payload()


def batch_payload() -> Dict[str, Any]:
    """The /api/batch payload: every registered batch job's progress
    snapshot (tpu_air_torch/batch/job.py ``jobs_stats``)."""
    from tpu_air_torch.batch import jobs_stats

    return {"jobs": jobs_stats()}


# every non-engine family /metrics can emit, with its exposition type and
# HELP text (engine families live in engine/metrics.py next to their data)
_CLUSTER_FAMILIES = [
    ("tpu_air_cpus_total", "gauge", "CPU slots the runtime was initialized with."),
    ("tpu_air_chips_total", "gauge", "Accelerator chips the runtime was initialized with."),
    ("tpu_air_cpus_available", "gauge", "CPU slots not currently leased."),
    ("tpu_air_chips_available", "gauge", "Chips not currently leased."),
    ("tpu_air_queue_depth", "gauge", "Tasks waiting for placement in the driver queue."),
    ("tpu_air_workers", "gauge", "Worker processes registered with the runtime."),
    ("tpu_air_actors", "gauge", "Live actors registered with the runtime."),
    ("tpu_air_store_file_objects", "gauge", "Objects resident in the file-backed store."),
    ("tpu_air_store_file_bytes", "gauge", "Bytes resident in the file-backed store."),
]
_SERVE_FAMILIES = [
    ("tpu_air_serve_admission_admitted", "counter",
     "Requests admitted by the serve proxy, by route and priority class."),
    ("tpu_air_serve_admission_queued", "counter",
     "Requests queued at admission, by route and priority class."),
    ("tpu_air_serve_admission_shed", "counter",
     "Requests shed at admission, by route and priority class."),
    ("tpu_air_serve_queue_depth_per_replica", "gauge",
     "Mean admission-queue depth per live replica, by route."),
    ("tpu_air_serve_replicas", "gauge", "Live replicas, by route."),
    ("tpu_air_serve_scale_ups", "counter", "Autoscaler scale-up actions, by route."),
    ("tpu_air_serve_scale_downs", "counter", "Autoscaler scale-down actions, by route."),
]
# serve-plane self-healing counters (PR-15 recovery gauges), exported so the
# recovery SLOs' raw inputs are scrapeable next to their burn rates
_RECOVERY_FAMILIES = [
    ("tpu_air_recovery_journal_size", "gauge",
     "Replayable streams currently journaled by the serve proxy."),
    ("tpu_air_recovery_replays", "counter",
     "Streams replayed onto a survivor replica after their pin died."),
    ("tpu_air_recovery_replay_failures", "counter",
     "Stream replays that failed terminally."),
    ("tpu_air_recovery_journal_evicted_live", "counter",
     "Live (undelivered) streams evicted from a full journal."),
    ("tpu_air_recovery_preemptions", "counter",
     "Lease-revocation notices orchestrated by the preemption watcher."),
    ("tpu_air_recovery_migrations", "counter",
     "Streams live-migrated off a preempted replica."),
    ("tpu_air_recovery_migrated_pages", "counter",
     "KV pages moved by live migration."),
    ("tpu_air_recovery_migration_fallbacks", "counter",
     "Preemptions that fell back to journal replay instead of migration."),
    ("tpu_air_recovery_preemption_recovery_ms", "gauge",
     "Worst preemption orchestration wall time, notice to out-of-rotation."),
]
# airwatch per-tenant cost ledger (observability/watch.py), by tenant
_TENANT_FAMILIES = [
    ("tpu_air_tenant_tokens_prefilled", "counter",
     "Prompt tokens prefilled, attributed by tenant (adapter_id)."),
    ("tpu_air_tenant_tokens_decoded", "counter",
     "Tokens decoded, attributed by tenant."),
    ("tpu_air_tenant_requests_completed", "counter",
     "Requests retired, by tenant."),
    ("tpu_air_tenant_chip_seconds", "counter",
     "Busy chip-seconds attributed to the tenant by token share."),
    ("tpu_air_tenant_kv_page_seconds", "counter",
     "KV-page-seconds of cache residency, by tenant."),
    ("tpu_air_tenant_migrated_pages", "counter",
     "KV pages live-migrated for the tenant's streams."),
    ("tpu_air_tenant_sheds", "counter",
     "Requests shed at admission, by tenant."),
    ("tpu_air_tenant_quota_rejected", "counter",
     "Requests rejected by tenant quota, by tenant."),
    ("tpu_air_tenant_token_share", "gauge",
     "Tenant's share of all attributed tokens."),
    ("tpu_air_tenant_chip_seconds_per_1k_tokens", "gauge",
     "Attributed chip-seconds per 1000 tokens, by tenant."),
]
# airbatch job progress (tpu_air_torch/batch), labelled by job — the counters
# are per-incarnation (a resumed driver restarts them; rows_done carries
# the epoch-level position via rows_resumed)
_BATCH_FAMILIES = [
    ("tpu_air_batch_rows_total", "gauge",
     "Rows in the batch job's dataset epoch."),
    ("tpu_air_batch_rows_done", "gauge",
     "Rows committed so far (processed this run + resumed from chunks)."),
    ("tpu_air_batch_rows_per_s", "gauge",
     "Rows processed per second by this driver incarnation."),
    ("tpu_air_batch_inflight", "gauge",
     "Rows currently in flight through serve admission."),
    ("tpu_air_batch_window", "gauge",
     "Current in-flight window (widened while borrowing chips)."),
    ("tpu_air_batch_borrowed_replicas", "gauge",
     "Serve replicas currently on loan to the batch job."),
    ("tpu_air_batch_borrows", "counter",
     "Replicas borrowed from idle serve capacity, lifetime."),
    ("tpu_air_batch_borrow_returns", "counter",
     "Borrowed replicas handed back through the preemption drain."),
    ("tpu_air_batch_checkpoints", "counter",
     "Cursor checkpoints journaled to the object store."),
    ("tpu_air_batch_resumes", "counter",
     "1 when this incarnation resumed from a checkpoint."),
    ("tpu_air_batch_shed_retries", "counter",
     "Admission sheds absorbed by backoff (best_effort yielding)."),
]
_WATCH_FAMILIES = [
    ("tpu_air_watch_scrapes", "counter",
     "Fleet scrape passes completed by the airwatch scraper."),
    ("tpu_air_watch_anomalies", "counter",
     "watch.anomaly events emitted by the online detector."),
    ("tpu_air_watch_samples_recorded", "counter",
     "Samples folded into the airwatch time-series store."),
    ("tpu_air_watch_idle_chip_seconds", "counter",
     "Chip-seconds observed with no tokens to attribute them to."),
    ("tpu_air_watch_chip_seconds_per_1k_tokens", "gauge",
     "Fleet headline: attributed chip-seconds per 1000 tokens."),
]


def _prometheus_text() -> str:
    from tpu_air_torch.engine.metrics import prometheus_lines
    from tpu_air_torch.utils.metrics import ExpositionBuilder, sanitize_metric_name

    b = ExpositionBuilder()
    for fam, mtype, help_text in (_CLUSTER_FAMILIES + _SERVE_FAMILIES
                                  + _RECOVERY_FAMILIES + _TENANT_FAMILIES
                                  + _BATCH_FAMILIES + _WATCH_FAMILIES):
        b.declare(fam, mtype, help_text)
    snap = snapshot()
    lines: list = []
    if snap.get("initialized"):
        b.sample("tpu_air_cpus_total", {}, snap["resources"]["cpu"])
        b.sample("tpu_air_chips_total", {}, snap["resources"]["chip"])
        b.sample("tpu_air_cpus_available", {}, snap["available"].get("cpu", 0))
        b.sample("tpu_air_chips_available", {}, snap["available"].get("chip", 0))
        b.sample("tpu_air_queue_depth", {}, snap["queue_depth"])
        b.sample("tpu_air_workers", {}, len(snap["workers"]))
        b.sample("tpu_air_actors", {}, len(snap["actors"]))
        ost = object_stats()
        b.sample("tpu_air_store_file_objects", {}, ost.get("file_objects", 0))
        b.sample("tpu_air_store_file_bytes", {}, ost.get("file_bytes", 0))
        if "arena" in ost:
            for k, v in ost["arena"].items():
                # arena stat keys are free-form (may carry dots/dashes);
                # they must still land as valid prometheus identifiers
                fam = f"tpu_air_arena_{sanitize_metric_name(k)}"
                b.declare(fam, "gauge", f"Shared-memory arena stat {k}.")
                b.sample(fam, {}, v)
    # engine gauges live OUTSIDE the initialized check: an engine embedded
    # in this process (tests, bench, notebook) exports metrics even when the
    # cluster runtime was never brought up.  engine_stats() also folds in
    # serve-replica snapshots, so /metrics covers both.
    snapshots = engine_stats()
    if snapshots:
        lines += prometheus_lines(snapshots)
    # serve-plane control gauges: admission outcomes per class and the
    # autoscaler's position, labelled by route
    sstats = serve_stats()
    for route, ctl in sstats.items():
        if not isinstance(ctl, dict) or "admission" not in ctl:
            continue  # "recovery"/"weights" pseudo-routes handled below
        adm = ctl.get("admission") or {}
        for outcome in ("admitted", "queued", "shed"):
            for klass, n in (adm.get(outcome) or {}).items():
                b.sample(f"tpu_air_serve_admission_{outcome}",
                         {"route": route, "priority": klass}, n)
        g = adm.get("gauges") or {}
        if g:
            b.sample("tpu_air_serve_queue_depth_per_replica",
                     {"route": route}, g.get("depth_per_replica", 0))
        sc = ctl.get("autoscaler")
        if sc:
            b.sample("tpu_air_serve_replicas", {"route": route},
                     sc.get("replicas", 0))
            b.sample("tpu_air_serve_scale_ups", {"route": route},
                     sc.get("scale_ups", 0))
            b.sample("tpu_air_serve_scale_downs", {"route": route},
                     sc.get("scale_downs", 0))
    # self-healing counters: the recovery SLOs' raw inputs (satellite of
    # docs/OBSERVABILITY.md "airwatch" — burn rates ride tpu_air_slo_*)
    recovery = sstats.get("recovery") or {}
    for fam, _mtype, _help in _RECOVERY_FAMILIES:
        key = fam[len("tpu_air_recovery_"):]
        if key in recovery:
            b.sample(fam, {}, recovery[key])
    # airbatch: per-job progress gauges, same key-strip pattern as the
    # recovery/tenant families (family name minus prefix == stats key)
    for job_id, jstats in sorted((batch_payload().get("jobs") or {}).items()):
        labels = {"job": job_id}
        for fam, _mtype, _help in _BATCH_FAMILIES:
            key = fam[len("tpu_air_batch_"):]
            if key in jstats:
                b.sample(fam, labels, jstats[key])
    # airwatch: per-tenant cost ledger + the watch plane's own counters
    from . import watch as watch_mod

    w = watch_mod.current()
    if w is not None:
        ledger = w.ledger.snapshot()
        for tenant, tot in sorted(ledger["tenants"].items()):
            labels = {"tenant": tenant}
            for fam, _mtype, _help in _TENANT_FAMILIES:
                key = fam[len("tpu_air_tenant_"):]
                if key in tot:
                    b.sample(fam, labels, tot[key])
        b.sample("tpu_air_watch_scrapes", {}, w.scrapes)
        b.sample("tpu_air_watch_anomalies", {}, w.anomalies)
        b.sample("tpu_air_watch_samples_recorded", {},
                 w.store.stats()["samples_recorded"])
        b.sample("tpu_air_watch_idle_chip_seconds", {},
                 ledger["idle_chip_seconds"])
        b.sample("tpu_air_watch_chip_seconds_per_1k_tokens", {},
                 ledger["headline"]["chip_seconds_per_1k_tokens"])
    # SLO burn-rate families (the monitor is its own exposition source so
    # the /api/slo JSON and the prometheus lines can never disagree); a
    # /metrics scrape doubles as a burn-rate sample, same as /api/slo
    from . import slo as slo_mod

    mon = slo_mod.ensure_default(slo_source)
    mon.observe()
    slo_lines = mon.prometheus_lines()
    out = b.lines() + lines + slo_lines
    return "\n".join(out) + "\n"


_INDEX_HTML = """<!doctype html><html><head><title>tpu_air dashboard</title></head>
<body><h2>tpu_air dashboard</h2>
<p>JSON endpoints: <a href="/api/cluster">/api/cluster</a> ·
<a href="/api/objects">/api/objects</a> ·
<a href="/api/engines">/api/engines</a> ·
<a href="/api/serve">/api/serve</a> ·
<a href="/api/traces">/api/traces</a> ·
<a href="/api/traces/export">/api/traces/export</a> ·
<a href="/api/slo">/api/slo</a> ·
<a href="/api/tenants">/api/tenants</a> ·
<a href="/api/watch">/api/watch</a> ·
<a href="/api/batch">/api/batch</a> ·
<a href="/api/version">/api/version</a> ·
<a href="/metrics">/metrics</a></p>
<pre id="s"></pre>
<script>
async function load(){
  const r = await fetch('/api/cluster');
  document.getElementById('s').textContent = JSON.stringify(await r.json(), null, 2);
}
load(); setInterval(load, 2000);
</script></body></html>"""


class _Handler(BaseHTTPRequestHandler):
    def log_message(self, *args):
        pass

    def _send(self, code: int, body: bytes, ctype: str):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        from urllib.parse import parse_qs, urlsplit

        parts = urlsplit(self.path)
        path = parts.path.rstrip("/") or "/"
        query = parse_qs(parts.query)
        try:
            if path == "/":
                self._send(200, _INDEX_HTML.encode(), "text/html")
            elif path == "/api/cluster":
                self._send(200, json.dumps(snapshot()).encode(), "application/json")
            elif path == "/api/objects":
                self._send(200, json.dumps(object_stats()).encode(), "application/json")
            elif path == "/api/engines":
                self._send(200, json.dumps(engine_stats()).encode(), "application/json")
            elif path == "/api/serve":
                self._send(200, json.dumps(serve_stats()).encode(), "application/json")
            elif path == "/api/traces":
                self._send(200, json.dumps(trace_payload(query)).encode(),
                           "application/json")
            elif path == "/api/traces/export":
                from . import trace_export

                trace_id = (query.get("trace_id") or [None])[0]
                self._send(
                    200,
                    trace_export.export_json(trace_id=trace_id).encode(),
                    "application/json",
                )
            elif path == "/api/slo":
                self._send(200, json.dumps(slo_payload()).encode(),
                           "application/json")
            elif path == "/api/tenants":
                self._send(200, json.dumps(tenants_payload()).encode(),
                           "application/json")
            elif path == "/api/watch":
                self._send(200, json.dumps(watch_payload()).encode(),
                           "application/json")
            elif path == "/api/batch":
                self._send(200, json.dumps(batch_payload()).encode(),
                           "application/json")
            elif path == "/api/version":
                import tpu_air_torch

                self._send(
                    200,
                    json.dumps({"version": tpu_air_torch.__version__}).encode(),
                    "application/json",
                )
            elif path == "/metrics":
                self._send(200, _prometheus_text().encode(), "text/plain")
            else:
                self._send(404, b'{"error": "not found"}', "application/json")
        except Exception as e:  # noqa: BLE001 — surface to the client
            self._send(500, json.dumps({"error": str(e)}).encode(), "application/json")


_server: Optional[ThreadingHTTPServer] = None
_thread: Optional[threading.Thread] = None
_lock = threading.Lock()


def start_dashboard(host: str = "127.0.0.1", port: int = 8265) -> str:
    """Start the dashboard; returns its URL (printed by init, like the
    reference's 'Follow the link … to open the Ray Dashboard')."""
    global _server, _thread
    with _lock:
        if _server is not None:
            return f"http://{_server.server_address[0]}:{_server.server_address[1]}"
        srv = ThreadingHTTPServer((host, port), _Handler)
        t = threading.Thread(target=srv.serve_forever, daemon=True)
        t.start()
        _server, _thread = srv, t
        return f"http://{host}:{srv.server_address[1]}"


def stop_dashboard() -> None:
    global _server, _thread
    with _lock:
        if _server is not None:
            _server.shutdown()
            _server.server_close()
            _server = None
            _thread = None
