"""Engine gauges — queue depth, slot occupancy, tokens/s, TTFT, step
latency — copied from ``tpu_air/engine/metrics.py`` (metric names and the
exposition text are the JAX package's).

Process-local registry: ``EngineMetrics`` instances self-register by engine
name at construction; ``observability/dashboard.py`` folds
:func:`snapshot_all` into ``/metrics`` (prometheus text) and serves it as
``/api/engines``.  The dashboard runs in the driver process, so it sees the
engines of THAT process — a driver-embedded engine, or the test harness.
Engines inside serve replica workers expose the same snapshot over the
deployment's ``stats`` method instead (serve/engine_deployment.py).

Latency distributions are airscope :class:`~tpu_air_torch.observability.perf.
Histogram` instances (log-bucketed, unwindowed, mergeable): the seed's
256-sample deques + sorted-index quantiles are gone, p50/p95/p99 cover the
engine's whole life, replica snapshots merge bucket-by-bucket
(:func:`merge_snapshots`), and TTFT samples recorded with a ``trace_id``
carry OpenMetrics exemplars that join a tail latency to its airtrace span
tree.  Each instance also owns a :class:`~tpu_air_torch.observability.perf.
PerfLedger` the engine feeds per-program costs and goodput tokens into;
its roofline/goodput state rides along in :meth:`snapshot` as ``perf``.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Deque, Dict, Optional

from collections import deque

from tpu_air_torch.observability.perf import (
    Histogram,
    PerfLedger,
    ProgramCost,
    cumulative_from_summary,
    merge_ledger_snapshots,
    merge_summaries,
)
from tpu_air_torch.utils.metrics import ExpositionBuilder, sanitize_metric_name

from .types import PRIORITIES

_RATE_WINDOW_S = 10.0  # tokens/s horizon


class EngineMetrics:
    """Thread-safe gauges/counters for one engine instance."""

    def __init__(self, name: str = "engine", num_slots: int = 0):
        self.name = name
        self.num_slots = num_slots
        self._lock = threading.Lock()
        # gauges (set whole each observation)
        self.queue_depth = 0
        self.slot_occupancy = 0
        # counters
        self.requests_submitted = 0
        self.requests_rejected = 0
        self.requests_completed = 0
        self.tokens_emitted = 0
        # per-priority-class breakdowns (SLO-aware serving): submits/sheds
        # by class plus a per-class TTFT histogram, so the interactive p99
        # the admission controller and autoscaler steer on is visible
        # directly
        self.submitted_by_class: Dict[str, int] = {p: 0 for p in PRIORITIES}
        self.rejected_by_class: Dict[str, int] = {p: 0 for p in PRIORITIES}
        # per-tenant-quota sheds by class (serve/admission.py tenant
        # budgets: the 429s, distinct from the overload 503s in ``shed``)
        self.quota_shed_by_class: Dict[str, int] = {p: 0 for p in PRIORITIES}
        self._ttft_by_class: Dict[str, Histogram] = {
            p: Histogram() for p in PRIORITIES
        }
        self.queue_by_class: Dict[str, int] = {p: 0 for p in PRIORITIES}
        self.draining = False
        # queued requests swept past their absolute deadline_ms (the proxy
        # maps these to HTTP 504 — docs/RESILIENCE.md)
        self.deadline_expired = 0
        # distributions / rates
        self._ttft_h = Histogram()
        self._step_h = Histogram()
        self._token_stamps: Deque[Any] = deque()  # (t, n) for tokens/s
        # roofline + goodput accumulator (engine records program costs)
        self.ledger = PerfLedger()
        # paged-KV gauges (empty for slab engines — snapshot shape is then
        # unchanged from the slab era)
        self.kvpool: Dict[str, Any] = {}
        self.reordered_admits = 0
        self.prefill_chunks = 0
        # mesh/lease/role metadata (empty for single-chip engines)
        self.topology: Dict[str, Any] = {}
        # live-weight state (empty until the first swap/adapter load —
        # snapshot shape unchanged for engines that never hot-swap)
        self.weights: Dict[str, Any] = {}
        # preemption migration counters (empty until the first migrate —
        # same absent-until-used contract as ``weights``)
        self.migrations: Dict[str, Any] = {}
        # per-tenant usage counters keyed by adapter_id ("default" for the
        # base model), recorded at retirement — airwatch's cost-ledger feed
        # (same absent-until-used contract: empty until the first retire)
        self.tenants: Dict[str, Dict[str, float]] = {}
        register(self)

    def set_topology(self, **kw: Any) -> None:
        """Attach placement metadata (lease id, mesh shape, role, replica
        counts).  String values surface as an info-line's labels; numeric
        values as gauges.  Set once at engine construction."""
        with self._lock:
            self.topology.update(kw)

    # -- engine-side recording ----------------------------------------------
    def observe_gauges(self, queue_depth: int, slot_occupancy: int,
                       kvpool: Dict[str, Any] = None,
                       reordered_admits: int = None,
                       prefill_chunks: int = None,
                       queue_by_class: Dict[str, int] = None,
                       draining: bool = None,
                       deadline_expired: int = None) -> None:
        with self._lock:
            self.queue_depth = queue_depth
            self.slot_occupancy = slot_occupancy
            if kvpool is not None:
                self.kvpool = dict(kvpool)
            if reordered_admits is not None:
                self.reordered_admits = reordered_admits
            if prefill_chunks is not None:
                self.prefill_chunks = prefill_chunks
            if queue_by_class is not None:
                self.queue_by_class = dict(queue_by_class)
            if draining is not None:
                self.draining = bool(draining)
            if deadline_expired is not None:
                self.deadline_expired = deadline_expired

    def record_submit(self, priority: str = "interactive") -> None:
        with self._lock:
            self.requests_submitted += 1
            if priority in self.submitted_by_class:
                self.submitted_by_class[priority] += 1

    def record_reject(self, priority: str = "interactive") -> None:
        with self._lock:
            self.requests_rejected += 1
            if priority in self.rejected_by_class:
                self.rejected_by_class[priority] += 1

    def record_complete(self) -> None:
        with self._lock:
            self.requests_completed += 1

    def record_quota_shed(self, priority: str = "interactive") -> None:
        """A request shed by a per-tenant quota (HTTP 429) — the tenant
        exceeded ITS budget while the engine had capacity, so it counts
        apart from the overload ``shed``."""
        with self._lock:
            if priority in self.quota_shed_by_class:
                self.quota_shed_by_class[priority] += 1

    def record_migration(self, direction: str, pages: int,
                         reprefill_chunks: int = 0) -> None:
        """One live-slot migration through this engine: ``direction`` is
        ``"out"`` (slot extracted off a preempting replica) or ``"in"``
        (payload landed here).  ``reprefill_chunks`` counts prefill chunk
        programs the landing still has to run — zero by construction, and
        the preemption chaos test pins it at zero."""
        key = "out" if direction == "out" else "in"
        with self._lock:
            mg = self.migrations
            mg[key] = int(mg.get(key, 0)) + 1
            mg[key + "_pages"] = int(mg.get(key + "_pages", 0)) + int(pages)
            if key == "in":
                mg["in_reprefill_chunks"] = (
                    int(mg.get("in_reprefill_chunks", 0))
                    + int(reprefill_chunks))

    def _tenant(self, adapter_id: Optional[str]) -> Dict[str, float]:
        """Per-tenant counter dict (call with ``self._lock`` held)."""
        key = adapter_id if adapter_id else "default"
        d = self.tenants.get(key)
        if d is None:
            d = {"tokens_prefilled": 0, "tokens_decoded": 0,
                 "requests_completed": 0, "kv_page_seconds": 0.0,
                 "migrated_pages": 0}
            self.tenants[key] = d
        return d

    def record_tenant_retire(self, adapter_id: Optional[str],
                             prefilled: int, decoded: int,
                             kv_page_seconds: float) -> None:
        """One stream retired: bill its prompt/decode tokens and the
        KV-page residency (pages held × seconds resident) to its tenant
        (``adapter_id``, or the base-model ``"default"`` tenant).  The
        airwatch cost ledger differences these cumulative counters per
        scrape interval (observability/watch.py)."""
        with self._lock:
            d = self._tenant(adapter_id)
            d["requests_completed"] += 1
            d["tokens_prefilled"] += int(prefilled)
            d["tokens_decoded"] += int(decoded)
            d["kv_page_seconds"] += max(0.0, float(kv_page_seconds))

    def record_tenant_migrated(self, adapter_id: Optional[str],
                               pages: int) -> None:
        """KV pages shipped on behalf of one tenant's live-slot migration
        (billed at the landing, where the page count is exact)."""
        with self._lock:
            self._tenant(adapter_id)["migrated_pages"] += int(pages)

    def record_ttft(self, seconds: float, priority: str = "interactive",
                    trace_id: Optional[str] = None) -> None:
        """A first-token latency sample.  ``trace_id`` (when the request
        was traced) becomes the histogram bucket's exemplar — the join key
        from a dashboard tail-latency number to ``/api/traces?trace_id=``."""
        with self._lock:
            self._ttft_h.observe(seconds, trace_id)
            if priority in self._ttft_by_class:
                self._ttft_by_class[priority].observe(seconds, trace_id)

    def record_tokens(self, tokens: int) -> None:
        """Count emitted tokens outside a pool step (prefill's first token)."""
        now = time.monotonic()
        with self._lock:
            self.tokens_emitted += tokens
            self._token_stamps.append((now, tokens))
            self._trim_stamps(now)

    def record_step(self, seconds: float, tokens: int) -> None:
        now = time.monotonic()
        with self._lock:
            self._step_h.observe(seconds)
            self.tokens_emitted += tokens
            self._token_stamps.append((now, tokens))
            self._trim_stamps(now)

    def record_program(self, kind: str, cost: ProgramCost,
                       seconds: float) -> None:
        """Ledger feed: one compiled-program execution's analytic cost and
        measured wall time (engine.py's step/chunk instrumentation)."""
        with self._lock:
            self.ledger.record_program(kind, cost, seconds)

    def record_weights_swap(self, version: Optional[int], stall_ms: float,
                            rollback: bool = False) -> None:
        """One live weight swap on this engine: the version now serving,
        and the decode-step gap it cost (lock wait + reshard + device_put
        — the honest ``swap_stall_ms`` the bench gates on).  ``rollback``
        marks swaps that restored the prior version."""
        with self._lock:
            w = self.weights
            if version is not None:
                w["version"] = int(version)
            w["swaps"] = int(w.get("swaps", 0)) + 1
            if rollback:
                w["rollbacks"] = int(w.get("rollbacks", 0)) + 1
            w["last_stall_ms"] = float(stall_ms)
            w["max_stall_ms"] = max(float(stall_ms),
                                    float(w.get("max_stall_ms", 0.0)))

    def set_adapters_loaded(self, n: int) -> None:
        with self._lock:
            self.weights["adapters_loaded"] = int(n)

    def record_goodput(self, category: str, n: int) -> None:
        """Ledger feed: ``n`` tokens attributed to ``category`` ("useful"
        or a wasted class — perf.WASTED_CATEGORIES)."""
        with self._lock:
            self.ledger.record_tokens(category, n)

    def _trim_stamps(self, now: float) -> None:
        horizon = now - _RATE_WINDOW_S
        while self._token_stamps and self._token_stamps[0][0] < horizon:
            self._token_stamps.popleft()

    def reset_window(self) -> None:
        """Clear the latency histograms, rate stamps and ledger (counters
        stay).  For benches that warm jit caches through the engine and
        then measure a clean steady-state window."""
        with self._lock:
            self._ttft_h.reset()
            self._step_h.reset()
            self._token_stamps.clear()
            for h in self._ttft_by_class.values():
                h.reset()
            self.ledger.reset()

    # -- dashboard-side ------------------------------------------------------
    def tokens_per_s(self) -> float:
        now = time.monotonic()
        with self._lock:
            stamps = [(t, n) for t, n in self._token_stamps
                      if t >= now - _RATE_WINDOW_S]
            if not stamps:
                return 0.0
            span = max(now - stamps[0][0], 1e-6)
            return sum(n for _, n in stamps) / span

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            out = {
                "name": self.name,
                "num_slots": self.num_slots,
                "queue_depth": self.queue_depth,
                "slot_occupancy": self.slot_occupancy,
                "requests_submitted": self.requests_submitted,
                "requests_rejected": self.requests_rejected,
                "requests_completed": self.requests_completed,
                "tokens_emitted": self.tokens_emitted,
                "ttft_s": self._ttft_h.summary(),
                "step_latency_s": self._step_h.summary(),
                "draining": self.draining,
                "deadline_expired": self.deadline_expired,
                "priority": {
                    p: {
                        "submitted": self.submitted_by_class[p],
                        "shed": self.rejected_by_class[p],
                        "quota_shed": self.quota_shed_by_class[p],
                        "queue_depth": self.queue_by_class.get(p, 0),
                        "ttft_s": self._ttft_by_class[p].summary(),
                    }
                    for p in PRIORITIES
                },
                "perf": self.ledger.snapshot(),
            }
            if self.kvpool:
                out["kvpool"] = dict(self.kvpool)
                out["reordered_admits"] = self.reordered_admits
                out["prefill_chunks"] = self.prefill_chunks
            if self.topology:
                out["topology"] = dict(self.topology)
            if self.weights:
                out["weights"] = dict(self.weights)
            if self.migrations:
                out["migrations"] = dict(self.migrations)
            if self.tenants:
                out["tenants"] = {t: dict(d)
                                  for t, d in self.tenants.items()}
        out["tokens_per_s"] = self.tokens_per_s()
        return out


_registry: Dict[str, EngineMetrics] = {}
_registry_lock = threading.Lock()


def register(metrics: EngineMetrics) -> None:
    """Last registration wins per name (an engine restarted under the same
    name replaces its predecessor's gauges)."""
    with _registry_lock:
        _registry[metrics.name] = metrics


def unregister(name: str) -> None:
    with _registry_lock:
        _registry.pop(name, None)


def snapshot_all() -> Dict[str, Dict[str, Any]]:
    with _registry_lock:
        engines = list(_registry.values())
    return {m.name: m.snapshot() for m in engines}


def merge_snapshots(snapshots: Dict[str, Dict[str, Any]]) -> Dict[str, Any]:
    """Fleet-level aggregate of engine snapshots (driver engines + serve
    replicas): counters sum, histograms merge bucket-by-bucket — the
    merged p99 is computed over EVERY replica's samples, not a max of
    per-replica quantiles — and ledgers sum into one roofline/goodput
    view.  Consumed by bench_serve's headline math and anything wanting
    one number for the fleet."""
    snaps = [s for s in snapshots.values() if s]
    out: Dict[str, Any] = {"engines": len(snaps)}
    for key in ("num_slots", "queue_depth", "slot_occupancy",
                "requests_submitted", "requests_rejected",
                "requests_completed", "tokens_emitted",
                "deadline_expired"):
        out[key] = sum(int(s.get(key, 0)) for s in snaps)
    out["tokens_per_s"] = sum(float(s.get("tokens_per_s", 0.0))
                              for s in snaps)
    out["ttft_s"] = merge_summaries([s.get("ttft_s") or {} for s in snaps])
    out["step_latency_s"] = merge_summaries(
        [s.get("step_latency_s") or {} for s in snaps])
    prio: Dict[str, Any] = {}
    for p in PRIORITIES:
        entries = [(s.get("priority") or {}).get(p) or {} for s in snaps]
        prio[p] = {
            "submitted": sum(int(e.get("submitted", 0)) for e in entries),
            "shed": sum(int(e.get("shed", 0)) for e in entries),
            "quota_shed": sum(int(e.get("quota_shed", 0))
                              for e in entries),
            "queue_depth": sum(int(e.get("queue_depth", 0))
                               for e in entries),
            "ttft_s": merge_summaries([e.get("ttft_s") or {}
                                       for e in entries]),
        }
    out["priority"] = prio
    perfs = [s.get("perf") for s in snaps if s.get("perf")]
    if perfs:
        out["perf"] = merge_ledger_snapshots(perfs)
    tens = [s.get("tenants") for s in snaps if s.get("tenants")]
    if tens:
        # fleet per-tenant usage: counters sum across replicas (the cost
        # ledger differences the merged cumulative view per interval)
        tenants: Dict[str, Dict[str, float]] = {}
        for t in tens:
            for tenant, counters in t.items():
                agg = tenants.setdefault(tenant, {})
                for k, v in counters.items():
                    agg[k] = agg.get(k, 0) + v
        out["tenants"] = tenants
    migs = [s.get("migrations") for s in snaps if s.get("migrations")]
    if migs:
        keys = sorted(set().union(*migs))
        out["migrations"] = {
            k: sum(int(m.get(k, 0)) for m in migs) for k in keys}
    ws = [s.get("weights") for s in snaps if s.get("weights")]
    if ws:
        # fleet view: swaps/rollbacks sum, the serving version is the max
        # (mid-promotion the fleet is legitimately mixed), stall is the
        # worst replica's worst swap — the number bench_serve headlines
        out["weights"] = {
            "version": max(int(w.get("version", 0)) for w in ws),
            "swaps": sum(int(w.get("swaps", 0)) for w in ws),
            "rollbacks": sum(int(w.get("rollbacks", 0)) for w in ws),
            "max_stall_ms": max(float(w.get("max_stall_ms", 0.0))
                                for w in ws),
            "adapters_loaded": sum(int(w.get("adapters_loaded", 0))
                                   for w in ws),
        }
    return out


# -- prometheus exposition ---------------------------------------------------

_FAMILIES = [
    # (family, type, help)
    ("tpu_air_engine_queue_depth", "gauge", "admission queue depth"),
    ("tpu_air_engine_slot_occupancy", "gauge", "occupied decode slots"),
    ("tpu_air_engine_requests_submitted", "counter", "requests accepted"),
    ("tpu_air_engine_requests_rejected", "counter",
     "requests shed under backpressure"),
    ("tpu_air_engine_requests_completed", "counter", "requests retired"),
    ("tpu_air_engine_deadline_expired", "counter",
     "queued requests swept past their absolute deadline (served as 504)"),
    ("tpu_air_engine_tokens_emitted", "counter", "tokens streamed out"),
    ("tpu_air_engine_tokens_per_s", "gauge",
     "emitted tokens/s over the rate window"),
    ("tpu_air_engine_ttft_s", "histogram",
     "time to first token, seconds (log buckets, trace exemplars)"),
    ("tpu_air_engine_ttft_s_p50", "gauge", "TTFT p50 seconds"),
    ("tpu_air_engine_ttft_s_p95", "gauge", "TTFT p95 seconds"),
    ("tpu_air_engine_ttft_s_p99", "gauge", "TTFT p99 seconds"),
    ("tpu_air_engine_step_latency_s", "histogram",
     "pool decode step wall time, seconds"),
    ("tpu_air_engine_step_latency_s_p50", "gauge",
     "decode step p50 seconds"),
    ("tpu_air_engine_step_latency_s_p95", "gauge",
     "decode step p95 seconds"),
    ("tpu_air_engine_draining", "gauge",
     "1 while the engine refuses new submissions"),
    ("tpu_air_engine_priority_submitted", "counter",
     "requests accepted per priority class"),
    ("tpu_air_engine_priority_shed", "counter",
     "requests shed per priority class"),
    ("tpu_air_engine_priority_quota_shed", "counter",
     "requests shed by per-tenant quotas per priority class (HTTP 429)"),
    ("tpu_air_engine_priority_queue_depth", "gauge",
     "queued requests per priority class"),
    ("tpu_air_engine_priority_ttft_s", "histogram",
     "per-priority-class TTFT seconds"),
    ("tpu_air_engine_priority_ttft_s_p50", "gauge",
     "per-class TTFT p50 seconds"),
    ("tpu_air_engine_priority_ttft_s_p99", "gauge",
     "per-class TTFT p99 seconds"),
    ("tpu_air_engine_reordered_admits", "counter",
     "admissions taken out of FIFO order"),
    ("tpu_air_engine_prefill_chunks", "counter",
     "prefill chunk programs executed"),
    ("tpu_air_engine_roofline_fraction", "gauge",
     "achieved fraction of the analytic roofline (perf ledger totals)"),
    ("tpu_air_engine_flops_per_s", "gauge",
     "achieved model flops/s (analytic cost over measured wall time)"),
    ("tpu_air_engine_hbm_bytes_per_s", "gauge",
     "achieved HBM bytes/s (analytic cost over measured wall time)"),
    ("tpu_air_engine_program_roofline_fraction", "gauge",
     "per compiled-program roofline fraction"),
    ("tpu_air_engine_goodput_ratio", "gauge",
     "useful / (useful + wasted) emitted tokens"),
    ("tpu_air_engine_tokens_useful", "counter",
     "tokens retired on streams that completed normally"),
    ("tpu_air_engine_tokens_wasted", "counter",
     "tokens whose work was wasted, by category"),
    # live-weight plane (serve/weights.py): absent until an engine swaps
    ("tpu_air_weights_version", "gauge",
     "weight-store version currently serving"),
    ("tpu_air_weights_swaps", "counter", "live weight swaps applied"),
    ("tpu_air_weights_rollbacks", "counter",
     "swaps that restored the prior version (canary gate failures)"),
    ("tpu_air_weights_swap_stall_ms", "gauge",
     "decode-step gap of the most recent swap, milliseconds"),
    ("tpu_air_weights_swap_stall_ms_max", "gauge",
     "worst decode-step gap across all swaps, milliseconds"),
    ("tpu_air_weights_adapters_loaded", "gauge",
     "tenant LoRA adapters resident in the bank"),
    # preemption migration plane: absent until an engine migrates
    ("tpu_air_engine_migrations", "counter",
     "live slots migrated, by direction (out = extracted off a "
     "preempting replica, in = landed here)"),
    ("tpu_air_engine_migrated_pages", "counter",
     "KV pages shipped by live-slot migration, by direction"),
    ("tpu_air_engine_migration_reprefill_chunks", "counter",
     "prefill chunk programs a migration landing had to re-run "
     "(zero-re-prefill contract: stays 0)"),
]


def prometheus_lines(snapshots: Dict[str, Dict[str, Any]] = None) -> list:
    """Engine gauges in prometheus text form (dashboard /metrics), one
    ``# HELP``/``# TYPE`` header per family, histogram families with full
    ``_bucket``/``_sum``/``_count`` series and OpenMetrics exemplars.

    ``snapshots`` defaults to this process's registry; the dashboard passes
    a merged dict that also folds in serve-replica snapshots (keys there are
    ``deployment/replica/engine`` paths — label values, so any charset is
    fine after quote-escaping)."""
    if snapshots is None:
        snapshots = snapshot_all()
    b = ExpositionBuilder()
    for fam, mtype, help_text in _FAMILIES:
        b.declare(fam, mtype, help_text)
    kvpool_declared = set()
    topo_declared = set()
    for name, snap in sorted(snapshots.items()):
        if not snap:
            continue
        label = name.replace("\\", "\\\\").replace('"', '\\"')
        tag = f'{{engine="{label}"}}'
        for key in ("queue_depth", "slot_occupancy", "requests_submitted",
                    "requests_rejected", "requests_completed",
                    "deadline_expired", "tokens_emitted"):
            if key in snap:
                b.raw(f"tpu_air_engine_{key}",
                      f"tpu_air_engine_{key}{tag} {snap[key]}")
        if "tokens_per_s" in snap:
            b.raw("tpu_air_engine_tokens_per_s",
                  f"tpu_air_engine_tokens_per_s{tag} "
                  f"{snap['tokens_per_s']:.3f}")
        for dist_key, quantiles in (("ttft_s", ("p50", "p95", "p99")),
                                    ("step_latency_s", ("p50", "p95"))):
            d = snap.get(dist_key) or {}
            if not d.get("count"):
                continue
            fam = f"tpu_air_engine_{dist_key}"
            for q in quantiles:
                if q in d:
                    b.raw(f"{fam}_{q}", f"{fam}_{q}{tag} {d[q]:.6f}")
            if d.get("buckets"):
                b.histogram(fam, {"engine": name},
                            cumulative_from_summary(d),
                            int(d["count"]), float(d.get("sum", 0.0)))
        # paged-KV pool gauges (absent on slab engines)
        for key, val in sorted((snap.get("kvpool") or {}).items()):
            if isinstance(val, bool) or not isinstance(val, (int, float)):
                continue
            fam = f"tpu_air_engine_kvpool_{key}"
            if fam not in kvpool_declared:
                b.declare(fam, "gauge", f"paged KV pool: {key}")
                kvpool_declared.add(fam)
            b.raw(fam, f"{fam}{tag} {val:g}")
        for key in ("reordered_admits", "prefill_chunks"):
            if key in snap:
                b.raw(f"tpu_air_engine_{key}",
                      f"tpu_air_engine_{key}{tag} {snap[key]}")
        if "draining" in snap:
            b.raw("tpu_air_engine_draining",
                  f"tpu_air_engine_draining{tag} "
                  f"{int(bool(snap['draining']))}")
        # per-priority-class counters/gauges ({engine=...,priority=...})
        for prio, pc in sorted((snap.get("priority") or {}).items()):
            ptag = f'{{engine="{label}",priority="{prio}"}}'
            for key in ("submitted", "shed", "quota_shed", "queue_depth"):
                if key in pc:
                    b.raw(f"tpu_air_engine_priority_{key}",
                          f"tpu_air_engine_priority_{key}{ptag} {pc[key]}")
            d = pc.get("ttft_s") or {}
            if d.get("count"):
                b.raw("tpu_air_engine_priority_ttft_s_p50",
                      f"tpu_air_engine_priority_ttft_s_p50{ptag} "
                      f"{d['p50']:.6f}")
                b.raw("tpu_air_engine_priority_ttft_s_p99",
                      f"tpu_air_engine_priority_ttft_s_p99{ptag} "
                      f"{d['p99']:.6f}")
                if d.get("buckets"):
                    b.histogram("tpu_air_engine_priority_ttft_s",
                                {"engine": name, "priority": prio},
                                cumulative_from_summary(d),
                                int(d["count"]), float(d.get("sum", 0.0)))
        # perf ledger: roofline totals, per-program fractions, goodput
        perf = snap.get("perf") or {}
        totals = perf.get("totals") or {}
        if totals.get("seconds"):
            b.raw("tpu_air_engine_roofline_fraction",
                  f"tpu_air_engine_roofline_fraction{tag} "
                  f"{totals['roofline_fraction']:.6f}")
            b.raw("tpu_air_engine_flops_per_s",
                  f"tpu_air_engine_flops_per_s{tag} "
                  f"{totals['flops_per_s']:.6g}")
            b.raw("tpu_air_engine_hbm_bytes_per_s",
                  f"tpu_air_engine_hbm_bytes_per_s{tag} "
                  f"{totals['bytes_per_s']:.6g}")
            for kind, p in sorted((perf.get("programs") or {}).items()):
                b.raw("tpu_air_engine_program_roofline_fraction",
                      f"tpu_air_engine_program_roofline_fraction"
                      f'{{engine="{label}",program="{kind}"}} '
                      f"{p['roofline_fraction']:.6f}")
        goodput = perf.get("goodput") or {}
        if goodput.get("total"):
            b.raw("tpu_air_engine_goodput_ratio",
                  f"tpu_air_engine_goodput_ratio{tag} "
                  f"{goodput['goodput_ratio']:.6f}")
            b.raw("tpu_air_engine_tokens_useful",
                  f"tpu_air_engine_tokens_useful{tag} "
                  f"{goodput.get('useful', 0)}")
            for cat, n in sorted(goodput.items()):
                if cat in ("total", "wasted", "useful", "goodput_ratio"):
                    continue
                b.raw("tpu_air_engine_tokens_wasted",
                      f"tpu_air_engine_tokens_wasted"
                      f'{{engine="{label}",category="{cat}"}} {n}')
        # live-weight plane gauges (absent on engines that never swapped)
        w = snap.get("weights") or {}
        for skey, fam in (("version", "tpu_air_weights_version"),
                          ("swaps", "tpu_air_weights_swaps"),
                          ("rollbacks", "tpu_air_weights_rollbacks"),
                          ("adapters_loaded",
                           "tpu_air_weights_adapters_loaded")):
            if skey in w:
                b.raw(fam, f"{fam}{tag} {int(w[skey])}")
        if "last_stall_ms" in w:
            b.raw("tpu_air_weights_swap_stall_ms",
                  f"tpu_air_weights_swap_stall_ms{tag} "
                  f"{float(w['last_stall_ms']):.3f}")
        if "max_stall_ms" in w:
            b.raw("tpu_air_weights_swap_stall_ms_max",
                  f"tpu_air_weights_swap_stall_ms_max{tag} "
                  f"{float(w['max_stall_ms']):.3f}")
        # preemption migration counters (absent until an engine migrates)
        mg = snap.get("migrations") or {}
        for direction in ("out", "in"):
            if direction in mg:
                dtag = f'{{engine="{label}",direction="{direction}"}}'
                b.raw("tpu_air_engine_migrations",
                      f"tpu_air_engine_migrations{dtag} {int(mg[direction])}")
                b.raw("tpu_air_engine_migrated_pages",
                      f"tpu_air_engine_migrated_pages{dtag} "
                      f"{int(mg.get(direction + '_pages', 0))}")
        if "in_reprefill_chunks" in mg:
            b.raw("tpu_air_engine_migration_reprefill_chunks",
                  f"tpu_air_engine_migration_reprefill_chunks{tag} "
                  f"{int(mg['in_reprefill_chunks'])}")
        # topology: strings fold into one info line's labels, numbers
        # (replica counts, device counts) become gauges
        topo = snap.get("topology") or {}
        if topo:
            info = [f'engine="{label}"']
            for key, val in sorted(topo.items()):
                # keys become metric-name / label-name fragments: sanitize.
                # values are label VALUES — any charset, quote-escape only
                skey = sanitize_metric_name(str(key))
                if isinstance(val, bool) or not isinstance(val, (int, float)):
                    sval = str(val).replace("\\", "\\\\").replace('"', '\\"')
                    info.append(f'{skey}="{sval}"')
                else:
                    fam = f"tpu_air_engine_topology_{skey}"
                    if fam not in topo_declared:
                        b.declare(fam, "gauge", f"engine topology: {skey}")
                        topo_declared.add(fam)
                    b.raw(fam, f"{fam}{tag} {val:g}")
            fam = "tpu_air_engine_topology_info"
            if fam not in topo_declared:
                b.declare(fam, "gauge",
                          "engine placement metadata as labels")
                topo_declared.add(fam)
            b.raw(fam, "tpu_air_engine_topology_info{"
                  + ",".join(info) + "} 1")
    return b.lines()
