"""airwatch — fleet time-series plane: history, tenant costs, anomalies,
copied from ``tpu_air/observability/watch.py`` (the port imports nothing of
``tpu_air``).  Its sources are the port's engines and serve plane; a chip
is a CUDA card, and an engine snapshot's ``topology.mesh_devices`` (one
where the snapshot has none) counts its cards.

Three pieces on top of the ring-buffer store (timeseries.py):

* :class:`FleetScraper` — a driver-side daemon thread that, every
  ``interval_s``, collects every replica's ``engine_stats`` snapshot (the
  same ``DeploymentHandle`` path the dashboard and admission use), the
  serve plane's ``/-/stats`` control state, and the installed SLO
  monitor's burn state; merges the engine snapshots with the airscope
  histogram-merge machinery (``merge_snapshots``) so fleet quantiles are
  computed over SAMPLES, not max-of-p99s; and feeds the store, the cost
  ledger and the anomaly detector from one pass.

* :class:`CostLedger` — per-tenant cost attribution keyed by
  ``adapter_id`` (``None`` ⇒ the ``"default"`` base-model tenant).  Per
  scrape interval it attributes tokens prefilled/decoded, chip-seconds
  (replica chip count × interval, split by busy fraction and then by each
  tenant's token share), KV-page-seconds resident, migrated pages, sheds
  and quota rejections — cumulative engine/admission counters in, rates
  and totals out, counter resets clamped.  Surfaced as the
  ``tpu_air_tenant_*`` prometheus families, ``/api/tenants``, and the
  ``chip_seconds_per_1k_tokens`` derived headline (the JAX package's ``tools/bench_serve.py`` gates on it).

* :class:`AnomalyDetector` — online EWMA mean + EWMA absolute deviation
  (a streaming stand-in for median/MAD) over the 1s tier; a sample whose
  robust z-score clears its metric's SEEDED threshold emits a structured
  ``watch.anomaly`` event carrying the metric, window, z-score and the
  worst trace exemplar from the matching airscope histogram bucket (the
  join key into ``/api/traces?trace_id=``).  The detector feeds the
  autoscaler as a third scale signal beside queue depth and SLO burn
  (serve/autoscaler.py), and is queryable at ``/api/watch`` plus
  ``tools/watch_dump.py``.

Zero-cost-off, same contract as airtrace/airfault: no :func:`install`
means no scraper thread exists and every hook is one module-global read
(:func:`enabled`).  The clock is injectable and detector thresholds
derive from ``seed`` alone, so the chaos lane's anomaly assertions are
deterministic under ``TPU_AIR_FAULT_SEED``.
"""

from __future__ import annotations

import random
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

from .perf import exemplar_trace_id
from .timeseries import DEFAULT_TIERS, TimeSeriesStore

__all__ = [
    "AnomalyDetector",
    "CostLedger",
    "DEFAULT_TENANT",
    "FleetScraper",
    "Watch",
    "WatchConfig",
    "anomalous",
    "clear",
    "current",
    "enabled",
    "install",
]

#: the base-model tenant every request without an ``adapter_id`` bills to
DEFAULT_TENANT = "default"

#: metrics the scraper derives from the merged fleet snapshot each tick,
#: and whether the detector sees the raw gauge or the per-tick delta of a
#: cumulative counter (negative deltas are counter resets: state clears,
#: nothing fires)
_FLEET_METRICS: Tuple[Tuple[str, str], ...] = (
    ("fleet.engines", "gauge"),
    ("fleet.queue_depth", "gauge"),
    ("fleet.slot_occupancy", "gauge"),
    ("fleet.tokens_per_s", "gauge"),
    ("fleet.ttft_p99_s", "gauge"),
    ("fleet.requests_completed", "counter"),
    ("fleet.requests_rejected", "counter"),
)
_RECOVERY_METRICS: Tuple[Tuple[str, str], ...] = (
    ("recovery.preemptions", "counter"),
    ("recovery.migration_fallbacks", "counter"),
    ("recovery.journal_evicted_live", "counter"),
    ("recovery.replays", "counter"),
)


@dataclass(frozen=True)
class WatchConfig:
    """Dials for one process's airwatch plane.

    * ``interval_s`` — scrape period (the 1s tier's natural cadence).
    * ``tiers`` — ``(step_s, capacity)`` downsampling tiers for the store.
    * ``seed`` — anomaly-threshold seed; the chaos lane pins it to
      ``TPU_AIR_FAULT_SEED`` so a red run replays bit-identically.
    * ``ewma_alpha`` — smoothing for the detector's mean/deviation (the
      effective window is ``interval_s / ewma_alpha``).
    * ``z_threshold`` — base robust-z trip point; each metric's actual
      threshold is this times a seeded jitter in ``[1, 1.5)`` (no two
      metrics share an exact trip point, and reruns agree).
    * ``warmup`` — samples per metric before the detector may fire.
    * ``anomaly_hold_s`` — per-metric refire spacing, and how long an
      event keeps :func:`anomalous` (the autoscaler signal) hot.
    * ``stale_after_s`` — replica snapshots older than this drop out of
      the scraper's cache (``None`` ⇒ ``3 × interval_s``); between one
      interval and the TTL they carry a ``stale_s`` age-mark.
    * ``max_events`` — anomaly/note ring size.
    """

    interval_s: float = 1.0
    tiers: Tuple[Tuple[float, int], ...] = DEFAULT_TIERS
    seed: int = 0
    ewma_alpha: float = 0.2
    z_threshold: float = 4.0
    warmup: int = 8
    anomaly_hold_s: float = 5.0
    stale_after_s: Optional[float] = None
    max_events: int = 256

    def __post_init__(self):
        if self.interval_s <= 0 or not 0.0 < self.ewma_alpha <= 1.0:
            raise ValueError(f"bad watch config: {self}")
        if self.z_threshold <= 0 or self.warmup < 2:
            raise ValueError(f"bad watch config: {self}")

    @property
    def ttl_s(self) -> float:
        return (self.stale_after_s if self.stale_after_s is not None
                else 3.0 * self.interval_s)


class AnomalyDetector:
    """Online EWMA + robust z-score over one stream of samples per metric.

    The deviation estimate is an EWMA of absolute residuals — a streaming
    approximation of MAD that a single outlier moves by at most ``alpha``
    of itself, which is what keeps the spike that FIRES from also wrecking
    the baseline it fired against.  Thresholds are seeded per metric
    (``random.Random(f"{seed}:{metric}")`` — str seeding is hashed with
    SHA-512, stable across processes), so two runs of the same seed trip
    at identical points.  Thread-safe; nothing under the lock blocks."""

    def __init__(self, config: Optional[WatchConfig] = None,
                 now: Callable[[], float] = time.monotonic):
        self.config = config or WatchConfig()
        self._now = now
        self._lock = threading.Lock()
        # metric -> [mean, abs-dev ewma, samples seen, last fire ts]
        self._state: Dict[str, list] = {}

    def threshold_for(self, metric: str) -> float:
        cfg = self.config
        jitter = random.Random(f"{cfg.seed}:{metric}").uniform(0.0, 0.5)
        return cfg.z_threshold * (1.0 + jitter)

    def reset(self, metric: str) -> None:
        """Counter reset (an engine restarted): forget the baseline so the
        discontinuity never fires."""
        with self._lock:
            self._state.pop(metric, None)

    def observe(self, metric: str, value: float,
                ts: Optional[float] = None) -> Optional[Dict[str, Any]]:
        """Feed one sample; returns a ``watch.anomaly`` event dict when it
        clears the metric's seeded threshold after warmup, else None."""
        cfg = self.config
        v = float(value)
        t = self._now() if ts is None else float(ts)
        threshold = self.threshold_for(metric)
        event = None
        with self._lock:
            st = self._state.get(metric)
            if st is None:
                st = [v, 0.0, 0, -1e18]
                self._state[metric] = st
            mean, dev, n, fired_at = st
            if n >= cfg.warmup:
                # robust z against the PRE-update baseline; the deviation
                # floor keeps a dead-flat warmup (dev == 0) from dividing
                # to infinity while still letting a clean step change fire
                floor = max(1e-3 * max(1.0, abs(mean)), 1e-9)
                z = abs(v - mean) / max(dev, floor)
                if (z >= threshold
                        and t - fired_at >= cfg.anomaly_hold_s):
                    st[3] = t
                    event = {
                        "event": "watch.anomaly",
                        "metric": metric,
                        "ts": t,
                        "value": v,
                        "mean": mean,
                        "deviation": max(dev, floor),
                        "zscore": z,
                        "threshold": threshold,
                        "window_s": round(cfg.interval_s / cfg.ewma_alpha, 3),
                    }
            # EWMA updates AFTER the test — the sample that fires must not
            # have already pulled the baseline toward itself
            st[0] = mean + cfg.ewma_alpha * (v - mean)
            st[1] = ((1.0 - cfg.ewma_alpha) * dev
                     + cfg.ewma_alpha * abs(v - mean))
            st[2] = n + 1
        return event

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                m: {"mean": st[0], "deviation": st[1], "samples": st[2],
                    "threshold": self.threshold_for(m)}
                for m, st in sorted(self._state.items())
            }


def _tenant_zero() -> Dict[str, float]:
    return {
        "tokens_prefilled": 0.0,
        "tokens_decoded": 0.0,
        "requests_completed": 0.0,
        "chip_seconds": 0.0,
        "kv_page_seconds": 0.0,
        "migrated_pages": 0.0,
        "admitted": 0.0,
        "sheds": 0.0,
        "quota_rejected": 0.0,
    }


class CostLedger:
    """Per-tenant cost attribution from cumulative fleet counters.

    :meth:`update` takes the CURRENT fleet-cumulative per-tenant counters
    (the merged engine ``tenants`` section + the admission controllers'
    per-tenant outcome counters), differences them against the previous
    scrape (negative deltas — a replica died or restarted — clamp to
    zero), and attributes the interval's chip-seconds: each engine
    contributes ``chips × dt``, split into busy (``slot_occupancy /
    num_slots``) and idle; busy chip-seconds divide across tenants by
    their share of the interval's tokens, idle accrues unattributed.
    Thread-safe; pure arithmetic under the lock."""

    def __init__(self):
        self._lock = threading.Lock()
        self._totals: Dict[str, Dict[str, float]] = {}
        self._idle_chip_seconds = 0.0
        self._chip_seconds_seen = 0.0
        self._last_engine: Dict[str, Dict[str, float]] = {}
        self._last_admission: Dict[str, Dict[str, float]] = {}
        self._intervals = 0

    @staticmethod
    def _deltas(cur: Dict[str, Dict[str, Any]],
                prev: Dict[str, Dict[str, float]],
                keys: Tuple[str, ...]) -> Dict[str, Dict[str, float]]:
        out: Dict[str, Dict[str, float]] = {}
        for tenant, counters in cur.items():
            base = prev.get(tenant) or {}
            out[tenant] = {
                k: max(0.0, float(counters.get(k, 0.0))
                       - float(base.get(k, 0.0)))
                for k in keys
            }
        return out

    def update(self, engine_tenants: Dict[str, Dict[str, Any]],
               admission_tenants: Dict[str, Dict[str, Any]],
               busy_chip_seconds: float, total_chip_seconds: float) -> None:
        """Fold one scrape interval into the ledger (see class doc)."""
        eng_keys = ("tokens_prefilled", "tokens_decoded",
                    "requests_completed", "kv_page_seconds",
                    "migrated_pages")
        adm_keys = ("admitted", "sheds", "quota_rejected")
        with self._lock:
            eng_d = self._deltas(engine_tenants or {}, self._last_engine,
                                 eng_keys)
            adm_d = self._deltas(admission_tenants or {},
                                 self._last_admission, adm_keys)
            token_d = {t: d["tokens_prefilled"] + d["tokens_decoded"]
                       for t, d in eng_d.items()}
            tokens_total = sum(token_d.values())
            busy = max(0.0, float(busy_chip_seconds))
            for tenant, d in eng_d.items():
                tot = self._totals.setdefault(tenant, _tenant_zero())
                for k in eng_keys:
                    tot[k] += d[k]
                if tokens_total > 0:
                    tot["chip_seconds"] += (busy * token_d[tenant]
                                            / tokens_total)
            for tenant, d in adm_d.items():
                tot = self._totals.setdefault(tenant, _tenant_zero())
                for k in adm_keys:
                    tot[k] += d[k]
            attributed = busy if tokens_total > 0 else 0.0
            self._chip_seconds_seen += max(0.0, float(total_chip_seconds))
            self._idle_chip_seconds += max(
                0.0, float(total_chip_seconds) - attributed)
            self._last_engine = {
                t: {k: float((c or {}).get(k, 0.0)) for k in eng_keys}
                for t, c in (engine_tenants or {}).items()}
            self._last_admission = {
                t: {k: float((c or {}).get(k, 0.0)) for k in adm_keys}
                for t, c in (admission_tenants or {}).items()}
            self._intervals += 1

    def snapshot(self) -> Dict[str, Any]:
        """JSON-ready ledger state: per-tenant totals with the derived
        ``chip_seconds_per_1k_tokens`` and token share, plus the fleet
        headline (total attributed chip-seconds per 1k attributed
        tokens)."""
        with self._lock:
            tenants = {t: dict(v) for t, v in self._totals.items()}
            idle = self._idle_chip_seconds
            seen = self._chip_seconds_seen
            intervals = self._intervals
        tokens_total = sum(v["tokens_prefilled"] + v["tokens_decoded"]
                           for v in tenants.values())
        chip_total = sum(v["chip_seconds"] for v in tenants.values())
        for v in tenants.values():
            toks = v["tokens_prefilled"] + v["tokens_decoded"]
            v["tokens_total"] = toks
            v["token_share"] = (toks / tokens_total) if tokens_total else 0.0
            v["chip_seconds_per_1k_tokens"] = (
                1000.0 * v["chip_seconds"] / toks if toks else 0.0)
        # lane split: the batch runner bills under ``batch:<job_id>``
        # tenants, so summing over that prefix separates offline soak from
        # interactive serving — the "was borrowing actually free?" number
        batch_chip = sum(v["chip_seconds"] for t, v in tenants.items()
                         if t.startswith("batch:"))
        batch_tokens = sum(v["tokens_total"] for t, v in tenants.items()
                           if t.startswith("batch:"))
        return {
            "tenants": tenants,
            "idle_chip_seconds": idle,
            "chip_seconds_seen": seen,
            "intervals": intervals,
            "headline": {
                "tokens_total": tokens_total,
                "chip_seconds_attributed": chip_total,
                "chip_seconds_per_1k_tokens": (
                    1000.0 * chip_total / tokens_total if tokens_total
                    else 0.0),
                "batch_chip_seconds": batch_chip,
                "interactive_chip_seconds": chip_total - batch_chip,
                "batch_tokens": batch_tokens,
                "batch_chip_share": (batch_chip / chip_total
                                     if chip_total else 0.0),
            },
        }


def _default_engine_source() -> Dict[str, Dict[str, Any]]:
    """Driver-local engine registry + every serve replica's snapshot — the
    same two feeds the dashboard's ``/api/engines`` merges."""
    from tpu_air_torch.engine.metrics import snapshot_all
    from tpu_air_torch.serve.proxy import replica_engine_stats

    out: Dict[str, Dict[str, Any]] = dict(snapshot_all())
    out.update(replica_engine_stats())
    return out


def _default_serve_source() -> Dict[str, Any]:
    from tpu_air_torch.serve.proxy import serve_control_stats

    return serve_control_stats()


def _slo_burning() -> List[str]:
    try:
        from . import slo as slo_mod
        mon = slo_mod.monitor()
        return list(mon.burning()) if mon is not None else []
    except Exception:  # noqa: BLE001 — burn state is best-effort decoration
        return []


class Watch:
    """One process's airwatch plane: store + ledger + detector + the
    scraper's snapshot cache, all behind :meth:`scrape_once`.

    ``engine_source`` / ``serve_source`` are injectable (the unit tests
    drive synthetic fleets on a fake clock); the defaults read the same
    paths the dashboard does.  The replica-snapshot cache is what fixes
    dashboard merge staleness: entries older than one interval carry a
    ``stale_s`` age-mark, entries older than ``config.ttl_s`` are dropped
    — a dead replica's gauges stop haunting ``/api/engines`` and
    ``/metrics`` one TTL after it stops answering scrapes."""

    def __init__(self, config: Optional[WatchConfig] = None, *,
                 engine_source: Optional[Callable[[], Dict[str, Any]]] = None,
                 serve_source: Optional[Callable[[], Dict[str, Any]]] = None,
                 now: Callable[[], float] = time.monotonic):
        self.config = config or WatchConfig()
        self._now = now
        self._engine_source = engine_source or _default_engine_source
        self._serve_source = serve_source or _default_serve_source
        self.store = TimeSeriesStore(tiers=self.config.tiers, now=now)
        self.ledger = CostLedger()
        self.detector = AnomalyDetector(self.config, now=now)
        self._lock = threading.Lock()
        self._events: Deque[Dict[str, Any]] = deque(
            maxlen=self.config.max_events)
        self._snap_cache: Dict[str, Tuple[float, Dict[str, Any]]] = {}
        self._counters: Dict[str, float] = {}  # last cumulative per metric
        self._last_scrape_ts: Optional[float] = None
        self._last_exemplar: Optional[str] = None
        self.scrapes = 0
        self.anomalies = 0
        self._scraper: Optional["FleetScraper"] = None

    # -- the scrape ----------------------------------------------------------
    def scrape_once(self) -> Dict[str, Any]:
        """One collection pass: scrape (outside any lock), merge, record,
        attribute, detect.  Returns the merged fleet snapshot."""
        from tpu_air_torch.engine.metrics import merge_snapshots

        ts = self._now()
        try:
            snaps = dict(self._engine_source() or {})
        except Exception:  # noqa: BLE001 — a failed scrape must not kill the loop
            snaps = {}
        try:
            serve = dict(self._serve_source() or {})
        except Exception:  # noqa: BLE001 — a failed scrape must not kill the loop
            serve = {}
        burning = _slo_burning()

        ttl = self.config.ttl_s
        with self._lock:
            for key, snap in snaps.items():
                if snap:
                    self._snap_cache[key] = (ts, snap)
            for key in [k for k, (at, _) in self._snap_cache.items()
                        if ts - at > ttl]:
                del self._snap_cache[key]
            cached = {k: s for k, (_, s) in self._snap_cache.items()}
            dt = (ts - self._last_scrape_ts
                  if self._last_scrape_ts is not None
                  else self.config.interval_s)
            self._last_scrape_ts = ts
            self.scrapes += 1

        merged = merge_snapshots(cached)
        self._record_fleet(merged, serve, snaps, burning, ts)
        self._attribute_costs(merged, serve, snaps, max(dt, 1e-9))
        return merged

    def _record_fleet(self, merged: Dict[str, Any], serve: Dict[str, Any],
                      fresh: Dict[str, Any], burning: List[str],
                      ts: float) -> None:
        ttft = merged.get("ttft_s") or {}
        exemplar = exemplar_trace_id(ttft)
        if exemplar is not None:
            with self._lock:
                self._last_exemplar = exemplar
        values: Dict[str, float] = {
            "fleet.engines": float(len([s for s in fresh.values()
                                        if s and "num_slots" in s])),
            "fleet.queue_depth": float(merged.get("queue_depth", 0)),
            "fleet.slot_occupancy": float(merged.get("slot_occupancy", 0)),
            "fleet.tokens_per_s": float(merged.get("tokens_per_s", 0.0)),
            "fleet.requests_completed": float(
                merged.get("requests_completed", 0)),
            "fleet.requests_rejected": float(
                merged.get("requests_rejected", 0)),
            "fleet.slo_burning": float(len(burning)),
        }
        if ttft.get("count"):
            values["fleet.ttft_p99_s"] = float(ttft.get("p99", 0.0))
        recovery = serve.get("recovery") or {}
        for metric, _kind in _RECOVERY_METRICS:
            key = metric.split(".", 1)[1]
            if key in recovery:
                values[metric] = float(recovery[key])
        for metric, value in values.items():
            self.store.record(metric, value, ts=ts)
        for metric, kind in (_FLEET_METRICS + _RECOVERY_METRICS
                             + (("fleet.slo_burning", "gauge"),)):
            if metric not in values:
                continue
            v = values[metric]
            if kind == "counter":
                with self._lock:
                    prev = self._counters.get(metric)
                    self._counters[metric] = v
                if prev is None:
                    continue
                if v < prev:  # counter reset: re-baseline, never fire
                    self.detector.reset(metric)
                    continue
                v = v - prev
            event = self.detector.observe(metric, v, ts=ts)
            if event is not None:
                with self._lock:
                    event["trace_exemplar"] = self._last_exemplar
                    self._events.append(event)
                    self.anomalies += 1

    def _attribute_costs(self, merged: Dict[str, Any],
                         serve: Dict[str, Any], fresh: Dict[str, Any],
                         dt: float) -> None:
        busy = total = 0.0
        for snap in fresh.values():
            if not snap or "num_slots" not in snap:
                continue  # synthetic partial snapshots carry no capacity
            chips = float((snap.get("topology") or {}).get("mesh_devices", 1))
            slots = max(int(snap.get("num_slots", 0)), 1)
            total += chips * dt
            busy += chips * dt * min(
                1.0, float(snap.get("slot_occupancy", 0)) / slots)
        admission: Dict[str, Dict[str, float]] = {}
        for route, ctl in serve.items():
            if not isinstance(ctl, dict):
                continue
            for tenant, c in ((ctl.get("admission") or {}).get("tenants")
                              or {}).items():
                agg = admission.setdefault(
                    tenant, {"admitted": 0.0, "sheds": 0.0,
                             "quota_rejected": 0.0})
                agg["admitted"] += float(c.get("admitted", 0))
                agg["sheds"] += float(c.get("shed", 0))
                agg["quota_rejected"] += float(c.get("quota_shed", 0))
        self.ledger.update(merged.get("tenants") or {}, admission,
                           busy_chip_seconds=busy, total_chip_seconds=total)

    # -- hooks / queries -----------------------------------------------------
    def note(self, kind: str, **attrs: Any) -> None:
        """Record a structured non-anomaly event (e.g. the preemption
        watcher's recovery notes) into the same ring ``/api/watch``
        serves."""
        event = {"event": kind, "ts": self._now(), **attrs}
        with self._lock:
            self._events.append(event)

    def events(self, limit: Optional[int] = None,
               kind: Optional[str] = None) -> List[Dict[str, Any]]:
        with self._lock:
            out = list(self._events)
        if kind is not None:
            out = [e for e in out if e.get("event") == kind]
        if limit is not None:
            out = out[-int(limit):]
        return out

    def anomalous(self, hold_s: Optional[float] = None) -> List[str]:
        """Metrics with a ``watch.anomaly`` inside the hold window — the
        autoscaler's third scale signal."""
        hold = self.config.anomaly_hold_s if hold_s is None else hold_s
        horizon = self._now() - hold
        with self._lock:
            return sorted({
                e["metric"] for e in self._events
                if e.get("event") == "watch.anomaly"
                and e.get("ts", 0.0) >= horizon})

    def cached_engine_stats(self) -> Dict[str, Dict[str, Any]]:
        """The scraper's TTL-governed view of replica snapshots: fresh
        entries verbatim, entries older than one interval age-marked with
        ``stale_s``, entries past ``config.ttl_s`` already evicted by the
        scrape loop (and re-filtered here for reads between scrapes)."""
        now = self._now()
        ttl = self.config.ttl_s
        out: Dict[str, Dict[str, Any]] = {}
        with self._lock:
            for key, (at, snap) in self._snap_cache.items():
                age = now - at
                if age > ttl:
                    continue
                if age > self.config.interval_s:
                    snap = dict(snap)
                    snap["stale_s"] = round(age, 3)
                out[key] = snap
        return out

    def payload(self) -> Dict[str, Any]:
        """The /api/watch JSON body."""
        with self._lock:
            scrapes = self.scrapes
            anomalies = self.anomalies
            last_ts = self._last_scrape_ts
            events = list(self._events)
        return {
            "enabled": True,
            "config": {
                "interval_s": self.config.interval_s,
                "seed": self.config.seed,
                "z_threshold": self.config.z_threshold,
                "warmup": self.config.warmup,
                "ttl_s": self.config.ttl_s,
            },
            "scrapes": scrapes,
            "last_scrape_ts": last_ts,
            "anomalies": anomalies,
            "events": events,
            "detector": self.detector.stats(),
            "store": self.store.stats(),
            "metrics": self.store.metrics(),
        }

    # -- scraper lifecycle ---------------------------------------------------
    def start_scraper(self) -> "FleetScraper":
        with self._lock:
            if self._scraper is None:
                self._scraper = FleetScraper(self)
            scraper = self._scraper
        scraper.start()
        return scraper

    def stop_scraper(self) -> None:
        with self._lock:
            scraper = self._scraper
            self._scraper = None
        if scraper is not None:
            scraper.stop()


class FleetScraper:
    """The collection loop: a driver-side daemon thread calling
    :meth:`Watch.scrape_once` every ``interval_s`` (Event.wait as the
    timer, so stop() interrupts a sleeping loop immediately — the same
    pattern as the autoscaler and preemption watcher).  All scraping I/O
    happens inside ``scrape_once`` outside any lock."""

    def __init__(self, watch: Watch):
        self._watch = watch
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "FleetScraper":
        with self._lock:
            if self._thread is None:
                self._stop.clear()
                self._thread = threading.Thread(
                    target=self._loop, daemon=True, name="airwatch-scraper")
                self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        with self._lock:
            thread = self._thread
            self._thread = None
        if thread is not None:
            thread.join(timeout=10.0)

    @property
    def running(self) -> bool:
        with self._lock:
            return self._thread is not None

    def _loop(self) -> None:
        while not self._stop.wait(self._watch.config.interval_s):
            try:
                self._watch.scrape_once()
            except Exception:  # noqa: BLE001 — one bad scrape must not end history
                pass


# ---------------------------------------------------------------------------
# process-wide registry (zero-cost-off: every hook is one global read)
# ---------------------------------------------------------------------------

_registry_lock = threading.Lock()
_watch: Optional[Watch] = None


def enabled() -> bool:
    """Fast global check — hooks guard on this before doing any work."""
    return _watch is not None


def current() -> Optional[Watch]:
    return _watch


def install(config: Optional[WatchConfig] = None, **kw: Any) -> Watch:
    """Install (and return) the process-wide Watch.  Does NOT start the
    scraper thread — ``serve.run`` starts it when a deployment exists to
    scrape, and tests drive :meth:`Watch.scrape_once` directly."""
    global _watch
    w = Watch(config, **kw)
    with _registry_lock:
        old, _watch = _watch, w
    if old is not None:
        old.stop_scraper()
    return w


def clear() -> None:
    """Tear down: stop the scraper (if running) and drop the Watch."""
    global _watch
    with _registry_lock:
        old, _watch = _watch, None
    if old is not None:
        old.stop_scraper()


def anomalous() -> List[str]:
    """Module-level convenience for the autoscaler's default anomaly
    source: recent anomaly metric names, empty when airwatch is off."""
    w = _watch
    return w.anomalous() if w is not None else []
