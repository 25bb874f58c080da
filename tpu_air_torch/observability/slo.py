"""airscope SLO monitor — declarative objectives, multi-window burn rates,
copied from ``tpu_air/observability/slo.py`` (the port imports nothing of
``tpu_air``; the objectives, defaults and ``tpu_air_slo_*`` families are the
JAX package's).

An :class:`SLO` names a latency distribution inside the engine snapshots
(a dotted path like ``"priority.interactive.ttft_s"``), a good-event
threshold (``sample <= threshold_s``) and an objective (e.g. 0.999 = at
most 0.1% of samples over threshold).  The :class:`SLOMonitor` turns the
UNWINDOWED histograms the engines now export into windowed error rates by
remembering timestamped cumulative ``(good, total)`` pairs and differencing
them — the standard trick for deriving rates from counters, which is what
makes the histograms' mergeability matter: the monitor sums buckets across
every engine/replica snapshot before differencing, so the SLO is evaluated
over the FLEET, not per replica.

Burn rate is ``error_rate / error_budget`` where the budget is
``1 - objective``; a burn rate of 1.0 spends the budget exactly at the
objective's horizon.  Each SLO carries several ``(window_s, max_burn)``
pairs and is *burning* only when EVERY window exceeds its threshold —
multi-window multi-burn-rate alerting (Google SRE workbook ch.5): the
short window proves the problem is still happening, the long window proves
it is big enough to matter.

Surfaced at the dashboard's ``/api/slo`` and as ``tpu_air_slo_*``
prometheus lines; the serve autoscaler consumes :func:`burning_slos` as a
scale-up signal alongside raw p99 (serve/autoscaler.py).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

from .perf import bucket_upper

# page-style defaults: 5m fast burn (2h to empty a 30d budget at 14.4x)
# AND 1h slow burn — both must fire
DEFAULT_WINDOWS: Tuple[Tuple[float, float], ...] = (
    (300.0, 14.4),
    (3600.0, 6.0),
)


@dataclass(frozen=True)
class SLO:
    """One objective over one engine-snapshot metric.

    * ``metric`` — dotted path into an engine snapshot.  What it must
      resolve to depends on ``kind``.
    * ``kind`` — how samples become (good, total) events:

      - ``"histogram"`` (default) — the path ends at a distribution dict
        with ``buckets``; every recorded sample is an event, good when at
        or under ``threshold_s``.
      - ``"counter"`` — the path ends at a cumulative NUMBER whose every
        increment is a BAD event (``migration_fallbacks``,
        ``journal_evicted_live`` — gauges that must not move).  Any
        in-window movement spends budget at rate 1.0, so the SLO burns
        exactly while the counter is moving; ``threshold_s`` is unused.
      - ``"gauge"`` — the path ends at a NUMBER sampled once per observe;
        each observation is one event, good when the value is at or
        under ``threshold_s`` IN THE METRIC'S OWN UNITS (e.g.
        ``preemption_recovery_ms`` against a millisecond threshold).

    * ``threshold_s`` — good-event cutoff (seconds for histogram paths,
      the metric's units for gauges).
    * ``objective`` — target good fraction (0.99 → 1% error budget).
    * ``windows`` — ``(window_s, max_burn_rate)`` pairs; ALL must exceed
      for the SLO to report burning.
    """

    name: str
    metric: str
    threshold_s: float
    objective: float = 0.99
    windows: Tuple[Tuple[float, float], ...] = DEFAULT_WINDOWS
    kind: str = "histogram"

    def __post_init__(self):
        if not 0.0 < self.objective < 1.0:
            raise ValueError(f"objective must be in (0,1), got {self.objective}")
        if self.threshold_s <= 0:
            raise ValueError("threshold_s must be positive")
        if not self.windows:
            raise ValueError("at least one (window_s, max_burn) pair required")
        if self.kind not in ("histogram", "counter", "gauge"):
            raise ValueError(f"unknown SLO kind {self.kind!r}")


def count_le(buckets: Dict[str, Any], threshold: float) -> float:
    """Samples at or below ``threshold`` in a serialized bucket dict,
    linearly interpolating inside the straddling bucket (same model the
    quantile uses, so the two are consistent)."""
    good = 0.0
    for key, n in (buckets or {}).items():
        idx = int(key)
        hi = bucket_upper(idx)
        if hi <= threshold:
            good += n
        else:
            lo = bucket_upper(idx - 1)
            if lo < threshold:
                good += n * (threshold - lo) / (hi - lo)
    return good


def _dig(snapshot: Dict[str, Any], path: str) -> Optional[Dict[str, Any]]:
    cur: Any = snapshot
    for part in path.split("."):
        if not isinstance(cur, dict):
            return None
        cur = cur.get(part)
    return cur if isinstance(cur, dict) else None


def _dig_scalar(snapshot: Dict[str, Any], path: str) -> Optional[float]:
    """Like :func:`_dig` but the path must end at a number (counter and
    gauge SLO kinds)."""
    cur: Any = snapshot
    for part in path.split("."):
        if not isinstance(cur, dict):
            return None
        cur = cur.get(part)
    if isinstance(cur, bool) or not isinstance(cur, (int, float)):
        return None
    return float(cur)


@dataclass
class _History:
    # (ts, good, total) cumulative pairs, oldest first
    points: Deque[Tuple[float, float, float]] = field(default_factory=deque)


class SLOMonitor:
    """Evaluates a set of SLOs against an engine-snapshot source.

    ``source`` returns ``{engine_name: snapshot}`` (the shape of
    ``dashboard.engine_stats()`` — driver engines merged with serve
    replicas); the monitor walks each SLO's metric path in EVERY snapshot
    and sums bucket counts, so replicas aggregate before rates are taken.
    ``now`` is injectable for deterministic window tests.
    """

    def __init__(self, slos: List[SLO],
                 source: Optional[Callable[[], Dict[str, Any]]] = None,
                 now: Callable[[], float] = time.monotonic):
        names = [s.name for s in slos]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate SLO names: {names}")
        self.slos = tuple(slos)
        self._source = source
        self._now = now
        self._lock = threading.Lock()
        self._history: Dict[str, _History] = {s.name: _History()
                                              for s in slos}
        # gauge-kind SLOs build their own cumulative (good, total) pairs —
        # one event per observe — since the snapshot only carries the
        # instantaneous value
        self._gauge_acc: Dict[str, List[float]] = {}

    # -- sampling ------------------------------------------------------------
    def observe(self, snapshots: Optional[Dict[str, Any]] = None) -> None:
        """Take one cumulative sample per SLO from ``snapshots`` (or the
        configured source).  Call periodically — the dashboard calls it on
        every /api/slo + /metrics scrape, the autoscaler every tick."""
        if snapshots is None:
            if self._source is None:
                return
            try:
                snapshots = self._source() or {}
            except Exception:  # noqa: BLE001 — a failed scrape must not poison the monitor
                return
        ts = self._now()
        totals: Dict[str, Tuple[float, float]] = {}
        gauge_raw: Dict[str, Optional[float]] = {}
        for slo in self.slos:
            if slo.kind == "counter":
                # every increment of the summed cumulative counter is a
                # bad event: good stays 0, total tracks the counter, so a
                # moving counter burns at rate 1.0 and a still one at 0
                total = 0.0
                for snap in snapshots.values():
                    v = _dig_scalar(snap or {}, slo.metric)
                    if v is not None:
                        total += v
                totals[slo.name] = (0.0, total)
                continue
            if slo.kind == "gauge":
                # worst instantaneous value across snapshots this observe;
                # turned into one cumulative event under the lock below
                worst: Optional[float] = None
                for snap in snapshots.values():
                    v = _dig_scalar(snap or {}, slo.metric)
                    if v is not None:
                        worst = v if worst is None else max(worst, v)
                gauge_raw[slo.name] = worst
                continue
            good = total = 0.0
            for snap in snapshots.values():
                d = _dig(snap or {}, slo.metric)
                if not d or not d.get("count"):
                    continue
                buckets = d.get("buckets")
                if buckets:
                    total += sum(buckets.values())
                    good += count_le(buckets, slo.threshold_s)
            totals[slo.name] = (good, total)
        max_window = max(w for slo in self.slos for w, _ in slo.windows)
        with self._lock:
            for slo in self.slos:
                hist = self._history[slo.name]
                if slo.kind == "gauge":
                    raw = gauge_raw.get(slo.name)
                    if raw is None:
                        continue  # metric absent — no event this observe
                    acc = self._gauge_acc.setdefault(slo.name, [0.0, 0.0])
                    acc[1] += 1.0
                    if raw <= slo.threshold_s:
                        acc[0] += 1.0
                    good, total = acc[0], acc[1]
                else:
                    good, total = totals[slo.name]
                # cumulative counters only move forward; an engine restart
                # (counts drop) resets this SLO's history
                if hist.points and total < hist.points[-1][2]:
                    hist.points.clear()
                hist.points.append((ts, good, total))
                horizon = ts - max_window - 1.0
                while len(hist.points) > 2 and hist.points[1][0] < horizon:
                    hist.points.popleft()

    # -- evaluation ----------------------------------------------------------
    def state(self) -> List[Dict[str, Any]]:
        """Per-SLO burn-rate state (the /api/slo payload)."""
        ts = self._now()
        out = []
        with self._lock:
            for slo in self.slos:
                pts = self._history[slo.name].points
                cur = pts[-1] if pts else (ts, 0.0, 0.0)
                windows = []
                burning = bool(pts)
                budget = 1.0 - slo.objective
                for window_s, max_burn in slo.windows:
                    base = self._point_at(pts, ts - window_s)
                    d_total = cur[2] - base[2]
                    d_err = (cur[2] - cur[1]) - (base[2] - base[1])
                    rate = (d_err / d_total) if d_total > 0 else 0.0
                    burn = rate / budget
                    exceeded = d_total > 0 and burn >= max_burn
                    windows.append({
                        "window_s": window_s,
                        "max_burn": max_burn,
                        "error_rate": rate,
                        "burn_rate": burn,
                        "exceeded": exceeded,
                    })
                    burning = burning and exceeded
                out.append({
                    "name": slo.name,
                    "metric": slo.metric,
                    "threshold_s": slo.threshold_s,
                    "objective": slo.objective,
                    "good": cur[1],
                    "total": cur[2],
                    "windows": windows,
                    "burning": burning,
                })
        return out

    @staticmethod
    def _point_at(pts, cutoff: float) -> Tuple[float, float, float]:
        """Latest cumulative sample at or before ``cutoff`` (the window's
        left edge); the oldest sample when history is shorter than the
        window — the window degrades to 'since monitoring began'."""
        if not pts:
            return (cutoff, 0.0, 0.0)
        best = pts[0]
        for p in pts:
            if p[0] <= cutoff:
                best = p
            else:
                break
        return best

    def burning(self) -> List[str]:
        """Names of SLOs currently burning on every window."""
        return [s["name"] for s in self.state() if s["burning"]]

    def prometheus_lines(self) -> List[str]:
        lines = []
        state = self.state()
        if state:
            lines.append("# HELP tpu_air_slo_burn_rate error budget burn"
                         " rate per evaluation window")
            lines.append("# TYPE tpu_air_slo_burn_rate gauge")
            for s in state:
                for w in s["windows"]:
                    lines.append(
                        f'tpu_air_slo_burn_rate{{slo="{s["name"]}",'
                        f'window="{w["window_s"]:g}s"}} '
                        f'{w["burn_rate"]:.6f}')
            lines.append("# HELP tpu_air_slo_burning 1 when every window"
                         " exceeds its burn threshold")
            lines.append("# TYPE tpu_air_slo_burning gauge")
            for s in state:
                lines.append(
                    f'tpu_air_slo_burning{{slo="{s["name"]}"}} '
                    f'{int(s["burning"])}')
            lines.append("# HELP tpu_air_slo_good_total cumulative good"
                         " events (samples within threshold)")
            lines.append("# TYPE tpu_air_slo_good_total counter")
            for s in state:
                lines.append(
                    f'tpu_air_slo_good_total{{slo="{s["name"]}"}} '
                    f'{s["good"]:.1f}')
            lines.append("# HELP tpu_air_slo_events_total cumulative"
                         " events observed for the objective")
            lines.append("# TYPE tpu_air_slo_events_total counter")
            for s in state:
                lines.append(
                    f'tpu_air_slo_events_total{{slo="{s["name"]}"}} '
                    f'{s["total"]:.1f}')
        return lines


def default_slos() -> List[SLO]:
    """The serve plane's stock objectives: interactive TTFT under 1s at
    99.9%, any-class TTFT under 5s at 99%, plus the PR-15 recovery gauges
    (exported by the supervisor into the ``serve-recovery``
    pseudo-snapshot the dashboard source injects): worst preemption
    recovery under 2s, and the two must-not-move counters — migration
    fallbacks and live journal evictions — whose every increment is an
    error event."""
    return [
        SLO(name="interactive-ttft", threshold_s=1.0, objective=0.999,
            metric="priority.interactive.ttft_s"),
        SLO(name="ttft", threshold_s=5.0, objective=0.99,
            metric="ttft_s"),
        SLO(name="preemption-recovery", threshold_s=2000.0, objective=0.99,
            metric="preemption_recovery_ms", kind="gauge"),
        SLO(name="migration-fallbacks", threshold_s=1.0, objective=0.999,
            metric="migration_fallbacks", kind="counter"),
        SLO(name="journal-evicted-live", threshold_s=1.0, objective=0.999,
            metric="journal_evicted_live", kind="counter"),
    ]


# -- process-wide registry ---------------------------------------------------
# the dashboard and autoscaler read whatever monitor the app installed;
# install(None) tears down (tests)

_installed: Optional[SLOMonitor] = None
_registry_lock = threading.Lock()


def install(monitor: Optional[SLOMonitor]) -> Optional[SLOMonitor]:
    global _installed
    with _registry_lock:
        _installed = monitor
    return monitor


def monitor() -> Optional[SLOMonitor]:
    with _registry_lock:
        return _installed


def ensure_default(source: Callable[[], Dict[str, Any]]) -> SLOMonitor:
    """Install the default SLO set over ``source`` unless a monitor is
    already installed; returns the active monitor either way."""
    global _installed
    with _registry_lock:
        if _installed is None:
            _installed = SLOMonitor(default_slos(), source=source)
        return _installed
