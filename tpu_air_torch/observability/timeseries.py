"""airwatch ring-buffer time-series store — fixed-step downsampling tiers,
copied from ``tpu_air/observability/timeseries.py`` (the port imports
nothing of ``tpu_air``).

Every other observability surface in the repo is point-in-time (airtrace
shows one request, airscope snapshots one engine, ``/api/*`` the current
instant).  This module is the HISTORY: a pure-stdlib, process-local store
holding one ring of fixed-step buckets per (metric, tier), so "what did
the fleet look like five minutes ago" is answerable without an external
scrape stack.

Tiers downsample by construction, not by background compaction: a sample
is folded into EVERY tier's current bucket on :meth:`record` (the 1s tier
keeps 10 minutes at full resolution, the 10s tier an hour, the 60s tier a
day — ``DEFAULT_TIERS``).  A bucket aggregates ``count/sum/min/max/last``,
which is everything the anomaly detector (watch.py) and a dashboard
sparkline need; full distributions stay in the airscope histograms the
scraper merges separately.

Rings are ``collections.deque`` with ``maxlen`` — eviction is O(1) and
memory is bounded at ``sum(capacity for _, capacity in tiers)`` buckets
per metric.  The clock is injectable (``now=``) so the downsample tests
drive tier boundaries deterministically.  All methods are thread-safe
behind one lock; nothing under the lock blocks.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

#: (step_s, capacity) per tier: 1s x 600 (10 min) -> 10s x 360 (1 h)
#: -> 60s x 1440 (1 day)
DEFAULT_TIERS: Tuple[Tuple[float, int], ...] = (
    (1.0, 600),
    (10.0, 360),
    (60.0, 1440),
)

# bucket list layout (a list, not a dataclass: these are the store's hot
# allocation and rings hold thousands of them)
_START, _COUNT, _SUM, _MIN, _MAX, _LAST = range(6)


class TimeSeriesStore:
    """Per-metric ring buffers over fixed-step downsampling tiers."""

    def __init__(self, tiers: Tuple[Tuple[float, int], ...] = DEFAULT_TIERS,
                 now: Callable[[], float] = time.monotonic):
        if not tiers:
            raise ValueError("at least one (step_s, capacity) tier required")
        for step, cap in tiers:
            if step <= 0 or cap < 1:
                raise ValueError(f"bad tier ({step}, {cap})")
        self.tiers = tuple((float(step), int(cap)) for step, cap in tiers)
        self._now = now
        self._lock = threading.Lock()
        # metric -> [ring per tier]; ring holds bucket lists, oldest first
        self._series: Dict[str, List[Deque[list]]] = {}
        self._recorded = 0

    # -- recording -----------------------------------------------------------
    def record(self, metric: str, value: float,
               ts: Optional[float] = None) -> None:
        """Fold one sample into every tier's bucket at ``ts`` (defaults to
        the injected clock).  Samples older than a tier's newest bucket
        fold into that newest bucket — the store assumes a monotonic
        feeder and degrades gracefully rather than re-sorting."""
        v = float(value)
        t = self._now() if ts is None else float(ts)
        with self._lock:
            rings = self._series.get(metric)
            if rings is None:
                rings = [deque(maxlen=cap) for _, cap in self.tiers]
                self._series[metric] = rings
            self._recorded += 1
            for (step, _cap), ring in zip(self.tiers, rings):
                start = (t // step) * step
                if ring and start <= ring[-1][_START]:
                    b = ring[-1]  # same bucket (or a late sample): aggregate
                    b[_COUNT] += 1
                    b[_SUM] += v
                    if v < b[_MIN]:
                        b[_MIN] = v
                    if v > b[_MAX]:
                        b[_MAX] = v
                    b[_LAST] = v
                else:
                    ring.append([start, 1, v, v, v, v])

    # -- reading -------------------------------------------------------------
    def metrics(self) -> List[str]:
        with self._lock:
            return sorted(self._series)

    def _ring(self, metric: str, step: Optional[float]) -> Optional[Deque]:
        rings = self._series.get(metric)
        if rings is None:
            return None
        if step is None:
            return rings[0]
        for (tier_step, _cap), ring in zip(self.tiers, rings):
            if tier_step == float(step):
                return ring
        raise KeyError(f"no tier with step {step!r} "
                       f"(have {[s for s, _ in self.tiers]})")

    def series(self, metric: str, step: Optional[float] = None,
               since: Optional[float] = None,
               limit: Optional[int] = None) -> List[Dict[str, Any]]:
        """Buckets for one metric on one tier (default: the finest),
        oldest first, as JSON-ready dicts.  ``since`` filters by bucket
        start; ``limit`` keeps the newest N."""
        with self._lock:
            ring = self._ring(metric, step)
            buckets = list(ring) if ring else []
        if since is not None:
            buckets = [b for b in buckets if b[_START] >= since]
        if limit is not None and limit >= 0:
            buckets = buckets[-limit:]
        return [
            {
                "ts": b[_START],
                "count": b[_COUNT],
                "sum": b[_SUM],
                "min": b[_MIN],
                "max": b[_MAX],
                "last": b[_LAST],
                "mean": b[_SUM] / b[_COUNT],
            }
            for b in buckets
        ]

    def latest(self, metric: str) -> Optional[float]:
        """Most recent sample value (finest tier's newest bucket)."""
        with self._lock:
            ring = self._ring(metric, None)
            return ring[-1][_LAST] if ring else None

    def window(self, metric: str, seconds: float,
               step: Optional[float] = None) -> List[float]:
        """Per-bucket LAST values covering the trailing ``seconds`` on one
        tier — the anomaly detector's view (watch.py reads the 1s tier)."""
        horizon = self._now() - float(seconds)
        with self._lock:
            ring = self._ring(metric, step)
            if not ring:
                return []
            return [b[_LAST] for b in ring if b[_START] >= horizon]

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "tiers": [{"step_s": s, "capacity": c} for s, c in self.tiers],
                "metrics": len(self._series),
                "samples_recorded": self._recorded,
                "buckets_resident": sum(
                    len(r) for rings in self._series.values() for r in rings),
            }
