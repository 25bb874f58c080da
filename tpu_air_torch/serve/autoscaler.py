"""Gauge-driven replica autoscaling for a serve deployment, copied from
``tpu_air/serve/autoscaler.py`` (the port imports nothing of ``tpu_air``).

The :class:`Autoscaler` is a DRIVER-SIDE control loop (a daemon thread in
the proxy's process, NOT an actor — nothing here blocks a worker message
loop) that scales one deployment between ``min_replicas`` and
``max_replicas`` on signals from the live engine gauges:

* **queue pressure** — mean engine admission-queue depth per live replica
  at or above ``scale_up_queue_depth`` means arrivals outrun service:
  add a replica (a new actor + chip lease through the runtime's normal
  placement path — ``DeploymentHandle.scale_up``).
* **TTFT budget** — when ``ttft_budget_s`` is set and the interactive
  class's observed p99 TTFT exceeds it, scale up even if queues look
  shallow (latency is the SLO, queue depth only its proxy).
* **SLO burn rate** — when an airscope SLO monitor reports an objective
  burning on every evaluation window (observability/slo.py), scale up:
  the burn-rate signal fires on *error-budget spend velocity*, which
  catches a slow degradation a raw p99 threshold misses and stays quiet
  through brief spikes a p99 threshold would overreact to.
  ``slo_source`` is injectable like ``gauge_source``; by default the
  process-wide installed monitor (``observability.slo.install``) is
  consulted, so wiring a monitor up is enough.
* **anomaly detection** — when airwatch (observability/watch.py) is
  installed, a recent ``watch.anomaly`` on any fleet metric is a third
  scale-up signal of equal rank: the detector catches step changes
  (a replica death's throughput cliff, a queue-depth spike) one scrape
  after they happen, before a burn-rate window can confirm them.
  ``anomaly_source`` is injectable the same way; off ⇒ one global read.

Scale-DOWN is deliberately timid: only after ``scale_down_idle_ticks``
CONSECUTIVE ticks with empty queues and zero slot occupancy, and never
below ``min_replicas``.  A scale-down drains the victim replica first
(``DeploymentHandle.scale_down`` → drain → lease release), so in-flight
streams never notice.  ``cooldown_s`` separates consecutive scaling
actions in either direction — one decision gets to take effect before
the next is made.

``gauge_source`` is injectable (any callable returning
``DeploymentHandle.engine_stats``-shaped snapshots), which is how the
unit tests drive :meth:`tick` against synthetic gauges without replicas.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from time import monotonic
from typing import Any, Callable, Dict, Iterable, Optional, Tuple


def _installed_monitor_burning() -> Tuple[str, ...]:
    """Default ``slo_source``: sample + evaluate the process-wide airscope
    SLO monitor, empty when none is installed."""
    from tpu_air_torch.observability import slo as _slo

    mon = _slo.monitor()
    if mon is None:
        return ()
    mon.observe()
    return tuple(mon.burning())


def _installed_watch_anomalies() -> Tuple[str, ...]:
    """Default ``anomaly_source``: metrics the installed airwatch detector
    flagged inside its hold window; empty when airwatch is off (the
    zero-cost-off path is one module-global read)."""
    from tpu_air_torch.observability import watch as _watch

    if not _watch.enabled():
        return ()
    return tuple(_watch.anomalous())


@dataclass(frozen=True)
class AutoscalerConfig:
    """Dials for one deployment's autoscaler.

    * ``min_replicas`` / ``max_replicas`` — the scaling envelope.
    * ``scale_up_queue_depth`` — mean queued requests per live replica
      that triggers a scale-up.
    * ``ttft_budget_s`` — optional interactive p99 TTFT ceiling; observed
      p99 above it also triggers a scale-up.  None disables the signal.
    * ``scale_down_idle_ticks`` — consecutive idle ticks (queues empty,
      slots empty) before one replica is drained away.
    * ``tick_s`` — control-loop period.
    * ``cooldown_s`` — minimum spacing between scaling actions.
    """

    min_replicas: int = 1
    max_replicas: int = 4
    scale_up_queue_depth: float = 8.0
    ttft_budget_s: Optional[float] = None
    scale_down_idle_ticks: int = 10
    tick_s: float = 0.5
    cooldown_s: float = 5.0


class Autoscaler:
    """One deployment's scaling loop (see module doc)."""

    def __init__(self, handle, config: Optional[AutoscalerConfig] = None, *,
                 gauge_source: Optional[Callable[[], Dict[str, Any]]] = None,
                 slo_source: Optional[Callable[[], Iterable[str]]] = None,
                 anomaly_source: Optional[Callable[[],
                                                   Iterable[str]]] = None):
        self._handle = handle
        self.config = config or AutoscalerConfig()
        if self.config.min_replicas < 1:
            raise ValueError("min_replicas must be >= 1")
        if self.config.max_replicas < self.config.min_replicas:
            raise ValueError("max_replicas must be >= min_replicas")
        self._gauge_source = gauge_source or handle.engine_stats
        # returns the names of SLOs currently burning (scale-up signal);
        # default reads whatever monitor the app installed process-wide
        self._slo_source = slo_source or _installed_monitor_burning
        # third scale signal: metrics the airwatch anomaly detector
        # flagged recently (observability/watch.py) — a detected step
        # change in fleet behavior ranks with queue depth and SLO burn
        self._anomaly_source = anomaly_source or _installed_watch_anomalies
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # decision state below is written by the tick thread and read by
        # stats() from arbitrary proxy threads — every access goes through
        # _lock (the blocking scale_up/scale_down calls stay outside it)
        self._lock = threading.Lock()
        self._idle_ticks = 0
        self._last_action_at = -1e18  # monotonic stamp of the last scale
        self.scale_ups = 0
        self.scale_downs = 0
        self.preemption_scale_ups = 0
        self.last_decision = "hold"
        self.last_burning: tuple = ()
        self.last_anomalies: tuple = ()

    # -- pure policy ----------------------------------------------------------
    def decide(self, snapshots: Dict[str, Dict[str, Any]],
               replicas: int, burning: Iterable[str] = (),
               anomalies: Iterable[str] = ()) -> str:
        """``"up"`` / ``"down"`` / ``"hold"`` for one tick's gauges.  Pure
        (no side effects, no cooldown) — the unit-testable core.

        ``burning`` names SLOs whose error budget is burning on every
        evaluation window (observability/slo.py); ``anomalies`` names
        metrics the airwatch detector flagged (observability/watch.py).
        Any entry in either is a scale-up signal of equal rank with queue
        depth and the p99 budget.

        The idle streak that gates scale-down is tracked by :meth:`tick`;
        this method only answers whether THIS tick looks idle (``"down"``
        here means "idle and above min", which tick() demotes to hold
        until the streak is long enough)."""
        cfg = self.config
        if replicas < cfg.min_replicas:
            return "up"
        depth = sum(int(s.get("queue_depth", 0)) for s in snapshots.values())
        occupancy = sum(int(s.get("slot_occupancy", 0))
                        for s in snapshots.values())
        if replicas < cfg.max_replicas:
            if depth / max(replicas, 1) >= cfg.scale_up_queue_depth:
                return "up"
            if any(True for _ in burning):
                return "up"
            if any(True for _ in anomalies):
                return "up"
            if cfg.ttft_budget_s is not None:
                p99 = self._interactive_p99(snapshots)
                if p99 is not None and p99 > cfg.ttft_budget_s:
                    return "up"
        if replicas > cfg.min_replicas and depth == 0 and occupancy == 0:
            return "down"
        return "hold"

    @staticmethod
    def _interactive_p99(snapshots: Dict[str, Dict[str, Any]]
                         ) -> Optional[float]:
        """Worst interactive-class p99 TTFT across replicas, None when no
        replica has interactive samples yet."""
        worst = None
        for s in snapshots.values():
            d = ((s.get("priority") or {}).get("interactive") or {}).get(
                "ttft_s") or {}
            if d.get("count"):
                p99 = float(d["p99"])
                worst = p99 if worst is None else max(worst, p99)
        return worst

    # -- the loop -------------------------------------------------------------
    def tick(self) -> str:
        """One control iteration: scrape, decide, maybe act.  Returns the
        ACTION taken (``"up"`` / ``"down"`` / ``"hold"``)."""
        cfg = self.config
        try:
            snapshots = self._gauge_source() or {}
        except Exception:  # noqa: BLE001 — a failed scrape must not kill the loop
            snapshots = {}
        replicas = self._handle.num_replicas()
        try:
            burning = tuple(self._slo_source() or ())
        except Exception:  # noqa: BLE001 — a broken SLO source must not kill the loop
            burning = ()
        try:
            anomalies = tuple(self._anomaly_source() or ())
        except Exception:  # noqa: BLE001 — a broken detector must not kill the loop
            anomalies = ()
        decision = self.decide(snapshots, replicas, burning, anomalies)
        # the idle streak: only an unbroken run of idle ticks earns a
        # scale-down; any non-idle tick resets it
        with self._lock:
            if decision == "down":
                self._idle_ticks += 1
                if self._idle_ticks < cfg.scale_down_idle_ticks:
                    decision = "hold"
            else:
                self._idle_ticks = 0
            self.last_decision = decision
            self.last_burning = burning
            self.last_anomalies = anomalies
            if decision == "hold":
                return "hold"
            if monotonic() - self._last_action_at < cfg.cooldown_s:
                return "hold"
        if decision == "up":
            if self._handle.scale_up():
                with self._lock:
                    self.scale_ups += 1
                    self._last_action_at = monotonic()
                return "up"
            return "hold"
        # down: drain + release; blocking here is fine (driver-side thread)
        if self._handle.scale_down():
            with self._lock:
                self.scale_downs += 1
                self._idle_ticks = 0
                self._last_action_at = monotonic()
            return "down"
        return "hold"

    def notice_scale_up(self) -> bool:
        """Preemption signal (serve/supervisor.py PreemptionWatcher): a
        lease-revocation notice means capacity is about to LEAVE, which is
        a stronger fact than any gauge — add a replica immediately,
        bypassing the cooldown (the cooldown paces reactions to noisy
        load signals, not to announced capacity loss) and the idle
        streak.  No-op at ``max_replicas``.  Returns whether a replica
        was added."""
        if self._handle.num_replicas() >= self.config.max_replicas:
            return False
        if self._handle.scale_up():
            with self._lock:
                self.scale_ups += 1
                self.preemption_scale_ups += 1
                self._idle_ticks = 0
                self._last_action_at = monotonic()
                self.last_decision = "up"
            return True
        return False

    def _loop(self) -> None:
        # Event.wait as the tick timer: stop() interrupts a sleeping loop
        # immediately instead of waiting out the period
        while not self._stop.wait(self.config.tick_s):
            self.tick()

    def start(self) -> "Autoscaler":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, daemon=True,
                name=f"serve-autoscaler-{self._handle.deployment_name}",
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None

    # -- observability --------------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        replicas = self._handle.num_replicas()  # foreign call: outside _lock
        with self._lock:
            return {
                "min_replicas": self.config.min_replicas,
                "max_replicas": self.config.max_replicas,
                "replicas": replicas,
                "scale_ups": self.scale_ups,
                "scale_downs": self.scale_downs,
                "preemption_scale_ups": self.preemption_scale_ups,
                "idle_ticks": self._idle_ticks,
                "last_decision": self.last_decision,
                "burning_slos": list(self.last_burning),
                "anomalies": list(self.last_anomalies),
            }
