"""SLO-aware admission for the serve proxy.  Copied from
``tpu_air/serve/admission.py`` (the port imports nothing of ``tpu_air``).

The proxy used to answer overload with a binary 503 (whatever the engine's
admission queue said).  This module moves the decision UP to the serve
plane, where it can be class-aware and gauge-driven:

* every request carries a priority class (``interactive`` / ``batch`` /
  ``best_effort``, :data:`tpu_air_torch.engine.types.PRIORITIES`) and gets a
  per-class TOKEN BUDGET clamp (a best-effort client cannot reserve a
  1000-token decode during a surge);
* the controller scrapes the deployment's live engine gauges
  (``DeploymentHandle.engine_stats`` — queue depth, slot occupancy, KV
  pressure) on a short TTL and turns them into one scalar: mean queued
  depth per live replica;
* under pressure the TAIL classes degrade first — best-effort starts
  QUEUEING at ``queue_soft`` (the request waits proxy-side, bounded by its
  class's ``queue_timeout_s``) and SHEDS at ``queue_high``; batch queues
  at ``queue_high`` and sheds at ``queue_hard``; interactive is admitted
  at every depth this controller sees (its own ceiling is the engine's
  class-aware queue cap).  Shed responses are 503 + ``Retry-After``.

The same scrape feeds the handle's least-loaded routing — the handle
records per-replica loads as a side effect of ``engine_stats`` — so one
gauge pass serves admission, routing and the autoscaler.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

from tpu_air_torch.core.runtime import TpuAirError
from tpu_air_torch.engine.types import PRIORITIES

#: default per-class max_new_tokens clamps (requests asking for more are
#: trimmed, not refused — the stream just ends at the budget)
_DEFAULT_TOKEN_BUDGETS = {
    "interactive": 256,
    "batch": 1024,
    "best_effort": 512,
}

#: default proxy-side queue waits before a "queue" decision becomes a shed
_DEFAULT_QUEUE_TIMEOUTS = {
    "interactive": 0.0,   # interactive never waits at the proxy
    "batch": 2.0,
    "best_effort": 5.0,
}


class AdmissionShedError(TpuAirError):
    """The admission controller refused this request (overload).  Maps to
    HTTP 503 + ``Retry-After`` — same retry contract as engine
    backpressure, decided one hop earlier and class-aware."""

    def __init__(self, msg: str, retry_after_s: float = 1.0):
        super().__init__(msg)
        self.retry_after_s = retry_after_s


class QuotaExceededError(AdmissionShedError):
    """One TENANT (``adapter_id``) is over its per-tenant queue share —
    not a capacity problem, a fairness one, so it maps to HTTP 429 (the
    client is the thing to slow down, not the fleet) while still carrying
    ``Retry-After``.  Subclasses :class:`AdmissionShedError` so callers
    that only know the overload contract keep working; the proxy catches
    THIS class first to pick the status code."""

    def __init__(self, msg: str, retry_after_s: float = 1.0,
                 adapter_id: Optional[str] = None):
        super().__init__(msg, retry_after_s=retry_after_s)
        self.adapter_id = adapter_id


@dataclass(frozen=True)
class AdmissionPolicy:
    """Dials for one route's admission controller.

    Depth thresholds are MEAN QUEUED REQUESTS PER LIVE REPLICA (engine
    admission queue depth, from ``engine_stats``), so they keep meaning
    as the autoscaler changes the replica count:

    * ``queue_soft`` — best-effort starts queueing proxy-side;
    * ``queue_high`` — best-effort sheds; batch starts queueing;
    * ``queue_hard`` — batch sheds (interactive still admits — the
      engine's own class-aware cap is its ceiling).

    ``token_budgets`` clamps per-request ``max_new_tokens`` by class;
    ``queue_timeout_s`` bounds the proxy-side wait before a queued class
    sheds; ``stats_ttl_s`` is the gauge-scrape cache horizon (stale stats
    also disable least-loaded routing in the handle); ``retry_after_s``
    rides back on shed responses as the ``Retry-After`` header.

    Per-TENANT quotas (multi-tenant LoRA serving — the tenant key is the
    request's ``adapter_id``, ``None`` meaning the base-model tenant):

    * ``tenant_token_budgets`` — per-tenant ``max_new_tokens`` caps,
      composing with the class budget by MIN (the tighter bound wins);
    * ``tenant_queue_shares`` — fraction of total route capacity
      (``queue_hard × live replicas``) one tenant may hold IN FLIGHT at
      once.  Over-share submits raise :class:`QuotaExceededError`
      (HTTP 429 + ``Retry-After``) regardless of class — quotas compose
      with priority, they don't replace it.  Tenants absent from the
      mapping are unmetered."""

    token_budgets: Dict[str, int] = field(
        default_factory=lambda: dict(_DEFAULT_TOKEN_BUDGETS))
    queue_soft: float = 4.0
    queue_high: float = 12.0
    queue_hard: float = 32.0
    queue_timeout_s: Dict[str, float] = field(
        default_factory=lambda: dict(_DEFAULT_QUEUE_TIMEOUTS))
    queue_poll_s: float = 0.05
    retry_after_s: float = 1.0
    stats_ttl_s: float = 0.25
    tenant_token_budgets: Optional[Dict[str, int]] = None
    tenant_queue_shares: Optional[Dict[str, float]] = None

    def clamp_budget(self, priority: str,
                     max_new_tokens: Optional[int],
                     adapter_id: Optional[str] = None) -> Optional[int]:
        """The effective decode budget for one request of this class (and
        tenant).  An INTERACTIVE request with an unset ask stays unset —
        the engine config's own default (sized to its slots) governs; the
        class budget only trims explicit asks.  The TAIL classes
        (``batch``/``best_effort``) get their class budget applied even to
        UNSET asks: a batch flood that omits ``max_new_tokens`` must not
        default to the engine max.  A tenant budget composes by MIN with
        the class budget and also caps unset asks for every class (a
        metered tenant must not inherit the engine default)."""
        cap = self.token_budgets.get(priority)
        tenant_cap = None
        if self.tenant_token_budgets is not None and adapter_id is not None:
            tenant_cap = self.tenant_token_budgets.get(adapter_id)
        if max_new_tokens is None:
            caps = [c for c in (tenant_cap,
                                cap if priority in ("batch", "best_effort")
                                else None)
                    if c is not None]
            return min(int(c) for c in caps) if caps else None
        out = int(max_new_tokens)
        if cap is not None:
            out = min(out, int(cap))
        if tenant_cap is not None:
            out = min(out, int(tenant_cap))
        return out

    def tenant_inflight_cap(self, adapter_id: Optional[str],
                            replicas: int) -> Optional[int]:
        """Max concurrent in-flight requests for one tenant, or ``None``
        when the tenant is unmetered.  Scales with the live replica count
        so a share keeps meaning as the autoscaler acts."""
        if self.tenant_queue_shares is None or adapter_id is None:
            return None
        share = self.tenant_queue_shares.get(adapter_id)
        if share is None:
            return None
        return max(1, round(float(share) * self.queue_hard
                            * max(int(replicas), 1)))


class AdmissionController:
    """Per-route admission: gauges in, admit/queue/shed out.

    One controller serves one route prefix (one
    :class:`~tpu_air_torch.serve.deployment.DeploymentHandle`).  The proxy asks
    :meth:`admit` before forwarding any NEW work (blocking HTTP generate
    or a streaming ``submit`` action); polls of already-admitted requests
    bypass admission entirely."""

    def __init__(self, handle, policy: Optional[AdmissionPolicy] = None):
        self._handle = handle
        self.policy = policy or AdmissionPolicy()
        self._lock = threading.Lock()
        self._gauges: Dict[str, Any] = {}
        self._gauges_at = 0.0
        # per-class outcome counters (surface on /-/stats + /metrics)
        self.admitted = {p: 0 for p in PRIORITIES}
        self.queued = {p: 0 for p in PRIORITIES}
        self.shed = {p: 0 for p in PRIORITIES}
        # per-class QUOTA sheds (429s) — folded into the merged engine
        # snapshot as ``priority.<class>.quota_shed`` so the metric rides
        # the same /metrics families as engine-side sheds
        self.quota_shed = {p: 0 for p in PRIORITIES}
        # tenant → currently in-flight request count (admitted minus
        # released); only metered tenants appear
        self._tenant_inflight: Dict[str, int] = {}
        # per-tenant admission outcomes keyed by billing tenant — the
        # explicit ``tenant`` label when one rides the request (the batch
        # lane's ``batch:<job_id>``), else adapter_id, else "default" —
        # the airwatch cost ledger's shed/quota feed; EVERY tenant appears
        # here, metered or not
        self.tenants: Dict[str, Dict[str, int]] = {}

    def _tenant_outcome(self, tenant: Optional[str],
                        outcome: str) -> None:
        """Count one admission outcome against a billing tenant
        (``self._lock`` must be held)."""
        key = tenant if tenant else "default"
        d = self.tenants.get(key)
        if d is None:
            d = {"admitted": 0, "queued": 0, "shed": 0, "quota_shed": 0}
            self.tenants[key] = d
        d[outcome] += 1

    # -- gauges ---------------------------------------------------------------
    def gauges(self, force: bool = False) -> Dict[str, Any]:
        """TTL-cached scrape of the route's engine gauges, reduced to the
        scalars admission steers on.  The same pass pushes per-replica
        loads into the handle (least-loaded routing) — stale gauges mean
        the handle falls back to round-robin on its own."""
        now = time.monotonic()
        with self._lock:
            fresh = (now - self._gauges_at) <= self.policy.stats_ttl_s
            if fresh and not force:
                return dict(self._gauges)
        snaps = {}
        try:
            snaps = self._handle.engine_stats(timeout=5.0)
        except Exception:  # noqa: BLE001 — scrape is best-effort; admit on no data
            snaps = {}
        live = max(self._handle.num_replicas(), 1)
        depth = sum(int(s.get("queue_depth", 0)) for s in snaps.values())
        occupancy = sum(int(s.get("slot_occupancy", 0)) for s in snaps.values())
        draining = sum(1 for s in snaps.values() if s.get("draining"))
        gauges = {
            "replicas": live,
            "queue_depth": depth,
            "depth_per_replica": depth / live,
            "slot_occupancy": occupancy,
            "draining_replicas": draining,
            "scraped_engines": len(snaps),
        }
        with self._lock:
            self._gauges = gauges
            self._gauges_at = time.monotonic()
        return dict(gauges)

    # -- the decision ---------------------------------------------------------
    def decide(self, priority: str,
               gauges: Optional[Dict[str, Any]] = None) -> str:
        """Pure policy: ``"admit"`` / ``"queue"`` / ``"shed"`` for one
        request of ``priority`` class under ``gauges`` (defaults to a
        fresh TTL scrape).  No counters, no waiting — unit-testable."""
        if priority not in PRIORITIES:
            raise ValueError(
                f"unknown priority {priority!r} (expected one of {PRIORITIES})"
            )
        g = self.gauges() if gauges is None else gauges
        d = float(g.get("depth_per_replica", 0.0))
        p = self.policy
        if priority == "interactive":
            return "admit"  # its ceiling is the engine's class-aware cap
        if priority == "batch":
            if d >= p.queue_hard:
                return "shed"
            if d >= p.queue_high:
                return "queue"
            return "admit"
        # best_effort
        if d >= p.queue_high:
            return "shed"
        if d >= p.queue_soft:
            return "queue"
        return "admit"

    def _check_quota(self, priority: str,
                     adapter_id: Optional[str],
                     tenant: Optional[str] = None) -> None:
        """Raise :class:`QuotaExceededError` (and count the 429) when the
        tenant is at its in-flight cap; otherwise take one in-flight unit.
        Quota is checked BEFORE the class decision so a hot tenant cannot
        burn proxy-side queue waits on requests that were never going to
        admit."""
        if (self.policy.tenant_queue_shares is None
                or adapter_id is None
                or adapter_id not in self.policy.tenant_queue_shares):
            return  # unmetered: never touches the handle
        cap = self.policy.tenant_inflight_cap(
            adapter_id, self._handle.num_replicas())
        if cap is None:
            return
        with self._lock:
            held = self._tenant_inflight.get(adapter_id, 0)
            if held >= cap:
                self.quota_shed[priority] += 1
                self._tenant_outcome(tenant or adapter_id, "quota_shed")
                raise QuotaExceededError(
                    f"tenant {adapter_id!r} is at its queue share "
                    f"({held}/{cap} in flight)",
                    retry_after_s=self.policy.retry_after_s,
                    adapter_id=adapter_id,
                )
            self._tenant_inflight[adapter_id] = held + 1

    def release(self, adapter_id: Optional[str]) -> None:
        """Return one in-flight unit for a metered tenant — the proxy
        calls this when the request completes, sheds downstream, or its
        stream finishes delivery.  No-op for unmetered tenants."""
        if (self.policy.tenant_queue_shares is None
                or adapter_id is None
                or adapter_id not in self.policy.tenant_queue_shares):
            return
        with self._lock:
            held = self._tenant_inflight.get(adapter_id, 0)
            if held > 0:
                self._tenant_inflight[adapter_id] = held - 1

    def admit(self, priority: str,
              adapter_id: Optional[str] = None,
              tenant: Optional[str] = None) -> None:
        """Admit-or-raise for one new request: a "queue" decision waits
        proxy-side (re-scraping each poll) up to the class's
        ``queue_timeout_s``, then sheds.  ``tenant`` is the BILLING label
        for outcome attribution (falls back to ``adapter_id``) — quota
        metering stays keyed on ``adapter_id``, the thing shares are
        declared against.  Raises :class:`QuotaExceededError` when the
        tenant is over its share (429), :class:`AdmissionShedError` on
        class shed (503); returns normally on admit — the caller then
        owes a matching :meth:`release` for metered tenants."""
        bill = tenant or adapter_id
        self._check_quota(priority, adapter_id, bill)
        try:
            decision = self.decide(priority)
            if decision == "admit":
                with self._lock:
                    self.admitted[priority] += 1
                    self._tenant_outcome(bill, "admitted")
                return
            p = self.policy
            if decision == "queue":
                with self._lock:
                    self.queued[priority] += 1
                    self._tenant_outcome(bill, "queued")
                deadline = time.monotonic() + float(
                    p.queue_timeout_s.get(priority, 0.0))
                while time.monotonic() < deadline:
                    time.sleep(p.queue_poll_s)
                    decision = self.decide(priority)
                    if decision == "admit":
                        with self._lock:
                            self.admitted[priority] += 1
                            self._tenant_outcome(bill, "admitted")
                        return
                    if decision == "shed":
                        break
            with self._lock:
                self.shed[priority] += 1
                self._tenant_outcome(bill, "shed")
            raise AdmissionShedError(
                f"{priority}-class shed at the proxy "
                f"(queue depth/replica past policy thresholds)",
                retry_after_s=p.retry_after_s,
            )
        except AdmissionShedError:
            # the in-flight unit taken by _check_quota is only owed on
            # ADMIT — hand it back on any shed path
            self.release(adapter_id)
            raise

    # -- observability --------------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "policy": {
                    "queue_soft": self.policy.queue_soft,
                    "queue_high": self.policy.queue_high,
                    "queue_hard": self.policy.queue_hard,
                    "token_budgets": dict(self.policy.token_budgets),
                    "tenant_token_budgets": dict(
                        self.policy.tenant_token_budgets or {}),
                    "tenant_queue_shares": dict(
                        self.policy.tenant_queue_shares or {}),
                },
                "admitted": dict(self.admitted),
                "queued": dict(self.queued),
                "shed": dict(self.shed),
                "quota_shed": dict(self.quota_shed),
                "tenant_inflight": dict(self._tenant_inflight),
                "tenants": {t: dict(d) for t, d in self.tenants.items()},
                "gauges": dict(self._gauges),
            }
