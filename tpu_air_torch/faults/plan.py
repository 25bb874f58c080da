"""Seeded, deterministic fault injection at the hooks of the port's core,
copied from ``tpu_air/faults/plan.py`` (what the core calls; the port
imports nothing of ``tpu_air``).

A :class:`FaultPlan` is a seed plus a schedule of typed :class:`FaultSpec`
entries.  Each hook is one ``if _faults.enabled():`` guard, so with no plan
installed it costs one module-global read.  A spec fires on the N-th
eligible hit of its site (per process, counted under a lock).  A plan
crosses into worker processes through ``TPU_AIR_TORCH_FAULT_PLAN`` in the
environ the runtime ships to each worker; ``_worker_main`` calls
:func:`_sync_from_env`.

The port's sites:

====================  ==========================================
site                  actions
====================  ==========================================
``object_store.get``  ``delay`` (slow fetch), ``drop`` (TimeoutError)
``object_store.put``  ``delay``, ``drop``, ``error`` (the write fails
                      before any byte lands)
``actor.call``        ``delay``, ``kill`` (crash the target actor)
``runtime.task``      ``delay``
``proxy.request``     ``delay``, ``kill`` (crash a serving replica)
``proxy.poll``        ``delay``, ``kill`` (crash the pinned replica)
====================  ==========================================
"""

from __future__ import annotations

import json
import os
import threading
import time
from dataclasses import asdict, dataclass, field
from typing import Dict, List, Optional

__all__ = [
    "FaultInjectedError",
    "FaultPlan",
    "FaultSpec",
    "clear",
    "enabled",
    "hit",
    "install",
    "perturb",
    "stats",
]

# its own variable: a JAX package plan in the same environ is not the port's
_ENV_FLAG = "TPU_AIR_TORCH_FAULT_PLAN"


class FaultInjectedError(Exception):
    """An explicitly injected error (action ``error``)."""


@dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault.

    ``site``     — hook name (see module docstring table).
    ``action``   — what to do there: delay/slow/drop/error/kill.
    ``at``       — fire on the N-th eligible hit of the site (1-based,
                   counted per process).
    ``count``    — keep firing for this many consecutive hits (gray
                   failures are sustained slowness, not a single blip).
    ``delay_s``  — sleep duration for delay/slow actions.
    ``match``    — optional substring filter on the hit key (e.g. an
                   actor id or object id); empty matches everything.
    """

    site: str
    action: str
    at: int = 1
    count: int = 1
    delay_s: float = 0.0
    match: str = ""

    def __post_init__(self):
        if self.at < 1 or self.count < 1 or self.delay_s < 0:
            raise ValueError(f"bad fault spec: {self}")


@dataclass
class FaultPlan:
    """A seed plus an ordered schedule of faults."""

    seed: int = 0
    specs: List[FaultSpec] = field(default_factory=list)

    def to_json(self) -> str:
        """Canonical serialization: sorted keys, no whitespace variance."""
        return json.dumps(
            {"seed": self.seed, "specs": [asdict(s) for s in self.specs]},
            sort_keys=True, separators=(",", ":"))

    @classmethod
    def from_json(cls, raw: str) -> "FaultPlan":
        d = json.loads(raw)
        return cls(seed=int(d.get("seed", 0)),
                   specs=[FaultSpec(**s) for s in d.get("specs", [])])


# ---------------------------------------------------------------------------
# process-local plan state
# ---------------------------------------------------------------------------

_lock = threading.Lock()
_plan: Optional[FaultPlan] = None
_hits: Dict[int, int] = {}    # spec index -> eligible-hit count
_fired: Dict[str, int] = {}   # "site:action" -> times fired


def enabled() -> bool:
    """Fast global check — every hook guards on this before doing work."""
    return _plan is not None


def install(plan: FaultPlan) -> None:
    """Install a plan in this process AND export it to the environment so
    worker processes spawned from now on inherit it (``_spawn_worker``
    ships the driver's environ; ``_worker_main`` re-syncs)."""
    global _plan
    with _lock:
        _plan = plan
        _hits.clear()
        _fired.clear()
    os.environ[_ENV_FLAG] = plan.to_json()


def clear() -> None:
    global _plan
    with _lock:
        _plan = None
        _hits.clear()
        _fired.clear()
    os.environ.pop(_ENV_FLAG, None)


def _sync_from_env() -> None:
    """Re-read the env plan.  Called by worker processes after the driver's
    environ has been applied (mirrors ``tracing._sync_from_env``)."""
    global _plan
    raw = os.environ.get(_ENV_FLAG)
    with _lock:
        _plan = FaultPlan.from_json(raw) if raw else None
        _hits.clear()
        _fired.clear()


def hit(site: str, key: str = "") -> Optional[FaultSpec]:
    """Count one eligible hit of ``site`` and return the spec that fires
    now, if any.  A spec fires on hits ``[at, at + count)`` of its site
    (per process); ``match`` filters hits by key substring."""
    plan = _plan
    if plan is None:
        return None
    with _lock:
        for i, spec in enumerate(plan.specs):
            if spec.site != site:
                continue
            if spec.match and spec.match not in key:
                continue
            n = _hits.get(i, 0) + 1
            _hits[i] = n
            if spec.at <= n < spec.at + spec.count:
                tag = f"{spec.site}:{spec.action}"
                _fired[tag] = _fired.get(tag, 0) + 1
                return spec
    return None


def perturb(site: str, key: str = "") -> Optional[FaultSpec]:
    """The generic hook body: count the hit and enact in-band actions.

    ``delay``/``slow`` sleep here; ``drop`` raises ``TimeoutError`` (the
    same error a real store timeout produces); ``error`` raises
    :class:`FaultInjectedError`.  ``kill`` is returned to the caller — only
    the hook site knows what dying means there (``crash_actor`` from the
    driver)."""
    spec = hit(site, key)
    if spec is None:
        return None
    if spec.action in ("delay", "slow"):
        time.sleep(spec.delay_s)
    elif spec.action == "drop":
        raise TimeoutError(
            f"airfault: injected drop at {site} (key={key!r})")
    elif spec.action == "error":
        raise FaultInjectedError(f"airfault: injected error at {site}")
    return spec


def stats() -> Dict[str, object]:
    """What has fired in THIS process (the serve proxy's ``/-/stats``
    ``recovery.faults`` entry)."""
    with _lock:
        return {
            "installed": _plan is not None,
            "seed": _plan.seed if _plan is not None else None,
            "faults_injected": sum(_fired.values()),
            "fired": dict(_fired),
        }


_sync_from_env()
