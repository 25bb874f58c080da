"""Flight-recorder postmortems: a JSON dump of observability state at the
moment something died, copied from ``tpu_air/observability/postmortem.py``
(the port imports nothing of ``tpu_air``; the dump's schema and keys are
the JAX package's).

When ``TPU_AIR_POSTMORTEM_DIR`` is set, the runtime calls :func:`dump` on
every worker death (core/runtime.py ``_on_worker_death`` — the same event
that turns outstanding tasks into ``WorkerCrashed`` sentinels).  The dump
captures what a human would immediately ask for and can no longer scrape
once the process group is gone:

* the crash context (worker id/pid, actor, in-flight task ids, trace ids),
* the cluster snapshot and per-engine metrics (including the perf ledger's
  roofline/goodput state),
* the SLO monitor's burn-rate state,
* recent trace summaries PLUS the full span trees of every trace the dead
  worker had in flight.

Render one with ``python tools/trace_dump.py --postmortem <file>`` (it
reads JSON only, so a dump of either package).

:func:`dump` never raises and is cheap to call — with the env var unset it
is a single dict lookup.  Files are written ``tmp + os.replace`` so a crash
mid-dump never leaves a truncated JSON behind.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional

SCHEMA = "tpu-air-postmortem/1"
ENV_DIR = "TPU_AIR_POSTMORTEM_DIR"


def enabled() -> bool:
    return bool(os.environ.get(ENV_DIR))


def _collect(reason: str, context: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    out: Dict[str, Any] = {
        "schema": SCHEMA,
        "reason": reason,
        "unix_time": time.time(),
        "context": context or {},
    }
    # every section is best-effort: a postmortem with a missing section
    # beats no postmortem, and the recorder must never take the driver down
    try:
        from . import dashboard

        out["cluster"] = dashboard.snapshot()
    except Exception as e:  # noqa: BLE001 — best-effort section
        out["cluster"] = {"error": str(e)}
    try:
        from . import dashboard

        out["engines"] = dashboard.engine_stats()
    except Exception as e:  # noqa: BLE001 — best-effort section
        out["engines"] = {"error": str(e)}
    try:
        from . import slo as slo_mod

        mon = slo_mod.monitor()
        out["slo"] = {"slos": mon.state(), "burning": list(mon.burning())} \
            if mon is not None else None
    except Exception as e:  # noqa: BLE001 — best-effort section
        out["slo"] = {"error": str(e)}
    try:
        from . import tracing

        rec = tracing.recorder()
        out["traces"] = {
            "recorder": rec.stats(),
            "recent": tracing.trace_summaries(32),
        }
        spans: Dict[str, Any] = {}
        for tid in (context or {}).get("trace_ids") or []:
            spans[tid] = [s.to_dict() for s in rec.for_trace(tid)]
        out["traces"]["spans"] = spans
    except Exception as e:  # noqa: BLE001 — best-effort section
        out["traces"] = {"error": str(e)}
    return out


def dump(reason: str, context: Optional[Dict[str, Any]] = None,
         directory: Optional[str] = None) -> Optional[str]:
    """Write ``postmortem-<ms>.json`` and return its path, or None when the
    recorder is disabled (no ``directory`` argument and no env var) or the
    write failed.  Never raises."""
    try:
        target = directory or os.environ.get(ENV_DIR)
        if not target:
            return None
        os.makedirs(target, exist_ok=True)
        payload = _collect(reason, context)
        name = f"postmortem-{int(time.time() * 1000)}.json"
        path = os.path.join(target, name)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f, indent=2, default=str)
            f.flush()
            os.fsync(f.fileno())  # airlint CS002: a postmortem that can be
            # torn by the same power loss that made it worth writing is
            # useless — fsync before the seal (still inside the outer
            # try, so the never-raises guarantee holds)
        os.replace(tmp, path)
        return path
    except Exception:  # noqa: BLE001 — the flight recorder must never crash its host
        return None


def load(path: str) -> Dict[str, Any]:
    with open(path) as f:
        data = json.load(f)
    if data.get("schema") != SCHEMA:
        raise ValueError(f"not a tpu-air postmortem (schema={data.get('schema')!r})")
    return data
