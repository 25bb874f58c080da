"""Chrome-trace / Perfetto JSON export for recorded spans, copied from
``tpu_air/observability/trace_export.py`` (the port imports nothing of
``tpu_air``; the JSON is the JAX package's, byte for byte).

The output loads directly in ``chrome://tracing`` and
https://ui.perfetto.dev — each span becomes one complete duration event
(``ph="X"``) with microsecond ``ts``/``dur``, laid out per process
(``pid``) and thread (``tid``), and its trace/span/parent ids carried in
``args`` so a trace can be reassembled from the export alone.  Served at
``GET /api/traces/export`` on the dashboard; written to disk by
:func:`export_file`.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Iterable, List, Optional

from .tracing import Span, recorder

# event-phase / field names per the Trace Event Format spec (the subset
# chrome://tracing and Perfetto both accept)
_PH_COMPLETE = "X"
_PH_METADATA = "M"


def span_to_event(span: Span) -> Dict[str, Any]:
    """One span → one complete-duration trace event."""
    args: Dict[str, Any] = dict(span.attrs)
    args["trace_id"] = span.trace_id
    args["span_id"] = span.span_id
    if span.parent_id:
        args["parent_id"] = span.parent_id
    if span.status != "ok":
        args["status"] = span.status
    return {
        "name": span.name,
        "cat": span.name.split(".", 1)[0] or "span",
        "ph": _PH_COMPLETE,
        "ts": span.start_ns / 1e3,                      # microseconds
        "dur": max(span.end_ns - span.start_ns, 0) / 1e3,
        "pid": span.pid,
        "tid": span.tid,
        "args": args,
    }


def to_chrome_trace(
    spans: Optional[Iterable[Span]] = None,
    trace_id: Optional[str] = None,
) -> Dict[str, Any]:
    """Render spans (default: the whole process recorder; or one trace via
    ``trace_id``) as a Trace-Event-Format object."""
    if spans is None:
        rec = recorder()
        spans = rec.for_trace(trace_id) if trace_id else rec.recent(0)
    spans = list(spans)
    events: List[Dict[str, Any]] = []
    seen_pids = {}
    for sp in spans:
        if sp.pid not in seen_pids:
            seen_pids[sp.pid] = True
            events.append({
                "name": "process_name",
                "ph": _PH_METADATA,
                "pid": sp.pid,
                "tid": 0,
                "args": {"name": f"tpu_air pid {sp.pid}"},
            })
        events.append(span_to_event(sp))
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {"source": "tpu_air airtrace", "spans": len(spans)},
    }


def export_json(
    spans: Optional[Iterable[Span]] = None,
    trace_id: Optional[str] = None,
) -> str:
    return json.dumps(to_chrome_trace(spans, trace_id=trace_id))


def export_file(
    path: str,
    spans: Optional[Iterable[Span]] = None,
    trace_id: Optional[str] = None,
) -> int:
    """Write the chrome-trace JSON to ``path``; returns the span count."""
    doc = to_chrome_trace(spans, trace_id=trace_id)
    with open(path, "w") as f:
        json.dump(doc, f)
    return doc["otherData"]["spans"]
