"""Span tracing for the port's runtime, copied from
``tpu_air/observability/tracing.py`` (the part the core calls; the port
imports nothing of ``tpu_air``).

W3C-style trace and span ids, a process-local lock-protected ring buffer
(:class:`SpanRecorder`) and context propagation from a driver to its
workers: ``core/remote.py`` captures the active context into each task or
actor-method payload, ``core/runtime.py`` opens a worker-side span around
the call and ships the finished spans back to the driver's recorder on the
``done`` control message; the serve proxy opens a root span per HTTP request
(honoring an inbound W3C ``traceparent`` header) and returns the trace id
in a response header.

Zero cost when off (the default): :func:`span` returns the singleton
:data:`_NOOP` without allocating.  Enable with ``TPU_AIR_TRACE=1`` in the
environment (workers inherit it) or :func:`enable`.  The LM engine records
each request's span tree at retirement through :func:`record_span`, from
stamps it took along the way; the dashboard's trace listing of the JAX
package is not copied (ROADMAP Queue 1 item 11).
"""

from __future__ import annotations

import contextvars
import os
import re
import secrets
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Deque, Dict, List, Optional

__all__ = [
    "Span",
    "SpanContext",
    "SpanRecorder",
    "current_context",
    "current_propagation",
    "current_trace_id",
    "disable",
    "enable",
    "enabled",
    "extract_traceparent",
    "format_traceparent",
    "new_span_id",
    "new_trace_id",
    "now_ns",
    "record_span",
    "recorder",
    "span",
    "task_span",
]

_ENV_FLAG = "TPU_AIR_TRACE"

_enabled = os.environ.get(_ENV_FLAG, "0") == "1"


def enabled() -> bool:
    """Fast global check — instrumentation sites guard on this."""
    return _enabled


def enable() -> None:
    """Turn tracing on for this process AND export the flag to the
    environment so worker processes spawned from now on inherit it
    (``Runtime._spawn_worker`` ships the driver's current environ)."""
    global _enabled
    _enabled = True
    os.environ[_ENV_FLAG] = "1"


def disable() -> None:
    global _enabled
    _enabled = False
    os.environ[_ENV_FLAG] = "0"


def _sync_from_env() -> None:
    """Re-read the env flag.  Called by worker processes after the driver's
    environ has been applied (forkserver children otherwise keep the flag
    frozen at preload-import time)."""
    global _enabled
    _enabled = os.environ.get(_ENV_FLAG, "0") == "1"


def now_ns() -> int:
    """Span timestamp base: wall-clock ns (consistent across the host's
    processes, which is what cross-process trace assembly needs)."""
    return time.time_ns()


def new_trace_id() -> str:
    return secrets.token_hex(16)  # 32 hex chars, W3C trace-id width


def new_span_id() -> str:
    return secrets.token_hex(8)  # 16 hex chars, W3C parent-id width


# ---------------------------------------------------------------------------
# context + propagation
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SpanContext:
    """The propagatable part of a span: (trace_id, span_id)."""

    trace_id: str
    span_id: str

    def to_dict(self) -> Dict[str, str]:
        return {"trace_id": self.trace_id, "span_id": self.span_id}

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, str]]) -> Optional["SpanContext"]:
        if not d:
            return None
        trace_id, span_id = d.get("trace_id"), d.get("span_id")
        if not trace_id or not span_id:
            return None
        return cls(trace_id, span_id)


_TRACEPARENT = re.compile(
    r"^([0-9a-f]{2})-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$"
)


def format_traceparent(ctx: SpanContext) -> str:
    """W3C ``traceparent`` header value (version 00, sampled)."""
    return f"00-{ctx.trace_id}-{ctx.span_id}-01"


def extract_traceparent(header: Optional[str]) -> Optional[SpanContext]:
    """Parse a ``traceparent`` header; None on absence or malformation
    (a bad inbound header must never fail the request)."""
    if not header:
        return None
    m = _TRACEPARENT.match(header.strip().lower())
    if m is None or m.group(1) == "ff":
        return None
    trace_id, span_id = m.group(2), m.group(3)
    if trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return SpanContext(trace_id, span_id)


_current: contextvars.ContextVar[Optional[SpanContext]] = contextvars.ContextVar(
    "tpu_air_torch_trace_context", default=None
)


def current_context() -> Optional[SpanContext]:
    return _current.get()


def current_trace_id() -> Optional[str]:
    """Trace id of the active span, if any (read regardless of the enable
    flag so error paths inside a force-recorded task span still tag)."""
    ctx = _current.get()
    return ctx.trace_id if ctx is not None else None


def current_propagation() -> Optional[Dict[str, str]]:
    """The carrier dict to attach to an outbound task/actor payload — None
    when tracing is off or no span is active (the common case; callers
    attach nothing and the remote side pays nothing)."""
    if not _enabled:
        return None
    ctx = _current.get()
    return None if ctx is None else ctx.to_dict()


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------


@dataclass
class Span:
    """One finished-or-live span.  Used as a context manager by
    :func:`span`; plain records built by :func:`record_span` never enter
    the context machinery."""

    name: str
    trace_id: str
    span_id: str
    parent_id: Optional[str] = None
    start_ns: int = 0
    end_ns: int = 0
    pid: int = 0
    tid: int = 0
    status: str = "ok"
    attrs: Dict[str, Any] = field(default_factory=dict)
    _token: Optional[contextvars.Token] = field(
        default=None, repr=False, compare=False
    )

    @property
    def context(self) -> SpanContext:
        return SpanContext(self.trace_id, self.span_id)

    def set_attr(self, key: str, value: Any) -> None:
        self.attrs[key] = value

    def set_status(self, status: str) -> None:
        self.status = status

    # -- context-manager protocol -------------------------------------------
    def __enter__(self) -> "Span":
        self._token = _current.set(self.context)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.end_ns = now_ns()
        if exc_type is not None and self.status == "ok":
            self.status = f"error:{exc_type.__name__}"
        if self._token is not None:
            _current.reset(self._token)
            self._token = None
        _recorder.record(self)
        return False


class _NoopSpan:
    """Singleton returned by :func:`span` on the disabled path — every
    method is a no-op, ``trace_id`` is None, and nothing is allocated."""

    __slots__ = ()

    trace_id = None
    span_id = None
    parent_id = None
    status = "ok"

    @property
    def context(self):
        return None

    def set_attr(self, key, value):
        pass

    def set_status(self, status):
        pass

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


_NOOP = _NoopSpan()


def span(name: str, parent: Optional[SpanContext] = None,
         attrs: Optional[Dict[str, Any]] = None, force: bool = False):
    """Open a span as a context manager.

    Parent resolution: explicit ``parent`` wins, else the ambient context
    (contextvar), else this span roots a fresh trace.  While the span is
    live it IS the ambient context, so nested :func:`span` calls and
    outbound ``.remote`` payload capture parent under it.

    Disabled path: returns :data:`_NOOP` (no allocation).  ``force=True``
    records even when the flag is off — used for cross-process continuation
    where the *sender* decided the request is traced (see
    :func:`task_span`).
    """
    if not _enabled and not force:
        return _NOOP
    pctx = parent if parent is not None else _current.get()
    return Span(
        name=name,
        trace_id=pctx.trace_id if pctx is not None else new_trace_id(),
        span_id=new_span_id(),
        parent_id=pctx.span_id if pctx is not None else None,
        start_ns=now_ns(),
        pid=os.getpid(),
        tid=threading.get_ident() & 0xFFFFFFFF,
        attrs=dict(attrs) if attrs else {},
    )


def task_span(name: str, carrier: Optional[Dict[str, str]]):
    """Continue a trace across a process boundary: ``carrier`` is the dict
    produced by :func:`current_propagation` on the sending side.  A non-None
    carrier means the sender had tracing on, so the span records even if
    this process's own flag is off (fork/forkserver timing must not drop
    the worker half of a trace)."""
    ctx = SpanContext.from_dict(carrier)
    if ctx is None:
        return span(name)  # falls through to _NOOP when disabled
    return span(name, parent=ctx, force=True)


def record_span(
    name: str,
    *,
    trace_id: Optional[str] = None,
    parent_id: Optional[str] = None,
    start_ns: int,
    end_ns: int,
    attrs: Optional[Dict[str, Any]] = None,
    status: str = "ok",
) -> Span:
    """Retroactively record a span from timestamps collected elsewhere (the
    engine's retirement-time emission path).  Returns the span so callers
    can chain children under its ``span_id``."""
    sp = Span(
        name=name,
        trace_id=trace_id or new_trace_id(),
        span_id=new_span_id(),
        parent_id=parent_id,
        start_ns=start_ns,
        end_ns=end_ns,
        pid=os.getpid(),
        tid=threading.get_ident() & 0xFFFFFFFF,
        status=status,
        attrs=dict(attrs) if attrs else {},
    )
    _recorder.record(sp)
    return sp


# ---------------------------------------------------------------------------
# recorder
# ---------------------------------------------------------------------------


class SpanRecorder:
    """Process-local lock-protected ring buffer of finished spans.

    Worker recorders are drained into the ``done`` control message and
    folded into the driver's (core/runtime.py), so the driver's
    :meth:`recent` and :meth:`for_trace` read one merged timeline.
    """

    def __init__(self, capacity: int = 8192):
        self.capacity = capacity
        self._buf: Deque[Span] = deque(maxlen=capacity)
        self._lock = threading.Lock()

    def record(self, span_: Span) -> None:
        with self._lock:
            self._buf.append(span_)

    def record_many(self, spans: List[Span]) -> None:
        with self._lock:
            self._buf.extend(spans)

    def drain(self) -> List[Span]:
        """Remove and return everything buffered (worker → driver ship)."""
        # airlint: disable=CC001 — deliberate lock-free emptiness probe:
        # a racing record() only delays that span to the next drain
        if not self._buf:
            return []
        with self._lock:
            out = list(self._buf)
            self._buf.clear()
            return out

    def recent(self, limit: int = 256) -> List[Span]:
        with self._lock:
            if limit <= 0 or limit >= len(self._buf):
                return list(self._buf)
            return list(self._buf)[-limit:]

    def for_trace(self, trace_id: str) -> List[Span]:
        with self._lock:
            return [s for s in self._buf if s.trace_id == trace_id]

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._buf)


_recorder = SpanRecorder()


def recorder() -> SpanRecorder:
    return _recorder


def drain_if_any() -> Optional[List[Span]]:
    """Worker-side helper for the ``done`` message: the buffered spans, or
    None (the common case — one truthiness check, no lock) so the control
    message stays a 3-tuple when there is nothing to ship."""
    if not _recorder._buf:
        return None
    return _recorder.drain() or None
