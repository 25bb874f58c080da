"""Profiling hooks, the port's counterpart of
``tpu_air/observability/profiler.py`` (the port imports nothing of
``tpu_air``).

* ``step_timer`` — per-step wall accounting for training loops, a copy of
  the JAX package's over the port's :class:`~.perf.Histogram`.
* ``profile_trace`` — a context manager around ``torch.profiler.profile``
  (the JAX package's wraps ``jax.profiler.trace``) that writes a
  Chrome-trace JSON of host ops and CUDA kernels, which ``chrome://tracing``,
  ui.perfetto.dev and TensorBoard's profiler plugin open.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Dict, Iterator, Optional

from . import tracing as _tracing
from .perf import Histogram


class step_timer:
    """Accumulates per-step wall times; cheap enough for every train step.

    >>> t = step_timer()
    >>> with t.step():  # around each train_step
    ...     ...
    >>> t.summary()  # {'steps': N, 'mean_s': ..., 'p50_s': ..., 'p95_s': ...}

    Quantiles come from an airscope log-bucketed :class:`Histogram` — the
    same estimator the engine metrics use, so a trainer's p95 and the
    dashboard's p95 agree on method (the raw ``durations`` list stays
    available for exact math downstream).

    With ``span_name`` set AND tracing enabled, every step additionally
    lands as an airtrace span (parented under the ambient context) so the
    same numbers show up on the request/trial timeline; the default path
    stays a bare perf_counter delta.  The wall is the host's: a step that
    ends without waiting for the device measures what the host queued.
    """

    def __init__(self, span_name: Optional[str] = None):
        self.durations: list = []
        self._hist = Histogram()
        self._span_name = span_name

    @contextlib.contextmanager
    def step(self) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.durations.append(dt)
            self._hist.observe(dt)
            if self._span_name is not None and _tracing.enabled():
                end = _tracing.now_ns()
                ctx = _tracing.current_context()
                _tracing.record_span(
                    self._span_name,
                    trace_id=ctx.trace_id if ctx else None,
                    parent_id=ctx.span_id if ctx else None,
                    start_ns=end - int(dt * 1e9),
                    end_ns=end,
                    attrs={"step": len(self.durations)},
                )

    def summary(self) -> Dict[str, Any]:
        s = self._hist.summary()
        if not s.get("count"):
            return {"steps": 0}
        return {
            "steps": s["count"],
            "total_s": s["sum"],
            "mean_s": s["mean"],
            "p50_s": s["p50"],
            "p95_s": s["p95"],
            "max_s": s["max"],
        }


@contextlib.contextmanager
def profile_trace(log_dir: str, host_tracer_level: Optional[int] = None,
                  device=None) -> Iterator[None]:
    """``torch.profiler`` trace around a region, written on exit as
    ``<host>_<pid>.<ns>.pt.trace.json`` under ``log_dir`` (Chrome-trace
    JSON: open it in ``chrome://tracing`` or ui.perfetto.dev, or point
    TensorBoard at ``log_dir``).

    ``device`` goes through :func:`tpu_air_torch.device.resolve_device`:
    none means the card, and without CUDA it raises unless the caller asks
    for ``"cpu"``.  On a CUDA device the trace records the card's kernels,
    copies and memsets; a CUDA device that the profiler cannot trace raises
    rather than fall back to a host-only trace.  On the CPU the host ops are
    the work, so they are always recorded.

    ``host_tracer_level`` maps the JAX profiler's levels onto the
    profiler's options: 0 records device activity only; 1 (the default,
    ``None``) adds the host's ops (``ProfilerActivity.CPU``); 2 or more adds
    each op's input shapes and its Python stack (``record_shapes`` and
    ``with_stack``).

    When tracing is enabled, the region also lands as an airtrace span,
    ``profiler.xplane_trace`` (the JAX package's name, so both timelines
    join on it), whose ``log_dir`` attr points at the trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    from tpu_air_torch.device import resolve_device

    dev = resolve_device(device)
    level = 1 if host_tracer_level is None else int(host_tracer_level)
    activities = []
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"profile_trace: {dev} was asked for and CUDA is not "
                               "available; pass device='cpu' to trace the CPU")
        if ProfilerActivity.CUDA not in torch.profiler.supported_activities():
            raise RuntimeError("profile_trace: this PyTorch build cannot trace CUDA "
                               "activity (no CUPTI)")
        activities.append(ProfilerActivity.CUDA)
        if level >= 1:
            activities.append(ProfilerActivity.CPU)
    elif dev.type == "cpu":
        activities.append(ProfilerActivity.CPU)
    else:
        raise ValueError(f"profile_trace: no trace for device {dev}")
    detail = level >= 2
    t0 = _tracing.now_ns() if _tracing.enabled() else 0
    try:
        with profile(activities=activities, record_shapes=detail, with_stack=detail,
                     on_trace_ready=tensorboard_trace_handler(log_dir)):
            yield
    finally:
        if t0:
            ctx = _tracing.current_context()
            _tracing.record_span(
                "profiler.xplane_trace",
                trace_id=ctx.trace_id if ctx else None,
                parent_id=ctx.span_id if ctx else None,
                start_ns=t0,
                end_ns=_tracing.now_ns(),
                attrs={"log_dir": log_dir},
            )
