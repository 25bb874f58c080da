"""tpu_air_torch.observability — the dashboard, cluster state, profiling
hooks, span tracing, SLO burn monitoring and airwatch of the port, with the
JAX package's exports (``tpu_air/observability/__init__.py``).

The dashboard is a JSON status service and a Prometheus text endpoint over
the driver runtime's live state; ``profile_trace`` writes a
``torch.profiler`` Chrome trace of the card's kernels and the host's ops.
"""

from .dashboard import start_dashboard, stop_dashboard, snapshot
from .profiler import profile_trace, step_timer
from . import perf
from . import postmortem
from . import slo
from . import timeseries
from . import tracing
from . import trace_export
from . import watch

__all__ = [
    "perf",
    "postmortem",
    "profile_trace",
    "slo",
    "snapshot",
    "start_dashboard",
    "step_timer",
    "stop_dashboard",
    "timeseries",
    "trace_export",
    "tracing",
    "watch",
]
