"""tpu_air_torch.faults — deterministic fault injection and the retry and
recovery discipline of the port (copied from ``tpu_air.faults``).

* :mod:`tpu_air_torch.faults.plan` — seeded :class:`FaultPlan` schedules
  enacted by hooks through the core, engine, serve and train layers; one
  module-global read when no plan is installed.
* :mod:`tpu_air_torch.faults.retry` — :class:`Backoff`,
  :class:`CircuitBreaker`, :class:`Deadline` and :func:`call_with_retry`.

Both are pure standard library.
"""

from tpu_air_torch.faults.plan import (
    FaultInjectedError,
    FaultPlan,
    FaultSpec,
    LeaseRevokedError,
    clear,
    current_plan,
    enabled,
    hit,
    install,
    perturb,
    stats,
)
from tpu_air_torch.faults.retry import (
    Backoff,
    BreakerOpenError,
    CircuitBreaker,
    Deadline,
    DeadlineExceededError,
    call_with_retry,
)

__all__ = [
    "Backoff",
    "BreakerOpenError",
    "CircuitBreaker",
    "Deadline",
    "DeadlineExceededError",
    "FaultInjectedError",
    "FaultPlan",
    "FaultSpec",
    "LeaseRevokedError",
    "call_with_retry",
    "clear",
    "current_plan",
    "enabled",
    "hit",
    "install",
    "perturb",
    "stats",
]
