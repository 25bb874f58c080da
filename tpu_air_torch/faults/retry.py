"""Retry discipline for the recovery paths: backoff, breaker, deadline.
Copied from ``tpu_air/faults/retry.py``; the port imports nothing of
``tpu_air``.

Before this module every retry path in the stack was ad hoc — the disagg
router re-routed in a tight loop on prefill-worker death, object-store
consumers re-fetched immediately, and nothing anywhere knew about the
request's end-to-end deadline.  These three primitives give every retry
site the same vocabulary:

* :class:`Backoff` — capped exponential delay with *deterministic* seeded
  jitter (chaos runs must replay byte-identically, so jitter comes from a
  seeded PRNG, never from global entropy);
* :class:`CircuitBreaker` — per-target closed → open → half-open state
  machine so a gray-failing target (slow, not dead) stops receiving
  traffic until a probe succeeds;
* :class:`Deadline` — an absolute end-to-end budget (unix-epoch ms, the
  wire format of ``Request.deadline_ms``) that retry loops consult so no
  attempt is ever launched past the client's deadline.

:func:`call_with_retry` composes the three for call sites that don't need
bespoke loop structure.  Everything here is pure stdlib and imports
nothing else of the port — the injection hooks live in core/engine/serve
modules which import *us*, so this module must sit at the bottom of the
import graph.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Callable, Optional, Tuple, Type

__all__ = [
    "Backoff",
    "BreakerOpenError",
    "CircuitBreaker",
    "Deadline",
    "DeadlineExceededError",
    "call_with_retry",
]


class DeadlineExceededError(Exception):
    """The request's end-to-end deadline passed before the work completed.

    Raised engine-side when a queued request expires before admission and
    retry-side when a backoff wait would overrun the budget.  The proxy
    maps it to HTTP 504 with a ``Retry-After`` header (never a hang).
    """


class BreakerOpenError(Exception):
    """The per-target circuit breaker is open — the target is not taking
    traffic until its reset timeout elapses and a half-open probe succeeds."""


class Deadline:
    """An absolute end-to-end deadline in unix-epoch milliseconds.

    This is the same absolute form ``Request.deadline_ms`` carries across
    process boundaries (a *relative* budget would silently re-extend at
    every hop).  ``None``-safe construction: :meth:`at_ms` returns ``None``
    for a ``None`` input so call sites can thread optional deadlines.
    """

    __slots__ = ("at_unix_ms",)

    def __init__(self, at_unix_ms: float):
        self.at_unix_ms = float(at_unix_ms)

    @classmethod
    def at_ms(cls, at_unix_ms: Optional[float]) -> Optional["Deadline"]:
        return None if at_unix_ms is None else cls(at_unix_ms)

    @classmethod
    def after_ms(cls, budget_ms: float) -> "Deadline":
        return cls(time.time() * 1000.0 + float(budget_ms))

    def remaining_s(self) -> float:
        return max(0.0, self.at_unix_ms / 1000.0 - time.time())

    @property
    def expired(self) -> bool:
        return time.time() * 1000.0 >= self.at_unix_ms

    def __repr__(self):
        return f"Deadline(at_unix_ms={self.at_unix_ms:.0f})"


class Backoff:
    """Capped exponential backoff with deterministic seeded jitter.

    ``next_delay(attempt)`` for attempt 1, 2, 3… returns
    ``min(cap, base * factor**(attempt-1))`` scaled by a jitter factor in
    ``[1-jitter, 1]`` drawn from a private seeded PRNG.  Same seed → same
    delay sequence, which is what makes chaos runs reproducible.
    """

    def __init__(self, base: float = 0.05, cap: float = 2.0,
                 factor: float = 2.0, jitter: float = 0.5,
                 seed: Optional[int] = None):
        if base <= 0 or cap < base or factor < 1.0 or not 0 <= jitter <= 1:
            raise ValueError(
                f"bad backoff: base={base} cap={cap} factor={factor} "
                f"jitter={jitter}")
        self.base = float(base)
        self.cap = float(cap)
        self.factor = float(factor)
        self.jitter = float(jitter)
        self._rng = random.Random(0 if seed is None else seed)

    def next_delay(self, attempt: int) -> float:
        raw = min(self.cap, self.base * self.factor ** max(0, attempt - 1))
        if not self.jitter:
            return raw
        return raw * (1.0 - self.jitter * self._rng.random())


class CircuitBreaker:
    """Per-target closed → open → half-open breaker.

    * **closed**: traffic flows; ``failure_threshold`` consecutive failures
      trip it open.
    * **open**: :meth:`allow` returns ``False`` until ``reset_timeout_s``
      elapses, then exactly one caller gets a half-open probe.
    * **half_open**: the probe's :meth:`record_success` closes the breaker;
      :meth:`record_failure` re-opens it (and restarts the reset clock).

    Internally locked — safe to share across router dispatch threads.  The
    clock is injectable for deterministic transition tests.
    """

    CLOSED = "closed"
    OPEN = "open"
    HALF_OPEN = "half_open"

    def __init__(self, failure_threshold: int = 3, reset_timeout_s: float = 5.0,
                 clock: Callable[[], float] = time.monotonic):
        if failure_threshold < 1 or reset_timeout_s < 0:
            raise ValueError(
                f"bad breaker: failure_threshold={failure_threshold} "
                f"reset_timeout_s={reset_timeout_s}")
        self.failure_threshold = int(failure_threshold)
        self.reset_timeout_s = float(reset_timeout_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._state = self.CLOSED
        self._failures = 0
        self._opened_at = 0.0

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def allow(self) -> bool:
        """True if a call may proceed.  On an open breaker whose reset
        timeout has elapsed this transitions to half-open and admits ONE
        probe; concurrent callers see ``False`` until the probe resolves."""
        with self._lock:
            if self._state == self.CLOSED:
                return True
            if self._state == self.OPEN:
                if self._clock() - self._opened_at >= self.reset_timeout_s:
                    self._state = self.HALF_OPEN
                    return True
                return False
            # half-open: a probe is already in flight
            return False

    def record_success(self) -> None:
        with self._lock:
            self._state = self.CLOSED
            self._failures = 0

    def record_failure(self) -> None:
        with self._lock:
            if self._state == self.HALF_OPEN:
                self._state = self.OPEN
                self._opened_at = self._clock()
                return
            self._failures += 1
            if self._failures >= self.failure_threshold:
                self._state = self.OPEN
                self._opened_at = self._clock()


def call_with_retry(
    fn: Callable[[], "object"],
    *,
    attempts: int = 3,
    backoff: Optional[Backoff] = None,
    breaker: Optional[CircuitBreaker] = None,
    deadline: Optional[Deadline] = None,
    retry_on: Tuple[Type[BaseException], ...] = (TimeoutError, OSError),
    sleep: Callable[[float], None] = time.sleep,
):
    """Run ``fn`` under the full retry discipline: bounded attempts, capped
    exponential backoff, optional breaker gating, and a hard deadline no
    attempt (or backoff wait) may cross."""
    backoff = backoff or Backoff()
    last: Optional[BaseException] = None
    for attempt in range(1, attempts + 1):
        if deadline is not None and deadline.expired:
            raise DeadlineExceededError(
                f"deadline expired before attempt {attempt}") from last
        if breaker is not None and not breaker.allow():
            raise BreakerOpenError("circuit breaker open") from last
        try:
            out = fn()
        except retry_on as e:
            last = e
            if breaker is not None:
                breaker.record_failure()
            if attempt >= attempts:
                break
            delay = backoff.next_delay(attempt)
            if deadline is not None and delay > deadline.remaining_s():
                raise DeadlineExceededError(
                    f"backoff of {delay:.3f}s would overrun the deadline"
                ) from e
            sleep(delay)
        else:
            if breaker is not None:
                breaker.record_success()
            return out
    raise last  # type: ignore[misc]
