"""Admission scheduler: priority-classed FIFO queues with backpressure +
a bounded reorder window.  Copied from ``tpu_air/engine/scheduler.py``
over the port's tracing.

Policy (docs/SERVING.md §SLO-aware serving): each request carries one of
the :data:`~tpu_air_torch.engine.types.PRIORITIES` classes.  Admission pops
classes strictly in priority order every engine step — iteration-
granularity priority, the Orca framing applied to admission — and WITHIN
a class requests are admitted in arrival order up to the number of free
slots.  The paged engine additionally passes a ``can_admit`` predicate
(does the KV pool have pages for this request right now?) — and a blocked
HEAD no longer blocks its class: admission may look at most
``reorder_window`` entries past the first request that does not fit and
admit later ones that do (a big-prompt head waiting for pages can't
head-of-line-block a stream of small requests that would fit today).
Every such out-of-order admission increments ``reordered_admits``.  A
class whose head stays blocked after the window STOPS the round — lower
classes never steal the pages the blocked higher-class head is waiting
for (no priority inversion).

Backpressure is class-aware: a submit is rejected once the TOTAL queue
depth reaches ``config.queue_cap(priority)`` — best-effort sheds first
(half of ``max_queue`` by default), then batch, and interactive keeps the
full ``max_queue``.

``reorder_window=0`` (or no ``can_admit``) restores strict FIFO within a
class, which keeps the scheduler DETERMINISTIC for a given arrival
schedule — what the engine's token-parity gate tests against (all parity
traffic is single-class, where this scheduler is exactly the old FIFO);
the window itself is also deterministic: lowest-index fitting candidate
wins.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Deque, Dict, List

from tpu_air_torch.faults.retry import DeadlineExceededError
from tpu_air_torch.observability import tracing as _tracing

from .types import PRIORITIES, EngineConfig, EngineOverloadedError, Request


class Scheduler:
    """Thread-safe priority-classed admission queue over
    :class:`EngineConfig` dials."""

    def __init__(self, config: EngineConfig):
        self.config = config
        self._queues: Dict[str, Deque[Request]] = {
            p: deque() for p in PRIORITIES
        }
        self._lock = threading.Lock()
        self._work = threading.Event()
        self.reordered_admits = 0  # admissions that jumped a blocked head
        # engine-side sheds by class (admission-queue rejections)
        self.rejected_by_class: Dict[str, int] = {p: 0 for p in PRIORITIES}
        # end-to-end deadlines: queued requests past Request.deadline_ms are
        # expired (stream fails with DeadlineExceededError → proxy 504)
        # instead of occupying a slot they can no longer use.  _deadlines
        # counts queued deadline-carrying requests so the per-round sweep is
        # free for deadline-less traffic.
        self.deadline_expired = 0
        self._deadlines = 0

    # -- producer side (any thread) ------------------------------------------
    def submit(self, request: Request) -> None:
        """Enqueue; raises :class:`EngineOverloadedError` when the total
        queue has reached this class's cap (``config.queue_cap``) —
        class-aware backpressure: the caller sees 503, retries."""
        # airlint: disable=CC001 — key-set membership only: _queues' keys
        # are fixed at __init__; the per-class deques mutate under _lock
        if request.priority not in self._queues:
            raise ValueError(
                f"unknown priority {request.priority!r} "
                f"(expected one of {PRIORITIES})"
            )
        if _tracing.enabled():
            # stamp outside the lock: carrier + submit time feed the
            # retirement-time span emission (engine._emit_request_spans)
            request.trace_ctx = _tracing.current_propagation()
            request.t_submit_ns = _tracing.now_ns()
        with self._lock:
            depth = sum(len(q) for q in self._queues.values())
            cap = self.config.queue_cap(request.priority)
            if depth >= cap:
                self.rejected_by_class[request.priority] += 1
                raise EngineOverloadedError(
                    f"engine admission queue full for "
                    f"{request.priority}-class ({depth}/{cap}, "
                    f"max_queue={self.config.max_queue})"
                )
            self._queues[request.priority].append(request)
            if request.deadline_ms is not None:
                self._deadlines += 1
            self._work.set()

    # -- engine-loop side ----------------------------------------------------
    def pop_admissible(self, free_slots: int,
                       can_admit=None) -> List[Request]:
        """Dequeue up to ``free_slots`` requests, classes in priority
        order, FIFO within a class.

        ``can_admit(request) -> bool`` (optional) gates each candidate on
        engine-side capacity (KV pages / the interactive slot reserve);
        the engine's predicate RESERVES capacity when it answers True, so
        one round never over-admits.  When a class's head is blocked, up
        to ``config.reorder_window`` later entries OF THAT CLASS are
        considered in queue order (head-of-line relief); out-of-order
        takes are counted in :attr:`reordered_admits`.  A class whose
        head stays blocked ends the round — lower classes must not claim
        the capacity it is waiting for."""
        out: List[Request] = []
        window = getattr(self.config, "reorder_window", 0)
        with self._lock:
            self._sweep_expired_locked()
            for priority in PRIORITIES:
                queue = self._queues[priority]
                blocked = False
                while queue and len(out) < free_slots:
                    if can_admit is None or can_admit(queue[0]):
                        out.append(queue.popleft())
                        continue
                    # head blocked: bounded look-ahead past it
                    took = None
                    if can_admit is not None and window > 0:
                        for j in range(1, min(window, len(queue) - 1) + 1):
                            if can_admit(queue[j]):
                                took = j
                                break
                    if took is None:
                        blocked = True
                        break
                    cand = queue[took]
                    del queue[took]
                    out.append(cand)
                    self.reordered_admits += 1
                if blocked or len(out) >= free_slots:
                    break
            for r in out:
                if r.deadline_ms is not None:
                    self._deadlines -= 1
            if not any(self._queues.values()):
                self._work.clear()
        if _tracing.enabled() and out:
            t = _tracing.now_ns()
            for r in out:
                if r.t_submit_ns:
                    r.t_admit_ns = t
        return out

    def _sweep_expired_locked(self) -> None:
        """Expire queued requests past their deadline (caller holds _lock).
        ``stream._finish`` is non-blocking (event set + queue put), safe
        under the lock; one wall-clock read covers the whole sweep."""
        if not self._deadlines:
            return
        now_ms = time.time() * 1000.0
        for q in self._queues.values():
            expired = [r for r in q
                       if r.deadline_ms is not None
                       and now_ms >= r.deadline_ms]
            if not expired:
                continue
            dead = {id(r) for r in expired}
            keep = [r for r in q if id(r) not in dead]
            q.clear()
            q.extend(keep)
            for r in expired:
                self.deadline_expired += 1
                self._deadlines -= 1
                r.stream._finish(DeadlineExceededError(
                    f"request {r.request_id} missed its deadline while "
                    f"queued ({r.priority}-class, deadline_ms="
                    f"{r.deadline_ms:.0f})"))

    def depth(self) -> int:
        with self._lock:
            return sum(len(q) for q in self._queues.values())

    def depth_by_class(self) -> Dict[str, int]:
        """Per-priority queue depths (admission/autoscaler gauge)."""
        with self._lock:
            return {p: len(q) for p, q in self._queues.items()}

    def drain(self) -> List[Request]:
        """Remove and return every queued request (engine shutdown)."""
        with self._lock:
            out = [r for p in PRIORITIES for r in self._queues[p]]
            for q in self._queues.values():
                q.clear()
            self._deadlines = 0
            self._work.clear()
        return out

    def wait_for_work(self, timeout: float) -> bool:
        """Block until something is queued (or timeout); engine idle-wait."""
        return self._work.wait(timeout)
