"""DisaggRouter — the front door of a prefill/decode-disaggregated engine,
the counterpart of ``tpu_air/engine/dist/router.py``.

One router owns one decode engine (an :class:`InferenceEngine` or a
:class:`MeshEngine`) and a family of :class:`PrefillWorker` actor replicas.
``submit`` returns a live :class:`ResponseStream` at once; a dispatcher
thread a request then

1. picks the least-loaded LIVE prefill replica (ties rotate) and runs the
   prompt's chunked prefill there: the queue forms at the actor's mailbox,
   and decode slots stay free for decoding;
2. under an ``engine.kv_transfer`` span, takes the finished KV pages out of
   the object store and lands them on the decode engine through
   ``submit_prefilled``: the decode engine's own capacity gate applies, so
   pool exhaustion defers the handoff in its admission queue.  Once the
   engine has copied the pages into its pool (or the request ended
   without them), the payload's object is deleted from the store: the
   arena keeps a block that a zero-copy read still pins until that view
   dies, and a deleted file stays mapped where it is read;
3. on a replica's death (``ActorDiedError``/``RemoteError``) marks it dead
   and re-routes, at most two passes over the replicas, with
   capped-exponential backoff and jitter between failures, never past the
   request's deadline; a TIMEOUT is a gray failure (alive but too slow): it
   trips that replica's circuit breaker instead, and a half-open probe
   restores the replica when it recovers.  With no routable replica left
   it falls back to the decode engine's own prefill on the same stream.
   Either way the caller's stream completes, and streams already decoding
   never notice.

Tracing: the carrier captured at ``submit`` rides to the worker (its
``engine.prefill`` span) and wraps the transfer and handoff
(``engine.kv_transfer``); ``scheduler.submit`` inside that span parents the
decode engine's ``engine.request`` under it: one trace id from queue wait
through prefill, transfer and decode, across three processes.

The workers are actors of the port's runtime, created from whatever process
builds the router: a replica actor's request goes to the driver, which
starts the worker, as the JAX runtime does.  ``device=`` names the device
of the decode engine and of every worker (the tests pass ``"cpu"``);
without it each resolves the card itself.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

from tpu_air_torch.core.runtime import ActorDiedError, RemoteError
from tpu_air_torch.faults.retry import (
    Backoff,
    CircuitBreaker,
    Deadline,
    DeadlineExceededError,
)

from ..types import EngineConfig, ResponseStream


def _delete_object(ref) -> None:
    """Delete an object of this process's store (the runtime's, or this
    worker's)."""
    from tpu_air_torch.core import runtime as rt

    ctx = rt.current_worker()
    (ctx.store if ctx is not None else rt.get_runtime().store).delete(ref.id)


class DisaggRouter:
    """Prefill-anywhere, decode-here request router."""

    def __init__(self, checkpoint, engine_config: Optional[EngineConfig] = None,
                 *, prefill_replicas: int = 2, dtype: Optional[str] = None,
                 mesh: Optional[tuple] = None, engine=None,
                 prefill_timeout: float = 120.0, worker_pages: Optional[int] = None,
                 breaker_reset_s: float = 5.0, device: Optional[str] = None,
                 name: str = "disagg"):
        if prefill_replicas < 1:
            raise ValueError("prefill_replicas must be >= 1")
        self.name = name
        self.config = engine_config or EngineConfig()
        self._prefill_timeout = prefill_timeout
        self._lock = threading.Lock()
        self._rid = 0
        self.fallbacks = 0
        self.reroutes = 0
        self.handoffs = 0
        self._rr = 0  # rotates least-loaded ties so idle replicas alternate

        if engine is not None:
            self.engine = engine
        else:
            model = checkpoint.get_model(dtype=dtype, device=device)
            if mesh is not None:
                from .mesh_engine import MeshEngine

                dp, tp = mesh
                self.engine = MeshEngine(
                    model, self.config, dp=dp, tp=tp,
                    devices=None if device is None else [device] * (dp * tp),
                    name=f"{name}-decode")
            else:
                from ..engine import InferenceEngine

                self.engine = InferenceEngine(
                    model, self.config, name=f"{name}-decode")

        import tpu_air_torch

        from .prefill_worker import PrefillWorker

        worker_cls = tpu_air_torch.remote(PrefillWorker)
        self._workers = [
            worker_cls.remote(
                checkpoint, page_len=self.config.page_len,
                slot_len=self.config.slot_len, num_pages=worker_pages,
                dtype=dtype, device=device, name=f"{name}-prefill-{i}",
            )
            for i in range(prefill_replicas)
        ]
        self._alive = [True] * prefill_replicas
        self._inflight = [0] * prefill_replicas
        # retry discipline (tpu_air_torch.faults.retry): one breaker per replica
        # gates gray failures, one seeded backoff paces re-routes.  _sleep
        # is injectable so the storm regression test can record the delays.
        self._breakers = [
            CircuitBreaker(failure_threshold=1, reset_timeout_s=breaker_reset_s)
            for _ in range(prefill_replicas)
        ]
        self._backoff = Backoff(base=0.05, cap=1.0, seed=0)
        self._sleep = time.sleep
        self.retries = 0
        self.engine.metrics.set_topology(
            disagg="on", prefill_replicas=prefill_replicas,
            role="decode",
        )

    # -- submission ------------------------------------------------------------
    def submit(self, prompt, max_new_tokens: Optional[int] = None, *,
               priority: str = "interactive",
               deadline_ms: Optional[float] = None) -> ResponseStream:
        """Queue one prompt through the disaggregated path; the stream is
        live immediately (tokens start at first-token handoff).
        ``priority`` rides through to the decode engine's admission (the
        handoff itself bypasses a decode-side drain — this router admitted
        the work before any drain began).  ``deadline_ms`` (absolute
        unix-epoch ms) bounds the whole dispatch: re-routes never retry
        past it, and the decode engine's queue sweep enforces it after
        handoff."""
        from tpu_air_torch.observability.tracing import current_propagation

        # surface draining at the front door, BEFORE spending prefill work
        if getattr(self.engine, "draining", False):
            from ..types import EngineDrainingError

            raise EngineDrainingError(
                f"decode engine {self.engine.name!r} is draining")
        with self._lock:
            self._rid += 1
            rid = self._rid
        stream = ResponseStream(rid)
        carrier = current_propagation()
        t = threading.Thread(
            target=self._dispatch,
            args=(list(prompt), max_new_tokens, stream, carrier, priority,
                  deadline_ms),
            name=f"{self.name}-dispatch-{rid}", daemon=True,
        )
        t.start()
        return stream

    def generate(self, prompts, max_new_tokens: Optional[int] = None,
                 timeout: Optional[float] = 120.0) -> List[List[int]]:
        streams = [self.submit(p, max_new_tokens) for p in prompts]
        return [s.result(timeout) for s in streams]

    # -- replica choice --------------------------------------------------------
    def _pick_replica(self) -> Optional[int]:
        with self._lock:
            live = [i for i, ok in enumerate(self._alive) if ok]
            if not live:
                return None
            # least-loaded wins; ties rotate round-robin so a stream of
            # sequential (never-overlapping) requests still spreads.  The
            # first candidate whose breaker admits traffic is taken —
            # allow() is only called until it first answers True, so a
            # half-open probe slot is never consumed by a replica we then
            # don't call.
            n = len(self._workers)
            ranked = sorted(
                live, key=lambda j: (self._inflight[j], (j - self._rr) % n))
            for i in ranked:
                if self._breakers[i].allow():
                    self._rr = i + 1
                    self._inflight[i] += 1
                    return i
            return None

    def _mark_dead(self, i: int) -> None:
        with self._lock:
            if self._alive[i]:
                self._alive[i] = False
                self.reroutes += 1

    def live_prefill_replicas(self) -> int:
        with self._lock:
            return sum(self._alive)

    # -- draining (passthrough to the decode engine) ---------------------------
    def drain(self) -> None:
        """Refuse new submits; queued + in-flight work (including handoffs
        already dispatched) retires normally on the decode engine."""
        self.engine.drain()

    @property
    def draining(self) -> bool:
        return getattr(self.engine, "draining", False)

    def drained(self) -> bool:
        return self.engine.drained()

    # -- the per-request dispatcher -------------------------------------------
    def _dispatch(self, prompt, max_new, stream, carrier, priority,
                  deadline_ms=None) -> None:
        try:
            self._dispatch_inner(prompt, max_new, stream, carrier, priority,
                                 deadline_ms)
        except BaseException as e:  # never strand the caller's stream
            stream._finish(e)

    def _dispatch_inner(self, prompt, max_new, stream, carrier,
                        priority, deadline_ms=None) -> None:
        import tpu_air_torch
        from tpu_air_torch.observability.tracing import task_span

        from .kv_transfer import payload_nbytes, payload_pages

        deadline = Deadline.at_ms(deadline_ms)
        # bounded re-route (the death-storm fix): at most two passes over
        # the replica set, capped-exponential backoff + jitter between
        # failures, and no attempt ever launched past the deadline
        max_attempts = 2 * len(self._workers)
        result = None
        attempts = 0
        while result is None and attempts < max_attempts:
            if deadline is not None and deadline.expired:
                raise DeadlineExceededError(
                    f"deadline passed during prefill re-route "
                    f"(after {attempts} failed attempts)")
            i = self._pick_replica()
            if i is None:
                break  # every prefill replica is dead or breaker-open
            try:
                ref = self._workers[i].prefill.remote(prompt, carrier)
                result = tpu_air_torch.get(ref, timeout=self._prefill_timeout)
                _delete_object(ref)        # the reply is read: only its payload stays
                self._breakers[i].record_success()
            except (ActorDiedError, RemoteError):
                # confirmed death: out of rotation permanently (respawn is
                # the deployment layer's job, not this router's)
                self._mark_dead(i)
                attempts += 1
                with self._lock:
                    self.retries += 1
                self._sleep(self._backoff.next_delay(attempts))
            except TimeoutError:
                # gray failure: alive but too slow — trip the breaker; its
                # half-open probe restores the replica if it recovers
                self._breakers[i].record_failure()
                attempts += 1
                with self._lock:
                    self.retries += 1
                self._sleep(self._backoff.next_delay(attempts))
            finally:
                with self._lock:
                    self._inflight[i] -= 1
        if result is None:
            # no live prefill capacity: the decode engine prefills locally
            # on the SAME stream — degraded, never dropped
            with self._lock:
                self.fallbacks += 1
            # internal path: like submit_prefilled, a fallback is work this
            # router ALREADY admitted, so it rides through a decode-side
            # drain that began mid-dispatch instead of erroring the stream
            self.engine._enqueue(self.engine._make_request(
                prompt, max_new, stream, priority,
                admit_while_draining=True, deadline_ms=deadline_ms))
            return
        with task_span("engine.kv_transfer", carrier) as sp:
            payload = tpu_air_torch.get(result["kv"])
            if sp is not None and hasattr(sp, "attrs"):
                sp.attrs.update({
                    "kv_bytes": payload_nbytes(payload),
                    "pages": payload_pages(payload),
                    "prompt_len": result["prompt_len"],
                })
            # scheduler.submit captures THIS span as the request's trace
            # parent: decode joins the same trace as prefill + transfer
            self.engine.submit_prefilled(
                prompt, result["first_token"], payload, max_new,
                stream=stream, priority=priority, deadline_ms=deadline_ms,
                release=lambda ref=result["kv"]: _delete_object(ref))
        with self._lock:
            self.handoffs += 1

    # -- observability / lifecycle --------------------------------------------
    def stats(self) -> Dict[str, Any]:
        with self._lock:
            out = {
                "name": self.name,
                "prefill_replicas": len(self._workers),
                "live_prefill_replicas": sum(self._alive),
                "handoffs": self.handoffs,
                "reroutes": self.reroutes,
                "fallbacks": self.fallbacks,
                "retries": self.retries,
                "breakers": [b.state for b in self._breakers],
            }
            alive = list(self._alive)  # snapshot: _mark_dead runs concurrently
        worker_stats = []
        for i, w in enumerate(self._workers):
            if not alive[i]:
                worker_stats.append({"name": f"{self.name}-prefill-{i}",
                                     "dead": True})
                continue
            try:
                import tpu_air_torch

                worker_stats.append(
                    tpu_air_torch.get(w.stats.remote(), timeout=10.0))
            except (ActorDiedError, RemoteError, TimeoutError):
                self._mark_dead(i)
                worker_stats.append({"name": f"{self.name}-prefill-{i}",
                                     "dead": True})
        out["workers"] = worker_stats
        out["engine"] = self.engine.metrics.snapshot()
        return out

    def close(self) -> None:
        import tpu_air_torch

        self.engine.close()
        with self._lock:
            alive = list(self._alive)  # snapshot: _mark_dead runs concurrently
        for i, w in enumerate(self._workers):
            if alive[i]:
                try:
                    tpu_air_torch.kill(w)
                except Exception:  # best-effort teardown races actor death
                    pass
