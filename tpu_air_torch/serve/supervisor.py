"""Self-healing serve plane: proxy-side request journal + stream replay.
Copied from ``tpu_air/serve/supervisor.py`` over the port's runtime.  The
:class:`PreemptionWatcher`'s migration reaches working RPCs
(``EngineDeployment``'s ``migrate_out`` and ``submit_migrated``), but the
port's replicas attach no revocable lease (ROADMAP Queue 1 item 11), so no
notice starts it on its own today; the journal replay serves every stream
whose replica dies.

The deployment layer already *respawns* crashed replicas
(``DeploymentHandle._control_tick`` prunes dead replicas and re-spawns the
deficit) — what it cannot do is rescue the STREAMS that lived on the
corpse: a streaming client whose pinned replica died used to see
``ReplicaGoneError`` → HTTP 503, losing every token already decoded.

This module closes that gap.  The proxy journals every streaming submit
(prompt, clamped budget, priority, absolute deadline) and each poll's
delivered-token prefix.  When a pinned poll hits a dead replica, the
journal REPLAYS the request on a live replica: the original prompt plus
the already-streamed tokens are re-submitted as a forced prefix with the
remaining budget — greedy decoding is deterministic, so the continuation
is token-identical to the stream the dead replica would have produced.
The client keeps polling its ORIGINAL request id and pin header; the
journal translates cursors across the redirect.  Net effect: a replica
crash is a stall, never a 5xx and never a token lost or changed.

Replay discipline comes from :mod:`tpu_air_torch.faults.retry`: bounded
attempts, capped-exponential backoff on overload/drain, and no attempt
past the request's deadline (``DeadlineExceededError`` → proxy 504).

Scope notes:

* only streaming requests with an EXPLICIT ``max_new_tokens`` are
  replayable — without the budget the proxy cannot compute the remaining
  allowance for the continuation (the engine-side default is not visible
  here);
* greedy decoding only: a sampled continuation would not be
  token-identical (that is a statement about sampling, not about replay);
* the journal is per-proxy-process, bounded (FIFO eviction), and keyed by
  ``(route prefix, replica tag, request id)`` — request ids are minted
  per replica, so the pin disambiguates.
"""

from __future__ import annotations

import json
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from tpu_air_torch.core.runtime import RemoteError
from tpu_air_torch.faults.retry import Backoff, Deadline, DeadlineExceededError
from tpu_air_torch.observability import tracing as _tracing

from .deployment import NoLiveReplicasError, ReplicaGoneError

__all__ = ["JournalEntry", "PreemptionWatcher", "RequestJournal",
           "journaled_poll"]


@dataclass(eq=False)
class JournalEntry:
    """One in-flight streaming request as the proxy knows it."""

    prefix: str
    pin: str                      # replica tag of the ORIGINAL submit
    request_id: int               # the id the client keeps polling
    prompt: List[int]
    max_new_tokens: Optional[int]
    priority: str
    deadline_ms: Optional[float]  # absolute unix-epoch ms
    adapter_id: Optional[str] = None  # tenant LoRA adapter, None = base
    tenant: Optional[str] = None  # billing label (batch:<job_id>), not a bank row
    tokens: List[int] = field(default_factory=list)  # delivered prefix
    done: bool = False
    # after a replay: (new replica tag, new request id, token offset) — the
    # continuation stream starts at ``offset`` of the client-visible stream
    redirect: Optional[Tuple[str, int, int]] = None
    replays: int = 0
    # per-entry lock: replay must be exclusive per request, but must not
    # serialize the whole journal for its duration
    lock: threading.Lock = field(default_factory=threading.Lock)


class RequestJournal:
    """Bounded, thread-safe map of in-flight streaming requests."""

    def __init__(self, cap: int = 1024):
        self._cap = int(cap)
        self._lock = threading.Lock()
        self._entries: "OrderedDict[Tuple[str, str, int], JournalEntry]" = (
            OrderedDict())
        self.replays = 0
        self.replay_failures = 0
        # cap evictions that had to take a LIVE (not-done, not-redirected)
        # entry — each one is a stream that silently lost its replay
        # safety net, so the counter surfaces on /-/stats recovery
        self.evicted_live = 0

    # -- bookkeeping (proxy handler threads) --------------------------------
    def record_submit(self, prefix: str, pin: str, request_id: int, *,
                      prompt, max_new_tokens: Optional[int],
                      priority: str,
                      deadline_ms: Optional[float],
                      adapter_id: Optional[str] = None,
                      tenant: Optional[str] = None) -> None:
        entry = JournalEntry(
            prefix=prefix, pin=pin, request_id=int(request_id),
            prompt=[int(t) for t in (prompt or [])],
            max_new_tokens=(None if max_new_tokens is None
                            else int(max_new_tokens)),
            priority=str(priority),
            deadline_ms=(None if deadline_ms is None else float(deadline_ms)),
            adapter_id=(None if adapter_id is None else str(adapter_id)),
            tenant=(None if tenant is None else str(tenant)))
        with self._lock:
            self._entries[(prefix, pin, int(request_id))] = entry
            while len(self._entries) > self._cap:
                self._evict_one_locked()

    def _evict_one_locked(self) -> None:
        """Drop one entry to make room, preferring the oldest FINISHED
        one (done, or fully delivered) — blind FIFO used to evict the
        oldest entry even while its stream was live, silently discarding
        its replay safety net.  Only when every entry is live does the
        cap force a live eviction, and that is counted."""
        for key, e in self._entries.items():
            if e.done:
                del self._entries[key]
                return
        self.evicted_live += 1
        self._entries.popitem(last=False)

    def lookup(self, prefix: str, pin: Optional[str],
               request_id: int) -> Optional[JournalEntry]:
        if not pin:
            return None
        with self._lock:
            return self._entries.get((prefix, pin, int(request_id)))

    def record_progress(self, entry: JournalEntry, tokens: List[int],
                        done: bool) -> None:
        """``tokens`` is the FULL client-visible list so far (the proxy
        polls upstream with cursor 0 precisely so the journal always holds
        a complete prefix to replay from)."""
        with entry.lock:
            entry.tokens = list(tokens)
            entry.done = bool(done)

    def repin(self, entry: JournalEntry, new_pin: str,
              new_request_id: int) -> None:
        """Migration re-pin: the stream continues on ``new_pin`` under
        ``new_request_id``.  Unlike a replay redirect, the destination
        engine force-emits every already-streamed token before resuming
        decode, so the continuation stream carries the FULL client-visible
        list — the redirect offset is 0 and no journal prefix is
        stitched in front of it."""
        with entry.lock:
            entry.redirect = (str(new_pin), int(new_request_id), 0)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "journal_size": len(self._entries),
                "replays": self.replays,
                "replay_failures": self.replay_failures,
                "journal_evicted_live": self.evicted_live,
            }

    # -- recovery ------------------------------------------------------------
    def replay(self, handle, entry: JournalEntry, *,
               timeout: float = 60.0,
               sleep=time.sleep) -> Optional[Tuple[str, int, int]]:
        """Re-submit ``entry`` on a live replica with the delivered tokens
        as a forced prefix.  Returns the redirect tuple, or None when the
        journal already holds the complete stream (nothing left to decode).
        Raises when the request is not replayable or every attempt failed.
        """
        with entry.lock:
            if entry.redirect is not None:
                return entry.redirect  # another poll thread already replayed
            if entry.done:
                return None
            if entry.max_new_tokens is None:
                raise ReplicaGoneError(
                    f"request {entry.request_id} on {entry.pin!r} is gone "
                    "and not replayable (no explicit max_new_tokens)")
            streamed = list(entry.tokens)
            remaining = int(entry.max_new_tokens) - len(streamed)
            if remaining <= 0:
                entry.done = True  # fully delivered before the crash
                return None
            payload: Dict[str, Any] = {
                "action": "submit",
                "prompt": list(entry.prompt) + streamed,
                "max_new_tokens": remaining,
                "priority": entry.priority,
            }
            if entry.deadline_ms is not None:
                payload["deadline_ms"] = entry.deadline_ms
            if entry.adapter_id is not None:
                # the continuation must decode under the SAME tenant
                # adapter or the forced-prefix replay changes tokens
                payload["adapter_id"] = entry.adapter_id
            if entry.tenant is not None:
                # billing continuity: the continuation's tokens belong to
                # the same cost tenant as the stream it resumes
                payload["tenant"] = entry.tenant
            body = json.dumps(payload).encode()
            deadline = Deadline.at_ms(entry.deadline_ms)
            backoff = Backoff(base=0.05, cap=1.0, seed=0)
            last: Optional[BaseException] = None
            with _tracing.span("serve.replay", attrs={
                    "request_id": entry.request_id, "from": entry.pin,
                    "streamed": len(streamed), "remaining": remaining}):
                for attempt in range(1, 6):
                    if deadline is not None and deadline.expired:
                        self._count_failure()
                        raise DeadlineExceededError(
                            f"deadline passed while replaying request "
                            f"{entry.request_id}") from last
                    try:
                        result, tag = handle.call_http_sync_tagged(
                            body, timeout=timeout, pin=None)
                        entry.redirect = (tag, int(result["request_id"]),
                                          len(streamed))
                        entry.replays += 1
                        with self._lock:
                            self.replays += 1
                        return entry.redirect
                    except RemoteError as e:
                        # overload/drain is "retry later"; anything else is
                        # a real error the client should see
                        if not e.cause_repr.startswith(
                                ("EngineOverloadedError",
                                 "EngineDrainingError")):
                            self._count_failure()
                            raise
                        last = e
                    except NoLiveReplicasError as e:
                        last = e  # respawn in progress: back off and retry
                    delay = backoff.next_delay(attempt)
                    if (deadline is not None
                            and delay > deadline.remaining_s()):
                        self._count_failure()
                        raise DeadlineExceededError(
                            f"replay backoff would overrun the deadline for "
                            f"request {entry.request_id}") from last
                    sleep(delay)
            self._count_failure()
            raise last  # type: ignore[misc]

    def _count_failure(self) -> None:
        with self._lock:
            self.replay_failures += 1


def journaled_poll(journal: RequestJournal, handle, prefix: str,
                   payload: Dict[str, Any], pin: Optional[str], *,
                   timeout: float = 300.0) -> Tuple[Dict[str, Any], str]:
    """The proxy's poll path: serve the poll, keep the journal current,
    and recover through a replay when the pinned replica is gone.

    Returns ``(result, header_tag)`` — the header tag stays the ORIGINAL
    pin across a redirect so the client never re-learns its pin."""
    rid = int(payload.get("request_id", -1))
    cursor = int(payload.get("cursor", 0))
    entry = journal.lookup(prefix, pin, rid)
    if entry is not None and (entry.redirect is not None or entry.done):
        return _poll_redirected(journal, handle, entry, cursor,
                                timeout=timeout), pin or ""
    # upstream cursor is ALWAYS 0: the journal needs the full prefix to
    # replay from, and the proxy slices the client's cursor locally
    body = json.dumps({"action": "poll", "request_id": rid,
                       "cursor": 0}).encode()
    try:
        result, tag = handle.call_http_sync_tagged(
            body, timeout=timeout, pin=pin)
    except ReplicaGoneError:
        if entry is None:
            raise  # not journaled (no explicit budget / evicted): 503
        journal.replay(handle, entry)
        return _poll_redirected(journal, handle, entry, cursor,
                                timeout=timeout), pin or ""
    toks = list(result.get("tokens") or [])
    done = bool(result.get("done"))
    if entry is not None:
        journal.record_progress(entry, toks, done)
    return {"tokens": toks[cursor:], "done": done}, tag


class PreemptionWatcher:
    """Driver-side preemption orchestration for one route.

    A daemon thread polls every replica's ``preempt_status`` (cheap — it
    never forces an engine build).  When a replica reports a revocation
    notice the watcher, in order:

    1. signals the autoscaler (``notice_scale_up`` on a side thread —
       capacity is ANNOUNCED to leave, no gauge needed, and the blocking
       spawn must not eat the notice window);
    2. if enough notice remains, MIGRATES: ``migrate_out`` freezes the
       source and returns one payload per live decoding slot;
       ``submit_migrated`` lands each on a survivor, and the journal
       entry is re-pinned so the client's next poll reads the
       destination stream (token-identical, zero re-prefill);
    3. falls back to the journal REPLAY for anything it could not
       migrate (notice too short, no survivor, payload rejected): taking
       the source out of rotation makes the next pinned poll raise
       ``ReplicaGoneError``, which ``journaled_poll`` already recovers;
    4. takes the source out of rotation either way — its chips are gone
       at the end of the window whether or not anyone drained.
    """

    def __init__(self, handle, journal: RequestJournal, prefix: str, *,
                 autoscaler=None, poll_s: float = 0.2,
                 min_migrate_notice_s: float = 0.5,
                 migrate_timeout_s: float = 30.0):
        self._handle = handle
        self._journal = journal
        self._prefix = prefix
        self._autoscaler = autoscaler
        self.poll_s = float(poll_s)
        self.min_migrate_notice_s = float(min_migrate_notice_s)
        self.migrate_timeout_s = float(migrate_timeout_s)
        self._lock = threading.Lock()
        self.preemptions = 0
        self.migrations = 0
        self.migrated_pages = 0
        self.migration_fallbacks = 0
        #: worst orchestration wall time (notice observed -> replica out of
        #: rotation): the window during which the doomed replica's streams
        #: are being re-seated — the bench's ``preemption_recovery_ms``
        self.preemption_recovery_ms = 0.0
        self._handled: set = set()  # replica tags already orchestrated
        # replica tags whose coming revocation is a BORROW RETURN (the
        # batch broker handing a soaked replica back, engine_deployment
        # ``borrow_return``): orchestrated exactly like a real preemption
        # — drain, migrate, out of rotation — but WITHOUT the autoscaler
        # backfill, because the capacity is leaving on purpose
        self._borrowed: set = set()
        self.borrow_returns = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def mark_borrowed(self, tag: str) -> None:
        """Flag ``tag``'s next revocation notice as a voluntary borrow
        return (no autoscaler scale-up).  Called by the batch broker
        BEFORE it delivers the notice — the watcher thread only reads the
        flag inside :meth:`_orchestrate`, after the notice lands."""
        with self._lock:
            self._borrowed.add(str(tag))

    # -- replica RPC plumbing -------------------------------------------------
    @staticmethod
    def _call(replica, method: str, *args, timeout: float = 30.0):
        from tpu_air_torch.core import api as core_api

        return core_api.get(
            replica.handle.remote(method, tuple(args), {}), timeout=timeout)

    # -- lifecycle ------------------------------------------------------------
    def start(self) -> "PreemptionWatcher":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, daemon=True,
                name=f"preemption-watcher-{self._prefix}")
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(self.poll_s):
            try:
                self.tick()
            except Exception:  # noqa: BLE001 — the watcher must outlive any one bad tick
                pass

    # -- one poll round -------------------------------------------------------
    def tick(self) -> None:
        with self._handle._lock:
            replicas = list(self._handle._replicas)
        for replica in replicas:
            tag = replica._actor_id
            # airlint: disable=CC001 — _handled is confined to the single
            # watcher thread (tick + the set below); never read elsewhere
            if tag in self._handled:
                continue
            try:
                status = self._call(replica, "preempt_status", timeout=5.0)
            except Exception:  # noqa: BLE001 — dead/foreign replicas just aren't preempting
                continue
            if not (status or {}).get("preempting"):
                continue
            self._handled.add(tag)
            self._orchestrate(replica, status)

    def _orchestrate(self, replica, status: Dict[str, Any]) -> None:
        tag = replica._actor_id
        t_start = time.monotonic()
        with self._lock:
            self.preemptions += 1
            borrowed = tag in self._borrowed
            if borrowed:
                self._borrowed.discard(tag)
                self.borrow_returns += 1
        if self._autoscaler is not None and not borrowed:
            threading.Thread(  # blocking spawn: keep it off the notice clock
                target=self._notice_autoscaler, daemon=True,
                name=f"preemption-scale-up-{self._prefix}").start()
        notice_left = float(status.get("notice_left_s") or 0.0)
        with _tracing.span("serve.migrate", attrs={
                "from": tag, "notice_s": status.get("notice_s"),
                "notice_left_s": notice_left}):
            migrated_all = False
            if notice_left >= self.min_migrate_notice_s:
                migrated_all = self._migrate(replica)
            if not migrated_all:
                with self._lock:
                    self.migration_fallbacks += 1
        # out of rotation LAST: while migration runs, pinned polls still
        # reach the frozen source and serve correct (stale) prefixes.
        # After this, un-migrated streams' polls raise ReplicaGoneError
        # and journaled_poll replays them on a survivor.
        self._handle.mark_dead(replica)
        recovery_ms = (time.monotonic() - t_start) * 1000.0
        with self._lock:
            self.preemption_recovery_ms = max(
                self.preemption_recovery_ms, recovery_ms)
        # airwatch gets the recovery as a first-class event next to any
        # anomaly the capacity drop trips (off ⇒ one module-global read)
        from tpu_air_torch.observability import watch as _watch

        if _watch.enabled():
            _watch.current().note(
                "preemption.recovered", route=self._prefix, replica=tag,
                recovery_ms=round(recovery_ms, 3),
                migrated_all=migrated_all, borrowed=borrowed)
        # the serve plane took everything it wants from the zombie
        # (payloads migrated, pollers re-pinned or replaying): terminate
        # it so its chips return to the pool — the preempted capacity must
        # be re-leasable, not leaked to a drained husk
        try:
            from tpu_air_torch.core.runtime import get_runtime

            get_runtime().kill_actor(tag)
        except Exception:  # noqa: BLE001 — best-effort reclaim of a dying actor
            pass

    def _notice_autoscaler(self) -> None:
        try:
            self._autoscaler.notice_scale_up()
        except Exception:  # noqa: BLE001 — a failed spawn must not kill the watcher
            pass

    @staticmethod
    def _payload_pages(payload: Dict[str, Any]) -> int:
        first = next(iter((payload.get("pages") or {}).values()), None)
        try:
            return int(first["k"].shape[0]) if first else 0
        except Exception:  # noqa: BLE001 — page count is observability, not control flow
            return 0

    def _migrate(self, source) -> bool:
        """Drain ``source``'s live slots onto survivors.  True only when
        EVERY payload landed (an empty payload list counts — nothing was
        decoding); anything less lets the caller count a fallback and the
        stranded streams take the replay path."""
        tag = source._actor_id
        try:
            payloads = self._call(source, "migrate_out",
                                  timeout=self.migrate_timeout_s)
        except Exception:  # noqa: BLE001 — a frozen/dying source means replay for everyone
            return False
        with self._handle._lock:
            survivors = [r for r in self._handle._replicas
                         if r._actor_id != tag]
        if not survivors and payloads:
            return False
        ok = True
        for i, payload in enumerate(payloads):
            placed = False
            # spread migrated streams across survivors round-robin; on a
            # rejected payload (KVTransferError crossing as RemoteError)
            # try the next survivor before giving the stream to replay
            for j in range(len(survivors)):
                dest = survivors[(i + j) % len(survivors)]
                try:
                    new_rid = self._call(dest, "submit_migrated", payload,
                                         timeout=self.migrate_timeout_s)
                except Exception:  # noqa: BLE001 — rejected here ≠ lost: replay covers it
                    continue
                entry = self._journal.lookup(
                    self._prefix, tag, int(payload.get("request_id", -1)))
                if entry is not None:
                    self._journal.repin(entry, dest._actor_id, new_rid)
                with self._lock:
                    self.migrations += 1
                    self.migrated_pages += self._payload_pages(payload)
                placed = True
                break
            if not placed:
                ok = False
        return ok

    # -- observability --------------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "preemptions": self.preemptions,
                "borrow_returns": self.borrow_returns,
                "migrations": self.migrations,
                "migrated_pages": self.migrated_pages,
                "migration_fallbacks": self.migration_fallbacks,
                "preemption_recovery_ms": round(
                    self.preemption_recovery_ms, 3),
            }


def _poll_redirected(journal: RequestJournal, handle, entry: JournalEntry,
                     cursor: int, *, timeout: float = 300.0,
                     _depth: int = 0) -> Dict[str, Any]:
    """Serve a poll for a replayed (or journal-complete) stream: stitch
    ``journal prefix + continuation`` into the client-visible token list."""
    with entry.lock:
        redirect = entry.redirect
        toks = list(entry.tokens)
    if redirect is None:
        # no continuation stream: the journal holds the whole delivery
        return {"tokens": toks[cursor:], "done": True}
    new_pin, new_rid, offset = redirect
    body = json.dumps({"action": "poll", "request_id": new_rid,
                       "cursor": 0}).encode()
    try:
        result, _tag = handle.call_http_sync_tagged(
            body, timeout=timeout, pin=new_pin)
    except ReplicaGoneError:
        # the replacement died too — replay again from the journal prefix
        if _depth >= 3:
            raise
        with entry.lock:
            if entry.redirect == redirect:
                entry.redirect = None
        journal.replay(handle, entry)
        return _poll_redirected(journal, handle, entry, cursor,
                                timeout=timeout, _depth=_depth + 1)
    new_toks = list(result.get("tokens") or [])
    done = bool(result.get("done"))
    with entry.lock:
        full = list(entry.tokens[:offset]) + new_toks
        entry.tokens = full
        entry.done = done
    return {"tokens": full[cursor:], "done": done}
