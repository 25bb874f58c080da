"""Request/response types and config for the online inference engine,
copied from ``tpu_air/engine/types.py`` (the port imports nothing of
``tpu_air``).  ``EngineConfig`` configures the causal-LM slot engine
(:class:`~tpu_air_torch.engine.InferenceEngine`), ``T5EngineConfig`` the T5
window engine.

The engine's unit of work is a :class:`Request` (one prompt + decode
budget); its unit of delivery is a :class:`ResponseStream` — emitted token
ids land on the stream the same engine step they are decoded, so callers
see time-to-first-token, not time-to-last-token.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Iterator, List, Optional, Sequence, Tuple, Union

from tpu_air_torch.core.runtime import TpuAirError


#: SLO priority classes, highest first.  Admission pops classes in this
#: order every engine step (iteration-granularity priority — the Orca
#: observation applied to admission, not just batching), and the serve
#: plane's admission controller sheds/queues the tail classes first under
#: overload (serve/admission.py).
PRIORITIES = ("interactive", "batch", "best_effort")


class EngineOverloadedError(TpuAirError):
    """Admission queue is full — backpressure, not failure.  The serve
    proxy maps this to HTTP 503 (the NoLiveReplicasError semantics): the
    client should retry, nothing is broken."""


class EngineDrainingError(EngineOverloadedError):
    """The engine is draining (zero-downtime rollout / scale-down): new
    submissions are refused while already-admitted work retires.  Same
    retry contract as overload — the proxy maps it to 503 and the router
    has already stopped sending new traffic here."""


class EngineClosedError(TpuAirError):
    """The engine was shut down with this request still queued/in flight."""


class RequestValidationError(ValueError, TpuAirError):
    """The request itself is malformed (unknown ``adapter_id``): the
    client's fault, not the server's.  A ValueError subclass so local
    callers can keep catching ValueError, but distinct across the actor
    boundary — the proxy maps THIS name to HTTP 400 while an application
    ValueError raised inside a replica stays a 500 (it signals a server
    bug, and must not be retried as if resubmitting could fix it)."""


@dataclass
class EngineConfig:
    """Dials for the KV pool and admission policy.

    * ``num_slots`` — S, the fixed decode batch width.  One persistent
      compiled step serves the whole engine lifetime; a slot is one
      in-flight sequence.
    * ``slot_len`` — L, max positions per sequence.  Admission requires
      ``len(prompt) + max_new_tokens <= slot_len``.
    * ``max_new_tokens`` — default per-request decode budget.
    * ``max_queue`` — queued (not yet admitted) request cap; beyond it
      ``submit`` raises :class:`EngineOverloadedError`.
    * ``kv_mode`` — ``"paged"`` (default): block-table-paged KV pool with
      prefix sharing and chunked prefill (``engine/kvpool/``);
      ``"slab"``: the fixed per-slot slabs ``[S, slot_len, h*d]``
      (kept as the bench baseline and the mode the T5 window engine uses).
    * ``page_len`` — paged mode: positions per KV page.
    * ``num_pages`` — paged mode: physical pages in the pool (page 0 is
      the pinned null page).  ``None`` → slab-equivalent capacity,
      ``num_slots * ceil(slot_len / page_len) + 1`` — same HBM as the
      slab pool; prefix sharing turns the saved pages into headroom.
    * ``prefix_cache`` — paged mode: keep retired prompts' pages resident
      (radix over page chunks) so later prompts sharing a prefix skip
      that prefill and share the physical pages.
    * ``prefill_chunks_per_step`` — paged mode: prefill chunks run per
      engine step, interleaved between pool decode steps.  1 (default)
      bounds how long any prefill work can delay in-flight decodes, so a
      long prompt streams in page-sized pieces while short requests keep
      decoding (flat TTFT under long-prompt arrival).
    * ``reorder_window`` — admission may look this many queue entries past
      a request that does not currently fit (no free KV pages) and admit
      later ones that do.  0 restores strict FIFO.
    * ``reserved_interactive_slots`` — keep this many FREE slots that only
      ``interactive``-class requests may take: a burst of batch/best-effort
      decodes can then never occupy the whole pool, so an arriving
      interactive request admits (and reaches its first token) without
      waiting for a lower-class slot to retire.  0 (default) disables the
      reserve — all classes compete for all slots.
    * ``queue_shares`` — fraction of ``max_queue`` each priority class may
      see the TOTAL queue grow to before its submits are rejected
      (engine-side shed).  Defaults: interactive 1.0, batch 0.85,
      best_effort 0.5 — as the queue fills, best-effort sheds first,
      then batch, and interactive keeps the full ``max_queue``.
    * ``prefill_buckets`` — slab mode: prompt-length buckets (ascending);
      prompts right-pad to the smallest fitting bucket so prefill
      compiles once per bucket.  ``None`` → powers of two up to
      ``slot_len``.  Paged mode needs no buckets: every prompt length
      runs through one compiled page-sized chunk program.
    * ``eos_token_id`` — ``"model"`` (default): use the model config's
      ``eos_token_id``; ``None``: never early-stop (budget-only
      retirement); an int: that id.
    * ``adapter_slots`` — multi-tenant LoRA: rows in the resident adapter
      bank (0 disables adapters; the paged engine only: a slab engine with
      a value above 0 raises ``ValueError``).  Row 0 is the pinned zero
      adapter, so the bank holds ``adapter_slots`` loadable tenants on top
      of it.  Per-request selection rides
      ``Request.adapter_id``; the decode step gathers each slot's delta
      the way it gathers the block table.
    * ``adapter_rank`` — LoRA rank r of the bank rows ``[d, r] x [r, V]``.
      Lower-rank adapters zero-pad into the bank; higher ranks are
      rejected at load.
    """

    num_slots: int = 8
    slot_len: int = 256
    max_new_tokens: int = 64
    max_queue: int = 256
    kv_mode: str = "paged"
    page_len: int = 16
    num_pages: Optional[int] = None
    prefix_cache: bool = True
    prefill_chunks_per_step: int = 1
    reorder_window: int = 4
    reserved_interactive_slots: int = 0
    queue_shares: Optional[dict] = None
    prefill_buckets: Optional[Tuple[int, ...]] = None
    eos_token_id: Union[int, None, str] = "model"
    adapter_slots: int = 0
    adapter_rank: int = 4

    _DEFAULT_QUEUE_SHARES = {
        "interactive": 1.0, "batch": 0.85, "best_effort": 0.5,
    }

    def queue_cap(self, priority: str) -> int:
        """Total queue depth at which ``priority``-class submits shed."""
        shares = self.queue_shares or self._DEFAULT_QUEUE_SHARES
        return int(self.max_queue * float(shares.get(priority, 1.0)))

    def pages_per_slot(self) -> int:
        return -(-self.slot_len // self.page_len)

    def pool_pages(self) -> int:
        if self.num_pages is not None:
            return self.num_pages
        return self.num_slots * self.pages_per_slot() + 1

    def buckets(self) -> Tuple[int, ...]:
        if self.prefill_buckets is not None:
            return tuple(sorted(self.prefill_buckets))
        out, b = [], 1
        while b < self.slot_len:
            out.append(b)
            b *= 2
        out.append(self.slot_len)
        return tuple(out)

    def bucket_for(self, n: int) -> int:
        for b in self.buckets():
            if n <= b:
                return b
        raise ValueError(
            f"prompt length {n} exceeds the largest prefill bucket "
            f"{self.buckets()[-1]} (slot_len={self.slot_len})"
        )


_DONE = object()


class ResponseStream:
    """Per-request token stream.

    The engine appends ids as they are decoded; callers either iterate
    (``for tok in stream: ...`` — blocks until each token arrives, ends at
    retirement) or join (``stream.result()`` — the full id list, raising if
    the request failed).  Emitted tokens INCLUDE the EOS id when early-stop
    triggered, matching offline ``generate`` (which emits EOS then pads).
    """

    def __init__(self, request_id: int):
        self.request_id = request_id
        self._q: "queue.Queue" = queue.Queue()
        self._tokens: List[int] = []
        self._done = threading.Event()
        self._error: Optional[BaseException] = None
        # engine-side callbacks run once the stream has finished (a
        # handoff's payload release, when its pages never landed)
        self._on_finish: List[Callable[[], None]] = []

    # -- engine side ---------------------------------------------------------
    def _emit(self, token: int) -> None:
        self._tokens.append(token)
        self._q.put(token)

    def _finish(self, error: Optional[BaseException] = None) -> None:
        self._error = error
        self._done.set()
        self._q.put(_DONE)
        for fn in self._on_finish:
            fn()

    # -- caller side ---------------------------------------------------------
    def __iter__(self) -> Iterator[int]:
        while True:
            item = self._q.get()
            if item is _DONE:
                if self._error is not None:
                    raise self._error
                return
            yield item

    def result(self, timeout: Optional[float] = None) -> List[int]:
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"request {self.request_id} not finished after {timeout}s"
            )
        if self._error is not None:
            raise self._error
        return list(self._tokens)

    def tokens_so_far(self) -> List[int]:
        return list(self._tokens)

    @property
    def done(self) -> bool:
        return self._done.is_set()


@dataclass
class Request:
    """One admitted unit of work (internal; callers hold the stream)."""

    request_id: int
    prompt: Sequence[int]
    max_new_tokens: int
    stream: ResponseStream
    # SLO class (one of PRIORITIES): admission pops interactive first each
    # step, and the scheduler sheds the tail classes at lower queue depths
    priority: str = "interactive"
    submitted_at: float = field(default_factory=time.monotonic)
    first_token_at: Optional[float] = None
    # airtrace: carrier captured at submit + wall-clock stamps (ns) for the
    # retirement-time span emission (engine.py _emit_request_spans).  All
    # zero/None when tracing is off — the hot loop never touches them.
    trace_ctx: Optional[dict] = None
    t_submit_ns: int = 0
    t_admit_ns: int = 0
    t_first_ns: int = 0
    # disaggregated serving (engine/dist/): a request whose prefill ran on
    # a PrefillWorker replica arrives with its first token and the prompt's
    # KV pages ({"first_token": int, "pages": {layer_path: {"k", "v"}}});
    # admission inserts the pages and goes straight to decode.  None for
    # the normal (engine-prefills) path.
    prefilled: Optional[dict] = None
    # preemption migration (engine ``migrate_out`` → ``submit_migrated``):
    # a stream that was already DECODING on a preempted replica arrives
    # with every client-visible token it emitted there plus the KV pages
    # covering its context ({"streamed": [int], "pages": {...},
    # "client_prompt_len": int}); admission inserts the pages, force-emits
    # the streamed tokens, and resumes decode at the exact cursor — zero
    # prefill chunks.  None for every other path.
    migrated: Optional[dict] = None
    # end-to-end deadline as ABSOLUTE unix-epoch milliseconds (a relative
    # budget would silently re-extend at every hop).  The proxy converts
    # the client's relative budget at admission; the scheduler expires
    # still-queued requests past it (DeadlineExceededError → HTTP 504)
    # rather than letting them occupy a slot they can no longer use.
    deadline_ms: Optional[float] = None
    # multi-tenant LoRA: the tenant adapter this request decodes under
    # (None = base model).  Validated against the loaded-adapter table at
    # submit (fail fast) AND re-resolved at admission (the adapter may
    # have been evicted while the request sat queued); ``adapter_row`` is
    # the resolved bank row the slot gathers each step (0 = zero adapter).
    adapter_id: Optional[str] = None
    adapter_row: int = 0
    # cost-attribution label (airwatch CostLedger): who to BILL this
    # request's tokens/chip-seconds to when that differs from the LoRA
    # tenant — the batch lane stamps ``batch:<job_id>`` here so offline
    # work never folds into the interactive "default" tenant.  Unlike
    # ``adapter_id`` it is never validated (a pure label, not a bank row);
    # billing uses ``tenant or adapter_id``.
    tenant: Optional[str] = None
