"""The continuous-batching inference engine for the causal LM, the
counterpart of ``tpu_air/engine/engine.py`` on torch tensors on the model's
device.

One :class:`InferenceEngine` owns a fixed pool of ``S`` sequence slots and
one decode step over that pool for its whole life; the KV cache is written
in place, never copied.  Two KV layouts share the host loop
(``EngineConfig.kv_mode``):

* **paged** (default) — per-layer page pools ``[P, page_len, h*d]`` plus a
  host block table mapping slot positions onto refcounted pages
  (``engine/kvpool/``).  Prompts prefill in page-sized CHUNKS between decode
  steps; prompts sharing a cached prefix skip the covered chunks and share
  the physical pages, copy-on-write on the first divergent append.
* **slab** — one private ``[slot_len]`` KV row per slot, whole-prompt
  bucketed prefill.

Requests flow through three host-side phases BETWEEN device steps:

1. **admission** — FIFO from the scheduler queue (paged: gated on KV-page
   capacity with a bounded reorder window so a big blocked head can't
   starve small requests behind it).
2. **prefill** — slab: one bucketed B=1 prefill per request, copied into
   the slab row; paged: up to ``prefill_chunks_per_step`` chunk calls per
   engine step, shortest-remaining-prompt first.
3. **decode + retirement** — one fixed-shape step over all ``S`` rows; a
   row that emits EOS (inclusive) or exhausts its budget is released (paged:
   its private pages return to the free list; its prompt's pages stay
   resident in the prefix cache).

Every step has a fixed shape and rows do not see each other, so with greedy
decoding a request's tokens do not depend on its neighbours: in both kv
modes they equal offline ``generate`` on the same prompt (the CPU tests pin
this for burst, staggered and trickle arrivals).  On the card every decode
step runs the decode-attention kernel in each layer.

The step loop runs in a daemon thread that enters ``torch.inference_mode()``
itself (grad mode is per thread), and every tensor the engine makes names
the model's device (the current CUDA device is per thread too).  A decode
step makes one host sync, the ``.cpu()`` of its tokens; a prefill's final
chunk makes one more, for the first token.

Three things change a running engine between steps, each under the step
lock:

* **live weights** — :meth:`InferenceEngine.swap_params` puts a new state
  dict in place of the serving weights and keeps the prior tensors for one
  :meth:`~InferenceEngine.rollback_params`; slots, tokens, positions and
  pages are untouched, so in-flight streams continue on the new weights at
  their exact positions;
* **multi-tenant LoRA head deltas** (paged only, ``adapter_slots > 0``) —
  f32 banks ``[A+1, d, r]`` and ``[A+1, r, V]`` on the device, row 0 the
  zero adapter; a request names its tenant (``adapter_id``) and every step
  adds its row's ``(h @ a) @ b`` to the logits;
* **preemption migration** (paged only) — :meth:`~InferenceEngine.preempt`
  freezes admission, :meth:`~InferenceEngine.migrate_out` ships every
  decoding slot's prompt, streamed tokens and KV pages as CPU tensors, and
  :meth:`~InferenceEngine.submit_migrated` lands one on another engine,
  which continues the stream token for token and runs no prefill chunk.

The disaggregated handoff (paged only): :meth:`~InferenceEngine.
submit_prefilled` queues a request whose prefill ran on a
:class:`~tpu_air_torch.engine.dist.PrefillWorker`; admission writes the
shipped pages into unshared pages, emits the worker's first token and goes
straight to decode.  The sharded engine
(:class:`~tpu_air_torch.engine.dist.MeshEngine`) is this engine over other
storage: it overrides the hooks marked "sharded-layout hooks" below.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from tpu_air_torch.faults import plan as _faults
from tpu_air_torch.models.lm.generate import (
    init_paged_cache,
    init_slot_cache,
    make_lm_decode_step_fn,
    make_lm_paged_decode_step_fn,
    make_lm_prefill_chunk_fn,
    make_lm_prefill_fn,
    page_copy,
)
from tpu_air_torch.observability import perf as _perf
from tpu_air_torch.observability import tracing as _tracing

from .dist.kv_transfer import extract_kv_pages, insert_kv_pages, validate_kv_payload
from .kvpool import PagedKVPool
from .kvpool.allocator import NULL_PAGE
from .metrics import EngineMetrics, unregister
from .scheduler import Scheduler
from .slots import Slot, SlotManager, make_insert_fn
from .types import (
    PRIORITIES,
    EngineClosedError,
    EngineConfig,
    EngineDrainingError,
    EngineOverloadedError,
    Request,
    RequestValidationError,
    ResponseStream,
)


def _once(fn: Callable[[], None]) -> Callable[[], None]:
    """``fn`` to be called at most once, from whichever thread comes first."""
    lock = threading.Lock()
    done = [False]

    def call() -> None:
        with lock:
            if done[0]:
                return
            done[0] = True
        fn()

    return call


class InferenceEngine:
    """Slot-pool online inference over a causal LM that holds its weights on
    the device the engine runs on.

    ``submit`` is thread-safe and non-blocking (raises
    :class:`EngineOverloadedError` under backpressure); tokens stream back
    on the returned :class:`ResponseStream` as they are decoded.  With
    ``auto_start=True`` (the default) a daemon thread drives the step loop;
    ``auto_start=False`` hands the loop to the caller via :meth:`step` —
    the deterministic mode the parity tests drive.
    """

    def __init__(self, model, config: Optional[EngineConfig] = None,
                 *, auto_start: bool = True, name: str = "engine"):
        self.model = model
        self.device = model.device
        self.config = config or EngineConfig()
        self.name = name
        cfg = self.config
        if cfg.eos_token_id == "model":
            self.eos_token_id = model.config.eos_token_id
        else:
            self.eos_token_id = cfg.eos_token_id
        if cfg.slot_len > model.config.max_seq_len:
            raise ValueError(
                f"slot_len {cfg.slot_len} exceeds the model's max_seq_len "
                f"{model.config.max_seq_len}"
            )
        if cfg.kv_mode not in ("paged", "slab"):
            raise ValueError(f"unknown kv_mode {cfg.kv_mode!r}")
        self.paged = cfg.kv_mode == "paged"
        self.adapters_enabled = cfg.adapter_slots > 0
        if self.adapters_enabled and not self.paged:
            raise ValueError("adapter_slots requires the paged engine (kv_mode='paged')")

        # device side: the persistent KV pool + the phases over it
        if self.paged:
            self._build_paged_state()
        else:
            self._build_slab_state()

        # host side: authoritative per-slot state the step args come from
        self._cur_tok = np.zeros((cfg.num_slots,), np.int64)
        self._pos = np.zeros((cfg.num_slots,), np.int64)
        self._round_reserved = 0   # pages promised during one admission round
        self._chunks_run = 0       # prefill chunk calls, engine lifetime

        self.scheduler = Scheduler(cfg)
        self.slots = SlotManager(cfg.num_slots)
        self.metrics = EngineMetrics(name=name, num_slots=cfg.num_slots)
        # analytic flops/bytes per program, fed into the metrics ledger with
        # each program's measured wall time.  The decode step attends the
        # full context for every slot whatever the occupancy, so it is
        # priced once, at S rows x slot_len.
        self._cost_model = _perf.LMCostModel(model.config)
        self._decode_cost = self._cost_model.decode_step_cost(cfg.num_slots, cfg.slot_len)

        # live weights: the version serving and the PRIOR tensors, kept for
        # one rollback that reads no store (so it survives a corrupt or
        # collected publish); while they are kept, the weights take twice
        # their memory
        self._weights_version: Optional[int] = None
        self._prev_weights: Optional[Dict[str, torch.Tensor]] = None
        self._prev_version: Optional[int] = None

        # multi-tenant LoRA: name -> bank row (row 0 = the zero adapter) and
        # the host per-slot rows the decode step gathers.  Lock order:
        # _step_lock OUTER, _adapter_lock inner
        self._adapter_rows: Dict[str, int] = {}
        self._adapter_lock = threading.Lock()
        self._adapter_ids_host = np.zeros((cfg.num_slots,), np.int64)

        self._next_request_id = 0
        self._id_lock = threading.Lock()
        self._step_lock = threading.Lock()
        # callers waiting in _between_steps; the loop stays out of the step
        # lock while any wait
        self._freezers = 0
        self._freezers_lock = threading.Lock()
        self._closed = False
        self._draining = False
        self._preempting = False
        self._round_admits = 0  # slots taken during one admission round
        self._thread: Optional[threading.Thread] = None
        if auto_start:
            self.start()

    # -- device state ----------------------------------------------------------
    def _build_paged_state(self) -> None:
        cfg = self.config
        self.pool = PagedKVPool(
            cfg.pool_pages(), cfg.page_len, cfg.num_slots,
            cfg.pages_per_slot(), prefix_cache=cfg.prefix_cache,
        )
        self.cache = init_paged_cache(
            self.model, cfg.num_slots, cfg.pool_pages(), cfg.page_len,
            cfg.pages_per_slot(),
        )
        if self.adapters_enabled:
            mc = self.model.config
            A, r = cfg.adapter_slots, cfg.adapter_rank
            # row 0 is the pinned zero adapter: a base-model slot gathers an
            # exact-zero delta, so its tokens are the base model's
            self._adapter_a = torch.zeros((A + 1, mc.d_model, r), device=self.device)
            self._adapter_b = torch.zeros((A + 1, r, mc.vocab_size), device=self.device)
        self._build_step_fns()

    def _build_slab_state(self) -> None:
        cfg = self.config
        self.pool = None
        self.cache = init_slot_cache(self.model, cfg.num_slots, cfg.slot_len)
        self._insert = make_insert_fn()
        self._prefill_fns: Dict[int, Any] = {}  # bucket -> prefill fn
        self._build_step_fns()

    def _build_step_fns(self) -> None:
        """The step functions over the model's weights as they are now.
        Each holds the f32 head it was made with, so a weight swap makes
        them anew (the slab prefill reads the head at every call)."""
        cfg = self.config
        if self.paged:
            # airlint: disable=CC001 — _step_lock, held by _point_weights()'s callers
            # through _between_steps(), an explicit acquire() the lockset model
            # cannot see; the constructor runs before the loop's thread
            self._decode_step = make_lm_paged_decode_step_fn(
                self.model, cfg.slot_len, adapters=self.adapters_enabled)
            # airlint: disable=CC001 — _step_lock, as for _decode_step above
            self._chunk_fn = make_lm_prefill_chunk_fn(
                self.model, cfg.page_len, cfg.slot_len, adapters=self.adapters_enabled)
            # airlint: disable=CC001 — _step_lock, as for _decode_step above
            self._copy_fn = page_copy
        else:
            self._decode_step = make_lm_decode_step_fn(self.model, cfg.slot_len)

    def _sync(self) -> None:
        """Wait for the device's queued work (nothing to wait for on the
        CPU)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        """A host array as an int64 tensor on the engine's device."""
        return torch.from_numpy(np.ascontiguousarray(a, np.int64)).to(self.device)

    # -- submission (any thread) ---------------------------------------------
    def _make_request(self, prompt, max_new_tokens, stream,
                      priority: str = "interactive", *,
                      admit_while_draining: bool = False,
                      deadline_ms: Optional[float] = None,
                      adapter_id: Optional[str] = None,
                      tenant: Optional[str] = None) -> Request:
        """Validation + Request construction for both submit paths.  A
        migrated stream is admitted while draining (``admit_while_draining``):
        its source already decoded it."""
        # airlint: disable=CC001 — _closed/_draining are GIL-atomic
        # monotonic bools (False→True once); a submit racing the flip is
        # indistinguishable from one that arrived a moment earlier
        if self._closed:
            raise EngineClosedError("engine is shut down")
        # airlint: disable=CC001 — same monotonic-flag discipline as _closed
        if self._draining and not admit_while_draining:
            raise EngineDrainingError(
                f"engine {self.name!r} is draining; submit elsewhere")
        if priority not in PRIORITIES:
            raise ValueError(
                f"unknown priority {priority!r} (expected one of {PRIORITIES})"
            )
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("empty prompt")
        budget = (self.config.max_new_tokens if max_new_tokens is None
                  else int(max_new_tokens))
        if budget < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {budget}")
        if len(prompt) + budget > self.config.slot_len:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens ({budget}) "
                f"exceeds slot_len ({self.config.slot_len})"
            )
        if adapter_id is not None:
            # fail fast (the proxy maps RequestValidationError to HTTP 400);
            # admission resolves the name again: it may be unloaded meanwhile
            if not self.adapters_enabled:
                raise RequestValidationError(
                    "adapter_id requires EngineConfig.adapter_slots > 0")
            with self._adapter_lock:
                if adapter_id not in self._adapter_rows:
                    raise RequestValidationError(f"unknown adapter {adapter_id!r}")
        with self._id_lock:
            rid = self._next_request_id
            self._next_request_id += 1
        return Request(request_id=rid, prompt=prompt, max_new_tokens=budget,
                       stream=stream if stream is not None
                       else ResponseStream(rid),
                       priority=priority,
                       deadline_ms=(None if deadline_ms is None
                                    else float(deadline_ms)),
                       adapter_id=adapter_id,
                       tenant=(str(tenant) if tenant else None))

    def _enqueue(self, req: Request) -> ResponseStream:
        try:
            self.scheduler.submit(req)
        except EngineOverloadedError:  # backpressure: count the 503, surface it
            self.metrics.record_reject(req.priority)
            raise
        self.metrics.record_submit(req.priority)
        return req.stream

    def submit(self, prompt: Sequence[int],
               max_new_tokens: Optional[int] = None, *,
               priority: str = "interactive",
               stream: Optional[ResponseStream] = None,
               deadline_ms: Optional[float] = None,
               adapter_id: Optional[str] = None,
               tenant: Optional[str] = None) -> ResponseStream:
        """Queue one prompt; returns its token stream immediately.

        ``priority`` is the request's SLO class (``types.PRIORITIES``):
        admission pops interactive first each step, and under backpressure
        best-effort sheds at half the queue depth interactive does.
        ``stream`` lets a front end that already handed a stream to its
        caller have the engine emit onto it.  ``deadline_ms`` is the
        request's ABSOLUTE end-to-end deadline (unix-epoch ms): still queued
        past it, the request expires with ``DeadlineExceededError``.
        ``adapter_id`` names the tenant LoRA adapter the request decodes
        under (None: the base model; a name not loaded raises
        :class:`RequestValidationError`).  ``tenant`` is a cost-attribution
        label, never validated: billing uses ``tenant or adapter_id``."""
        return self._enqueue(self._make_request(
            prompt, max_new_tokens, stream, priority, deadline_ms=deadline_ms,
            adapter_id=adapter_id, tenant=tenant))

    def generate(self, prompts: Sequence[Sequence[int]],
                 max_new_tokens: Optional[int] = None,
                 timeout: Optional[float] = 120.0) -> List[List[int]]:
        """Blocking convenience: submit every prompt, join every stream.
        In manual mode (no background thread) it drives :meth:`step`."""
        streams = [self.submit(p, max_new_tokens) for p in prompts]
        if self._thread is None:
            while not self.idle():
                self.step()
        return [s.result(timeout) for s in streams]

    def submit_prefilled(self, prompt: Sequence[int], first_token: int,
                         kv_pages: Dict[str, Any],
                         max_new_tokens: Optional[int] = None, *,
                         priority: str = "interactive",
                         stream: Optional[ResponseStream] = None,
                         deadline_ms: Optional[float] = None,
                         release: Optional[Callable[[], None]] = None) -> ResponseStream:
        """Queue a request whose prefill ALREADY RAN elsewhere (a
        :class:`~tpu_air_torch.engine.dist.PrefillWorker` replica):
        ``kv_pages`` is the ``extract_kv_pages`` payload covering the whole
        prompt, of this package's worker or the JAX package's, and
        ``first_token`` the prefill's greedy first token.  Admission
        allocates unshared pages, inserts the shipped K/V, emits
        ``first_token`` and goes straight to decode: the same capacity gate
        and deferral as a normal submit, so pool exhaustion queues the
        handoff instead of dropping it.  ``release`` is called once the
        engine is done with ``kv_pages``: when admission has copied them
        into the pool, or when the request ends without landing them (a
        deferred submit holds them until then)."""
        if not self.paged:
            raise ValueError("submit_prefilled requires a paged engine (kv_mode='paged')")
        # a handoff rides through a drain: the router admitted it before the
        # drain started and its prefill already ran on another replica
        req = self._make_request(prompt, max_new_tokens, stream, priority,
                                 admit_while_draining=True, deadline_ms=deadline_ms)
        req.prefilled = {"first_token": int(first_token), "pages": kv_pages}
        if release is not None:
            req.prefilled["release"] = _once(release)
            req.stream._on_finish.append(req.prefilled["release"])
        return self._enqueue(req)

    # -- the engine loop -----------------------------------------------------
    @contextlib.contextmanager
    def _between_steps(self):
        """Hold the step lock for a caller outside the loop, between two
        steps.  The loop stays out of the lock while a caller waits: a bare
        Lock goes back to the loop that just released it, and the caller
        would wait until every slot had finished."""
        with self._freezers_lock:
            self._freezers += 1
        try:
            self._step_lock.acquire()
        finally:
            with self._freezers_lock:
                self._freezers -= 1
        try:
            yield
        finally:
            self._step_lock.release()

    def step(self) -> bool:
        """One deterministic engine iteration: admit into free slots, run
        the prefill quantum (paged), then one pool decode step if anything
        is decoding.  Returns True if any work happened."""
        with self._step_lock:
            worked = False
            self._begin_admission_round()
            self._round_admits = 0
            # airlint: disable=CC001 — _preempting is a GIL-atomic monotonic
            # bool; a round racing the flip admits one last batch
            if not self._preempting:
                for req in self.scheduler.pop_admissible(
                    self.slots.free_count(), self._admit_gate()
                ):
                    if self.paged:
                        self._admit_paged(req)
                    else:
                        self._admit(req)
                    worked = True
            if self.paged and self._prefill_quantum():
                worked = True
            if any(not s.prefilling for s in self.slots.active_slots()):
                self._decode_all()
                worked = True
            gauges: Dict[str, Any] = {}
            if self.paged:
                gauges = dict(
                    kvpool=self.pool.stats(),
                    reordered_admits=self.scheduler.reordered_admits,
                    prefill_chunks=self._chunks_run,
                )
            self.metrics.observe_gauges(
                self.scheduler.depth(), self.slots.occupancy(),
                queue_by_class=self.scheduler.depth_by_class(),
                draining=self._draining,
                deadline_expired=self.scheduler.deadline_expired,
                **gauges
            )
            return worked

    def idle(self) -> bool:
        return self.scheduler.depth() == 0 and self.slots.occupancy() == 0

    # -- draining (zero-downtime rollout / scale-down) ------------------------
    def drain(self) -> None:
        """Stop admitting NEW submissions; everything already queued or in a
        slot retires normally.  Idempotent; :meth:`close` still stops the
        loop."""
        self._draining = True

    @property
    def draining(self) -> bool:
        return self._draining

    def drained(self) -> bool:
        """True once draining AND no admitted work remains."""
        return self._draining and self.idle()

    # -- preemption migration ------------------------------------------------
    def preempt(self) -> None:
        """A revocation notice arrived: admit nothing more.  New submits
        shed (:class:`EngineDrainingError`: the proxy routes elsewhere) and
        the queued backlog STAYS queued: prefilling it here would spend the
        notice window on work this engine cannot finish, and the journal
        replays it on a survivor.  Idempotent."""
        self._draining = True
        # airlint: disable=CC001 — GIL-atomic monotonic flip, never unset
        self._preempting = True

    @property
    def preempting(self) -> bool:
        # airlint: disable=CC001 — GIL-atomic monotonic bool read
        return self._preempting

    def migrate_out(self) -> List[Dict[str, Any]]:
        """Freeze the loop between steps and pull every DECODING slot into a
        payload for :meth:`submit_migrated` on a survivor: the prompt, every
        token streamed so far, the cursor (``pos == len(prompt) +
        len(streamed) - 1``), the remaining budget, the request's class,
        deadline, adapter and tenant, and the KV pages of positions
        ``0..pos-1`` as CPU tensors (:func:`extract_kv_pages`).  Slots still
        prefilling and the queue are not shipped: the journal replays them.
        Shipped slots are released here; their streams stay unfinished, and
        the proxy re-pins their pollers at the destination."""
        if not self.paged:
            raise ValueError("migrate_out requires a paged engine (kv_mode='paged')")
        self.preempt()
        payloads: List[Dict[str, Any]] = []
        with self._between_steps():
            for slot in list(self.slots.active_slots()):
                if slot.prefilling:
                    continue
                req = slot.request
                p = int(slot.pos)
                page_ids = self.pool.prompt_page_ids(slot.index, p)
                # airlint: disable=CC003 — the only sleep here is an injected
                # kv.transfer delay; the loop is frozen by design meanwhile
                pages = self._extract_shipped_pages(page_ids)
                payloads.append({
                    "request_id": req.request_id,
                    "prompt": [int(t) for t in req.prompt],
                    "streamed": req.stream.tokens_so_far(),
                    "pos": p,
                    "budget_left": int(slot.budget_left),
                    "priority": req.priority,
                    "deadline_ms": req.deadline_ms,
                    "adapter_id": req.adapter_id,
                    "tenant": req.tenant,
                    "pages": pages,
                })
                self.metrics.record_migration("out", len(page_ids))
                # the destination continues the stream: nothing is waste
                self._release(slot)
        return payloads

    def submit_migrated(self, payload: Dict[str, Any], *,
                        stream: Optional[ResponseStream] = None) -> ResponseStream:
        """Land one :meth:`migrate_out` payload, of this package's engine or
        of the JAX package's, on this engine.  It is checked against this
        cache before it is queued: a bad payload raises
        :class:`~tpu_air_torch.engine.dist.kv_transfer.KVTransferError` or
        :class:`RequestValidationError` here, and the supervisor falls back
        to replay.  Admission writes the pages into unshared pages, replays
        the streamed tokens onto the new stream and decodes on from the
        cursor: no prefill chunk runs, and greedy tokens are those the
        stream would have had, had it never moved."""
        if not self.paged:
            raise ValueError("submit_migrated requires a paged engine (kv_mode='paged')")
        prompt = [int(t) for t in payload["prompt"]]
        streamed = [int(t) for t in payload["streamed"]]
        pos = int(payload["pos"])
        budget_left = int(payload["budget_left"])
        if not streamed or budget_left < 1 or pos != len(prompt) + len(streamed) - 1:
            raise RequestValidationError(
                f"inconsistent migration payload: prompt={len(prompt)} "
                f"streamed={len(streamed)} pos={pos} budget_left={budget_left}")
        validate_kv_payload(self._kv_geometry(), range(-(-pos // self.config.page_len)),
                            payload["pages"])
        # the cache holds positions 0..pos-1: the prompt and every streamed
        # token but the last (the cursor token, computed but not yet
        # written); that context is the "prompt" the pool admits
        req = self._make_request((prompt + streamed)[:pos], budget_left + 1, stream,
                                 payload.get("priority", "interactive"),
                                 admit_while_draining=True,
                                 deadline_ms=payload.get("deadline_ms"),
                                 adapter_id=payload.get("adapter_id"),
                                 tenant=payload.get("tenant"))
        req.migrated = {"streamed": streamed, "pages": payload["pages"],
                        "client_prompt_len": len(prompt)}
        return self._enqueue(req)

    def _admit_gate(self):
        """Per-round admission predicate handed to the scheduler: the paged
        page-capacity gate combined with the interactive slot reserve
        (``EngineConfig.reserved_interactive_slots``): a non-interactive
        request takes a slot only while MORE than ``reserved`` slots would
        stay free after this round's takes.  None (the scheduler's pure pop)
        when neither applies."""
        page_gate = self._can_admit if self.paged else None
        reserved = self.config.reserved_interactive_slots
        if reserved <= 0:
            return page_gate

        def gate(req: Request) -> bool:
            if req.priority != "interactive" and (
                self.slots.free_count() - self._round_admits <= reserved
            ):
                return False
            if page_gate is not None and not page_gate(req):
                return False
            self._round_admits += 1
            return True

        return gate

    # -- paged admission -----------------------------------------------------
    def _begin_admission_round(self) -> None:
        """Reset the per-round reservation before ``pop_admissible`` probes
        the queue (the MeshEngine tracks reservations PER dp REPLICA)."""
        self._round_reserved = 0

    def _can_admit(self, req: Request) -> bool:
        """Page-capacity gate: can the pool cover the request's WORST CASE
        (no prefix sharing — a prior admit's eviction may invalidate a
        probe-time match, and shared pages stop being evictable)?  A True
        answer RESERVES the pages for the rest of the round."""
        need = self.pool.worst_case_pages(len(req.prompt), req.max_new_tokens)
        if self.slots.free_count() == 0:
            return False
        if self._round_reserved + need > self.pool.capacity():
            return False
        self._round_reserved += need
        return True

    def _admit_paged(self, req: Request) -> None:
        """Reserve pages + block-table row; the compute happens in the
        chunked prefill quantum (TTFT lands when the final chunk runs).  A
        migrated stream runs no chunk: its pages came with it."""
        if not self._resolve_adapter(req):
            return
        slot = self.slots.acquire()
        slot.request = req
        self._adapter_ids_host[slot.index] = req.adapter_row
        if req.prefilled is not None:
            self._admit_prefilled(slot, req)
            return
        if req.migrated is not None:
            self._admit_migrated(slot, req)
            return
        slot.prefilling = True
        slot.plan = self.pool.admit(slot.index, req.prompt, req.max_new_tokens)
        # chunks about to be recomputed whose content the prefix cache held
        # before eviction: work the machine already did once
        if slot.plan.reprefill_tokens:
            self.metrics.record_goodput("reprefill_cache_miss", slot.plan.reprefill_tokens)

    def _admit_prefilled(self, slot: Slot, req: Request) -> None:
        """Land a disaggregated handoff: UNSHARED pages (the shipped K/V is
        written into them, and a write must never touch a prefix-shared
        page), the pages inserted, the worker's first token emitted, the
        slot handed straight to decode.  ``register`` then publishes the
        populated prompt pages to this engine's prefix cache, so later
        local submits share them."""
        n = len(req.prompt)
        slot.plan = self.pool.admit(slot.index, req.prompt, req.max_new_tokens, share=False)
        slot.plan.chunks_done = len(slot.plan.chunk_starts)   # nothing to run
        page_ids = self.pool.prompt_page_ids(slot.index, n)
        try:
            self._insert_shipped_pages(page_ids, req.prefilled["pages"])
        except ValueError as e:   # KVTransferError: the payload does not fit
            self._fail_admission(slot, req, e)
            return
        finally:
            # the pages are in the pool (or refused): the payload is done with
            req.prefilled["pages"] = None
            release = req.prefilled.pop("release", None)
            if release is not None:
                release()
        first = int(req.prefilled["first_token"])
        req.first_token_at = time.monotonic()
        if req.t_submit_ns:
            # t_first == t_admit: the prefill ran on the worker, whose own
            # span reports it
            req.t_first_ns = req.t_admit_ns
        self.metrics.record_ttft(req.first_token_at - req.submitted_at, req.priority,
                                 trace_id=(req.trace_ctx or {}).get("trace_id"))
        req.stream._emit(first)
        self.metrics.record_tokens(1)
        self.pool.register(slot.index, req.prompt)
        self._start_decode(slot, first)

    def _admit_migrated(self, slot: Slot, req: Request) -> None:
        """Land a migrated stream: unshared pages sized for the whole
        remaining run, the shipped K/V written into them, the streamed
        tokens replayed onto the stream (it carries the FULL client-visible
        list: the proxy re-pins pollers at offset 0), and the cursor parked
        where the source stopped.  ``chunks_done`` covers the whole chunk
        list, so no chunk runs (``migrations.in_reprefill_chunks`` stays
        0).  The pages are not published to the prefix cache: the tail page
        is mid-append, and the admitted "prompt" holds generated tokens."""
        m = req.migrated
        p = len(req.prompt)                       # cache-resident positions 0..p-1
        slot.plan = self.pool.admit(slot.index, req.prompt, req.max_new_tokens, share=False)
        slot.plan.chunks_done = len(slot.plan.chunk_starts)
        page_ids = self.pool.prompt_page_ids(slot.index, p)
        try:
            self._insert_shipped_pages(page_ids, m["pages"])
        except ValueError as e:   # KVTransferError: the payload does not fit
            self._fail_admission(slot, req, e)
            return
        req.first_token_at = time.monotonic()
        if req.t_submit_ns:
            # t_first == t_admit: the prefill ran on the source and is not
            # reported again here
            req.t_first_ns = req.t_admit_ns
        streamed = m["streamed"]
        for tok in streamed:      # counted and TTFT-stamped on the source
            req.stream._emit(tok)
        slot.prefilling = False
        slot.pos = p
        slot.budget_left = req.max_new_tokens - 1
        self._cur_tok[slot.index] = streamed[-1]
        self._pos[slot.index] = p
        self.metrics.record_migration("in", len(page_ids),
                                      reprefill_chunks=slot.plan.chunks_left)
        self.metrics.record_tenant_migrated(req.tenant or req.adapter_id, len(page_ids))
        if self.eos_token_id is not None and streamed[-1] == self.eos_token_id:
            self._retire(slot)

    def _fail_admission(self, slot: Slot, req: Request, error: BaseException) -> None:
        """Admission found the request unservable (a payload that does not
        fit): give the slot back and fail the stream loudly, so that the
        poller sees the error and the journal replays, rather than decode
        from corrupt pages."""
        self._release(slot)
        req.stream._finish(error)

    # -- sharded-layout hooks (MeshEngine overrides them) --------------------
    def _kv_geometry(self):
        """The per-layer caches a shipped payload is checked against."""
        # airlint: disable=CC001 — _step_lock covers the rebinding; a geometry-only read
        # (the step functions write the pools in place and hand back the same
        # cache list, so the rebinding never changes what this returns)
        return self.cache

    def _extract_shipped_pages(self, page_ids):
        """Pages ``page_ids`` as a flat ``h*d`` payload (``migrate_out``)."""
        return extract_kv_pages(self.cache, page_ids)

    def _insert_shipped_pages(self, page_ids, payload) -> None:
        """Write a shipped payload's pages (a handoff or a migrated stream)
        into ``page_ids`` of the pools, in place."""
        insert_kv_pages(self.cache, page_ids, payload)

    def _null_entry(self, slot_index: int) -> int:
        """The page id a non-decoding slot's table row is masked with: the
        single-card pool's null page; the MeshEngine's is the slot's own
        replica's."""
        return NULL_PAGE

    def _prefill_quantum(self) -> bool:
        """Run up to ``prefill_chunks_per_step`` chunk calls,
        SHORTEST-REMAINING-PROMPT first (ties: request id = arrival order),
        so a long prompt cannot stall in-flight decodes and short requests
        keep a flat TTFT while it streams in."""
        ran = False
        for _ in range(max(1, self.config.prefill_chunks_per_step)):
            pending = [s for s in self.slots.active_slots() if s.prefilling]
            if not pending:
                break
            slot = min(
                pending,
                key=lambda s: (s.plan.chunks_left, s.request.request_id),
            )
            self._run_chunk(slot)
            ran = True
        return ran

    def _run_chunk(self, slot: Slot) -> None:
        plan = slot.plan
        req = slot.request
        C = self.config.page_len
        p0 = plan.next_start
        n = plan.prompt_len
        ids = np.full((1, C), self.model.config.pad_token_id, np.int64)
        chunk_toks = req.prompt[p0:p0 + C]
        ids[0, :len(chunk_toks)] = chunk_toks
        is_last = plan.chunks_done == len(plan.chunk_starts) - 1
        last_local = (n - 1 - p0) if is_last else (C - 1)
        row = self.pool.chunk_row(slot.index, p0, plan.null_target)
        banks = ((self._adapter_a, self._adapter_b, req.adapter_row)
                 if self.adapters_enabled else ())
        t0 = time.monotonic()
        self.cache, tok = self._chunk_fn(self.cache, self._tensor(ids), p0, last_local,
                                         self._tensor(row), *banks)
        # the host clock at dispatch: only the final chunk syncs (int(tok)
        # below), so a mid-prompt chunk's seconds are its launch cost
        self.metrics.record_program("prefill_chunk",
                                    self._cost_model.prefill_chunk_cost(C, p0),
                                    time.monotonic() - t0)
        plan.chunks_done += 1
        self._chunks_run += 1
        if not plan.done:
            return
        # final chunk: first token, publication, CoW, hand over to decode
        first = int(tok)
        req.first_token_at = time.monotonic()
        if req.t_submit_ns:  # traced request: stamp TTFT for span emission
            req.t_first_ns = _tracing.now_ns()
        self.metrics.record_ttft(req.first_token_at - req.submitted_at,
                                 req.priority,
                                 trace_id=(req.trace_ctx or {}).get("trace_id"))
        req.stream._emit(first)
        self.metrics.record_tokens(1)  # prefill's first token
        self.pool.register(slot.index, req.prompt)
        cow = self.pool.resolve_cow(slot.index)
        if cow is not None:
            dst, src = cow
            self.cache = self._copy_fn(self.cache, dst, src)
        self._start_decode(slot, first)

    def _start_decode(self, slot: Slot, first: int) -> None:
        """Hand a prefilled slot to the decode step at its prompt's end, or
        retire it there (budget of 1, or EOS first)."""
        n = len(slot.request.prompt)
        slot.prefilling = False
        slot.pos = n
        slot.budget_left = slot.request.max_new_tokens - 1
        self._cur_tok[slot.index] = first
        self._pos[slot.index] = n
        if slot.budget_left == 0 or (
            self.eos_token_id is not None and first == self.eos_token_id
        ):
            self._retire(slot)

    # -- slab admission ------------------------------------------------------
    def _prefill_for(self, bucket: int):
        if bucket not in self._prefill_fns:
            self._prefill_fns[bucket] = make_lm_prefill_fn(self.model, bucket)
        return self._prefill_fns[bucket]

    def _admit(self, req: Request) -> None:
        slot = self.slots.acquire()
        n = len(req.prompt)
        bucket = self.config.bucket_for(n)
        ids = np.full((1, bucket), self.model.config.pad_token_id, np.int64)
        ids[0, :n] = req.prompt
        tok, segment = self._prefill_for(bucket)(self._tensor(ids),
                                                 self._tensor(np.array([n - 1])))
        # graft the whole padded segment: pad positions >= n are masked by
        # the per-row validity check until decode writes overwrite them
        self.cache = self._insert(self.cache, segment, slot.index)
        first = int(tok[0])
        req.first_token_at = time.monotonic()
        if req.t_submit_ns:  # traced request: stamp TTFT for span emission
            req.t_first_ns = _tracing.now_ns()
        self.metrics.record_ttft(req.first_token_at - req.submitted_at,
                                 req.priority,
                                 trace_id=(req.trace_ctx or {}).get("trace_id"))
        req.stream._emit(first)
        self.metrics.record_tokens(1)  # prefill's first token
        slot.request = req
        self._start_decode(slot, first)

    # -- live weights (serve/weights.py) --------------------------------------
    def swap_params(self, new_state: Dict[str, Any], *, version: Optional[int] = None) -> float:
        """Serve ``new_state`` from the next step on: a state dict with the
        model's keys and shapes, of tensors or numpy arrays on any device
        and in any float type.  Keys and shapes are checked against the
        serving model first; a mismatch raises ``ValueError`` before
        anything changes.  The new tensors are cast to each parameter's
        type and copied to the engine's device OUTSIDE the step lock, so
        decoding goes on during the host-to-device copy.  Under the lock
        the parameters are pointed at them, the step functions are made anew
        over the new head, and the device is synchronized before the lock
        is released, so the next step reads finished weights.  Slots,
        tokens, positions and pages are untouched: in-flight streams
        continue on the new weights at their exact positions.  The prior
        tensors are kept for :meth:`rollback_params`.

        Returns the stall in milliseconds, request-to-done wall time: the
        copy, the lock wait and the swap (the gap it opens between decode
        steps is the last two)."""
        t_req = time.monotonic()
        if _faults.enabled():
            _faults.perturb("weights.swap", key=self.name)
        serving = self.model.state_dict(keep_vars=True)
        if set(new_state) != set(serving):
            missing = sorted(set(serving) - set(new_state))
            extra = sorted(set(new_state) - set(serving))
            raise ValueError(f"weight swap rejected: keys differ from the serving model "
                             f"(missing {missing[:4]}, unexpected {extra[:4]})")
        new = {k: torch.as_tensor(v) for k, v in new_state.items()}
        for name, cur in serving.items():
            if tuple(new[name].shape) != tuple(cur.shape):
                raise ValueError(f"weight swap rejected: {name} is {tuple(new[name].shape)}, "
                                 f"the serving model's {tuple(cur.shape)}")
        with torch.no_grad():
            placed = {name: new[name].to(device=cur.device, dtype=cur.dtype, copy=True)
                      for name, cur in serving.items()}
        self._sync()
        with self._between_steps():
            prev = {name: p.data for name, p in serving.items()}
            self._point_weights(serving, placed)
            self._prev_weights, self._prev_version = prev, self._weights_version
            self._weights_version = version
            stall_ms = (time.monotonic() - t_req) * 1000.0
        self.metrics.record_weights_swap(version, stall_ms)
        return stall_ms

    def rollback_params(self) -> float:
        """Serve again the weights :meth:`swap_params` replaced: a pointer
        swap under the step lock that reads no store, so it works when the
        bad publish's objects are corrupt or gone.  One-shot: the replaced
        tensors are dropped, and a second rollback raises
        ``RuntimeError``."""
        t_req = time.monotonic()
        with self._between_steps():
            if self._prev_weights is None:
                raise RuntimeError("no prior weights retained to roll back to")
            self._point_weights(self.model.state_dict(keep_vars=True), self._prev_weights)
            self._prev_weights = None
            self._weights_version, self._prev_version = self._prev_version, None
            version = self._weights_version
            stall_ms = (time.monotonic() - t_req) * 1000.0
        self.metrics.record_weights_swap(version, stall_ms, rollback=True)
        return stall_ms

    def _point_weights(self, serving: Dict[str, torch.Tensor],
                       tensors: Dict[str, torch.Tensor]) -> None:
        """Point each parameter at its new tensor, make the step functions
        anew over it and wait for the device (call with the step lock)."""
        for name, p in serving.items():
            p.data = tensors[name]
        self._build_step_fns()
        self._sync()

    def weights_version(self) -> Optional[int]:
        # airlint: disable=CC001 — GIL-atomic read for stats; a reader
        # racing a swap sees the old or the new version, both valid
        return self._weights_version

    # -- multi-tenant LoRA adapters ------------------------------------------
    def _resolve_adapter(self, req: Request) -> bool:
        """Admission-time resolution of ``req.adapter_id`` to a bank row.
        The adapter may have been unloaded while the request sat queued:
        then the stream fails loudly rather than serve base-model tokens
        under the tenant's name."""
        if req.adapter_id is None:
            req.adapter_row = 0
            return True
        with self._adapter_lock:
            row = self._adapter_rows.get(req.adapter_id)
        if row is None:
            req.stream._finish(RequestValidationError(
                f"adapter {req.adapter_id!r} was evicted while request "
                f"{req.request_id} was queued"))
            return False
        req.adapter_row = row
        return True

    def load_adapter(self, name: str, a, b) -> int:
        """Load (or reload in place) tenant ``name``'s LoRA head delta
        ``logits += (h @ a) @ b`` into a bank row; returns the row.  ``a``
        ``[d_model, r]``, ``b`` ``[r, vocab]`` (numpy or tensors); a rank
        below ``adapter_rank`` is zero-padded, which is exact.  Two row
        writes under the step lock, between steps."""
        if not self.adapters_enabled:
            raise ValueError("adapters not enabled (EngineConfig.adapter_slots=0)")
        mc, cfg = self.model.config, self.config
        a = torch.from_numpy(np.array(a, np.float32))    # a copy: the caller's may be read-only
        b = torch.from_numpy(np.array(b, np.float32))
        if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
            raise ValueError(f"adapter shapes must be [d,r] x [r,V], got {tuple(a.shape)} "
                             f"x {tuple(b.shape)}")
        if a.shape[0] != mc.d_model or b.shape[1] != mc.vocab_size:
            raise ValueError(f"adapter {tuple(a.shape)} x {tuple(b.shape)} does not fit "
                             f"model [d={mc.d_model}, V={mc.vocab_size}]")
        r = a.shape[1]
        if r > cfg.adapter_rank:
            raise ValueError(f"adapter rank {r} exceeds bank rank {cfg.adapter_rank}")
        pa = torch.zeros((mc.d_model, cfg.adapter_rank))
        pb = torch.zeros((cfg.adapter_rank, mc.vocab_size))
        pa[:, :r], pb[:r] = a, b
        with self._between_steps():
            with self._adapter_lock:
                row = self._adapter_rows.get(name)
                if row is None:
                    used = set(self._adapter_rows.values())
                    free = [i for i in range(1, cfg.adapter_slots + 1) if i not in used]
                    if not free:
                        raise ValueError(f"adapter bank full ({cfg.adapter_slots} rows); "
                                         "unload a tenant first")
                    row = free[0]
                    self._adapter_rows[name] = row
                n_loaded = len(self._adapter_rows)
            with torch.no_grad():
                # airlint: disable=CC001 — _step_lock, held by _between_steps() above
                # (an explicit acquire() the lockset model cannot see)
                self._adapter_a[row] = pa.to(self.device)
                # airlint: disable=CC001 — _step_lock, as for _adapter_a
                self._adapter_b[row] = pb.to(self.device)
        self.metrics.set_adapters_loaded(n_loaded)
        return row

    def unload_adapter(self, name: str) -> bool:
        """Evict tenant ``name``: zero its bank row and free it.  Raises
        ``RuntimeError`` while an active slot decodes under the row
        (eviction must not change tokens mid-stream); False when the name
        is not loaded."""
        if not self.adapters_enabled:
            return False
        with self._between_steps():
            with self._adapter_lock:
                row = self._adapter_rows.get(name)
                if row is None:
                    return False
                if any(self._adapter_ids_host[s.index] == row
                       for s in self.slots.active_slots()):
                    raise RuntimeError(f"adapter {name!r} is serving active slots; drain "
                                       "them before unloading")
                del self._adapter_rows[name]
                n_loaded = len(self._adapter_rows)
            with torch.no_grad():
                self._adapter_a[row] = 0.0
                self._adapter_b[row] = 0.0
        self.metrics.set_adapters_loaded(n_loaded)
        return True

    def adapters(self) -> Dict[str, int]:
        """Loaded tenant adapters: name -> bank row."""
        with self._adapter_lock:
            return dict(self._adapter_rows)

    # -- decode --------------------------------------------------------------
    def _decode_all(self) -> None:
        t0 = time.monotonic()
        tok, pos = self._tensor(self._cur_tok), self._tensor(self._pos)
        if self.paged:
            # non-decoding rows (free OR mid-prefill) ride along pointed at
            # the null page: their ride-along scatter can't touch a live or
            # prefix-shared page.  The authoritative table stays host-side.
            table = self.pool.block_table.copy()
            for s in self.slots.slots:
                if not s.active or s.prefilling:
                    table[s.index] = self._null_entry(s.index)
            # each slot's LoRA row goes in the way the table does: one host
            # array, row 0 the exact-zero delta
            banks = ((self._adapter_a, self._adapter_b, self._tensor(self._adapter_ids_host))
                     if self.adapters_enabled else ())
            self.cache, nxt = self._decode_step(self.cache, tok, pos, self._tensor(table),
                                                *banks)
        else:
            self.cache, nxt = self._decode_step(self.cache, tok, pos)
        nxt = nxt.cpu().numpy()  # airlint: disable=PT004 — the step's one host sync
        dt = time.monotonic() - t0
        self.metrics.record_program("decode_step", self._decode_cost, dt)
        emitted = 0
        for slot in self.slots.active_slots():
            if slot.prefilling:
                continue
            # airlint: disable=PT004 — nxt is host memory: the sync was above the loop
            token = int(nxt[slot.index])
            slot.request.stream._emit(token)
            emitted += 1
            slot.pos += 1
            slot.budget_left -= 1
            self._cur_tok[slot.index] = token
            self._pos[slot.index] = slot.pos
            if slot.budget_left == 0 or (
                self.eos_token_id is not None and token == self.eos_token_id
            ):
                self._retire(slot)
        self.metrics.record_step(dt, emitted)

    # -- retirement ----------------------------------------------------------
    def _retire(self, slot: Slot) -> None:
        req = slot.request
        if req.t_submit_ns:
            self._emit_request_spans(slot)
        req.stream._finish()
        self.metrics.record_complete()
        # goodput: every token this stream emitted reached a consumer that
        # saw the stream complete — useful work
        decoded = slot.pos - len(req.prompt) + 1
        self.metrics.record_goodput("useful", decoded)
        # per-tenant cost attribution: the stream's tokens and its KV-page
        # residency from first token to retirement (paged: the pool's own
        # ceil-division; slab: the fixed slot reservation)
        if self.paged:
            n_pages = -(-slot.pos // self.config.page_len)
        else:
            n_pages = self.config.pages_per_slot()
        resident_s = max(
            0.0, time.monotonic() - (req.first_token_at or req.submitted_at))
        self.metrics.record_tenant_retire(
            req.tenant or req.adapter_id,
            prefilled=len(req.prompt),
            decoded=decoded,
            kv_page_seconds=n_pages * resident_s)
        self._release(slot)

    def _release(self, slot: Slot) -> None:
        """Free a slot and its host state (paged: its private pages return
        to the free list; prompt pages the prefix cache registered stay
        resident for future hits)."""
        if self.paged:
            self.pool.release(slot.index)
        self.slots.release(slot)
        # airlint: disable=CC001 — _step_lock, held by every caller of _release()
        # (step() and close() by `with`, migrate_out() through _between_steps(),
        # an explicit acquire() the lockset model cannot see)
        self._cur_tok[slot.index] = 0
        # airlint: disable=CC001 — _step_lock, as for _cur_tok above
        self._pos[slot.index] = 0
        # airlint: disable=CC001 — _step_lock, as for _cur_tok above
        self._adapter_ids_host[slot.index] = 0

    def _emit_request_spans(self, slot: Slot) -> None:
        """Retirement-time span emission: the request's span tree (queue
        wait → prefill → decode residency) rebuilt from the stamps taken
        along the way, so the decode loop does no tracing work."""
        req = slot.request
        end = _tracing.now_ns()
        ctx = req.trace_ctx or {}
        root = _tracing.record_span(
            "engine.request",
            trace_id=ctx.get("trace_id"),
            parent_id=ctx.get("span_id"),
            start_ns=req.t_submit_ns,
            end_ns=end,
            attrs={"engine": self.name, "request_id": req.request_id},
        )
        if req.t_admit_ns:
            _tracing.record_span(
                "engine.queue_wait",
                trace_id=root.trace_id, parent_id=root.span_id,
                start_ns=req.t_submit_ns, end_ns=req.t_admit_ns,
            )
        if req.t_admit_ns and req.t_first_ns > req.t_admit_ns:
            # strictly after: a migrated stream lands with t_first == t_admit
            attrs = {"slot": slot.index, "prompt_len": len(req.prompt)}
            if self.paged and slot.plan is not None:
                attrs["chunks"] = len(slot.plan.chunk_starts)
                attrs["prefix_hit"] = slot.plan.prefix_tokens > 0
                attrs["prefix_tokens"] = slot.plan.prefix_tokens
            elif not self.paged:
                attrs["bucket"] = self.config.bucket_for(len(req.prompt))
            _tracing.record_span(
                "engine.prefill",
                trace_id=root.trace_id, parent_id=root.span_id,
                start_ns=req.t_admit_ns, end_ns=req.t_first_ns,
                attrs=attrs,
            )
        if req.t_first_ns:
            _tracing.record_span(
                "engine.decode",
                trace_id=root.trace_id, parent_id=root.span_id,
                start_ns=req.t_first_ns, end_ns=end,
                attrs={
                    "slot": slot.index,
                    "tokens": slot.pos - len(req.prompt) + 1,
                    "occupancy": self.slots.occupancy(),
                },
            )

    # -- background loop / lifecycle -----------------------------------------
    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._loop, name=f"tpu-air-{self.name}", daemon=True
        )
        self._thread.start()

    def _loop(self) -> None:
        with torch.inference_mode():
            # airlint: disable=CC001 — GIL-atomic stop flag; close() sets it
            # then joins this thread, so a stale read costs one iteration
            while not self._closed:
                # airlint: disable=CC001 — GIL-atomic int read; a stale read
                # costs one step before the waiting caller is served
                if self._freezers:
                    time.sleep(0.0005)
                    continue
                if not self.step():
                    self.scheduler.wait_for_work(0.01)

    def close(self) -> None:
        """Stop the loop; fail queued and in-flight requests loudly."""
        if self._closed:
            return
        self._closed = True
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        with self._step_lock:
            err = EngineClosedError("engine shut down")
            for req in self.scheduler.drain():
                req.stream._finish(err)
            # goodput: compute already spent on in-flight requests is lost —
            # a drained close sheds work it had prefilled, a hard close
            # kills live streams outright
            waste_cat = ("shed_after_prefill" if self._draining
                         else "dead_stream")
            for slot in self.slots.active_slots():
                req = slot.request
                if slot.prefilling:
                    plan = slot.plan
                    wasted = 0
                    if plan is not None and plan.chunks_done:
                        wasted = min(plan.chunks_done * self.config.page_len,
                                     len(req.prompt))
                else:
                    wasted = slot.pos - len(req.prompt) + 1
                self.metrics.record_goodput(waste_cat, wasted)
                req.stream._finish(err)
                self._release(slot)
        unregister(self.name)

    def __enter__(self) -> "InferenceEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
