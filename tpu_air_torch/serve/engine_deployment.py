"""EngineDeployment — serve the continuous-batching engines over HTTP, the
counterpart of ``tpu_air/serve/engine_deployment.py``.

Each replica actor owns one engine built from a Checkpoint on the replica's
device (``cuda:<first leased id>`` when the deployment leases the card,
``num_chips=1``, else what ``device=`` names): a
:class:`tpu_air_torch.engine.InferenceEngine` over a causal LM when the
``engine_config`` is an ``EngineConfig`` or None, a
:class:`tpu_air_torch.engine.T5Engine` when it is a ``T5EngineConfig`` (the
config type selects the engine family).  Distributed serving composes with
the LM engine: ``mesh=(dp, tp)`` builds a
:class:`~tpu_air_torch.engine.MeshEngine` over the replica's leased
devices (``cuda:<id>``, the ids wrapping onto the cards there are: one
card can hold a 2 x 2 mesh), and ``disagg=`` (the keyword arguments of a
:class:`~tpu_air_torch.engine.DisaggRouter`, e.g. ``{"prefill_replicas":
2}``) puts the router in front of the engine, its prefill workers actors
of their own.  ``stats()`` then carries ``topology`` and ``disagg``.  Two
client surfaces:

* blocking HTTP: ``POST {"prompts": [[ids...], ...], "max_new_tokens": n,
  "priority": "interactive"}`` → ``{"results": [{"request_id": ...,
  "tokens": [...]}, ...]}`` — every prompt is submitted up front so they
  share decode steps, then joined.
* streaming over HTTP (action payloads): ``POST {"action": "submit",
  "prompt": [ids...], "priority": ...}`` → ``{"request_id": rid}``
  immediately, then ``POST {"action": "poll", "request_id": rid, "cursor":
  c}`` → ``{"tokens": <new since cursor>, "done": bool}``.  Polls must land
  on the replica that took the submit — the proxy round-trips the replica
  tag in the ``x-tpu-air-replica`` header and pins polls to it.  The same
  submit/poll pair is also callable over actor RPC
  (``handle.method("submit")(...)``).

Backpressure: a full admission queue raises
:class:`~tpu_air_torch.engine.EngineOverloadedError` inside the replica; a
DRAINING replica raises ``EngineDrainingError`` for new submits while
admitted streams keep polling.  Both cross the actor boundary as
``RemoteError`` and the proxy maps them to HTTP 503.

The LM replica also serves tenant LoRA adapters (``adapter_id`` on a POST
or a submit), the live-weight RPCs of :class:`~tpu_air_torch.serve.weights.
WeightsController` (``weights_swap``, ``weights_rollback``,
``weights_probe`` and the rest) and both halves of a preemption migration
(``migrate_out``, ``submit_migrated``).  A T5 replica answers those as a
JAX package's T5 replica does: its window engine takes no adapter, has no
weights to swap or roll back, and migration raises ``ValueError``.

When it builds its engine a replica attaches the lease it was placed on
(:func:`~tpu_air_torch.core.runtime.attach_chip_lease`): a revocation
notice, from the ``runtime.lease`` fault site or from ``borrow_return``
(how the batch lane hands a borrowed replica back), freezes the engine's
admission, and ``preempt_status`` tells the
:class:`~tpu_air_torch.serve.supervisor.PreemptionWatcher`, which migrates
the live streams or replays them from its journal.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

from .deployment import Deployment


class _EngineServer:
    """The engine itself is built LAZILY on the first request, not in
    ``__init__``: the runtime round-trips a replica instance through the
    (pickle-based) object store at actor creation, and a live engine holds a
    thread, locks and device tensors.  The constructor keeps only the
    picklable recipe (checkpoint + config)."""

    def __init__(
        self,
        checkpoint,
        engine_config=None,
        *,
        dtype: Optional[str] = None,
        device: Optional[str] = None,
        engine_name: str = "engine",
        join_timeout: float = 300.0,
        mesh: Optional[tuple] = None,
        disagg: Optional[Dict[str, Any]] = None,
    ):
        self._checkpoint = checkpoint
        self._engine_config = engine_config
        self._dtype = dtype
        self._device = device
        self._engine_name = engine_name
        self._join_timeout = join_timeout
        # distributed serving (engine/dist): mesh=(dp, tp) builds a
        # MeshEngine, disagg= (DisaggRouter keyword arguments) routes
        # prefill through worker actors; the two compose
        self._mesh = tuple(mesh) if mesh is not None else None
        self._disagg = dict(disagg) if disagg is not None else None
        self._engine = None
        self._router = None
        self._streams: Dict[int, Any] = {}
        # recently retired streams' full token lists: a poll AFTER the one
        # that delivered `done` still answers (insertion-ordered, bounded)
        self._finished: Dict[int, Any] = {}
        self._draining = False
        self._lease = None
        self._preempt_notice_s: Optional[float] = None
        self._preempt_at: Optional[float] = None

    def _ensure_engine(self):
        if self._engine is None:
            from tpu_air_torch.engine import (EngineConfig, InferenceEngine, T5Engine,
                                              T5EngineConfig)

            model = self._checkpoint.get_model(dtype=self._dtype, device=self._device)
            # the config type picks the engine family: a T5EngineConfig gets
            # the window engine, any EngineConfig (or None) the causal-LM
            # slot/page engine
            if isinstance(self._engine_config, T5EngineConfig):
                if self._mesh or self._disagg:
                    raise ValueError(
                        "mesh/disagg serving supports the causal-LM paged "
                        "engine only")
                self._engine = T5Engine(model, self._engine_config, name=self._engine_name)
            elif self._mesh is not None:
                from tpu_air_torch.engine import MeshEngine

                dp, tp = self._mesh
                self._engine = MeshEngine(
                    model, self._engine_config or EngineConfig(), dp=dp, tp=tp,
                    devices=None if self._device is None else [self._device] * (dp * tp),
                    name=self._engine_name)
            else:
                self._engine = InferenceEngine(model, self._engine_config or EngineConfig(),
                                               name=self._engine_name)
            if self._disagg is not None:
                from tpu_air_torch.engine import DisaggRouter

                self._router = DisaggRouter(
                    self._checkpoint, self._engine_config or EngineConfig(),
                    engine=self._engine, dtype=self._dtype, device=self._device,
                    name=self._engine_name, **self._disagg)
            # attach the lease this actor was placed on: a revocation notice
            # freezes admission at once, and the supervisor's watcher sees
            # it through preempt_status and migrates or replays from the
            # driver's side
            from tpu_air_torch.core.runtime import attach_chip_lease

            self._lease = attach_chip_lease()
            self._lease.on_revoke(self._on_preempt)
        return self._engine

    def _on_preempt(self, notice_s: float) -> None:
        """Lease-revocation callback (the revoker's thread): stamp the
        notice and freeze engine admission.  The queued backlog stays
        queued: the notice window belongs to LIVE slots."""
        self._preempt_notice_s = float(notice_s)
        self._preempt_at = time.monotonic()
        engine = self._engine
        if engine is not None and hasattr(engine, "preempt"):
            engine.preempt()

    def _front(self):
        """The submit surface: the disagg router when configured (prefill
        on worker actors), else the engine itself."""
        self._ensure_engine()
        return self._router if self._router is not None else self._engine

    def close(self) -> None:
        """Stop the engine's thread and fail what it still holds, and stop
        the router's prefill workers (the replica's process ending stops
        them too)."""
        if self._router is not None:
            self._router.close()
        elif self._engine is not None:
            self._engine.close()

    # -- HTTP path (blocking generate + streaming actions) --------------------
    def __call__(self, payload) -> Dict[str, Any]:
        if not isinstance(payload, dict):
            raise ValueError(
                'expected JSON object {"prompts": [[ids...], ...]} '
                '(or {"prompt": [ids...]}, or {"action": "submit"/"poll"})'
            )
        action = payload.get("action")
        if action == "submit":
            return {"request_id": self.submit(
                payload.get("prompt") or [],
                payload.get("max_new_tokens"),
                priority=payload.get("priority", "interactive"),
                deadline_ms=payload.get("deadline_ms"),
                adapter_id=payload.get("adapter_id"),
                tenant=payload.get("tenant"),
            )}
        if action == "poll":
            return self.poll(int(payload.get("request_id", -1)),
                             int(payload.get("cursor", 0)))
        if action is not None:
            raise ValueError(f"unknown action {action!r}")
        if "prompt" in payload:
            prompts = [payload["prompt"]]
        else:
            prompts = payload.get("prompts")
        if not prompts:
            raise ValueError('payload needs "prompt" or a non-empty "prompts"')
        max_new = payload.get("max_new_tokens")
        priority = payload.get("priority", "interactive")
        front = self._front()
        kw = self._labels(front, payload.get("deadline_ms"), None)
        if payload.get("adapter_id") is not None:
            kw["adapter_id"] = str(payload["adapter_id"])
        # submit ALL before joining ANY — concurrent prompts share decode steps
        streams = [front.submit(p, max_new, priority=priority, **kw) for p in prompts]
        return {
            "results": [
                {"request_id": s.request_id,
                 "tokens": s.result(self._join_timeout)}
                for s in streams
            ]
        }

    # -- streaming path (HTTP actions above, or direct actor RPC) -------------
    def submit(self, prompt, max_new_tokens: Optional[int] = None, *,
               priority: str = "interactive",
               deadline_ms: Optional[float] = None,
               adapter_id: Optional[str] = None,
               tenant: Optional[str] = None) -> int:
        # the T5 window engine takes no deadline and no tenant label, as in
        # the JAX package (a deadline is honored proxy-side; the label only
        # relabels billing); the LM engine takes both.  An adapter changes
        # the tokens, so it goes to either engine, and the T5 engine's
        # submit refuses it (TypeError), as the JAX package's does
        front = self._front()
        kw = self._labels(front, deadline_ms, tenant)
        if adapter_id is not None:
            if self._router is not None:
                from tpu_air_torch.engine import RequestValidationError

                raise RequestValidationError(
                    "adapter_id is not supported with disaggregated "
                    "serving (prefill workers hold no adapter bank)")
            kw["adapter_id"] = str(adapter_id)
        stream = front.submit(prompt, max_new_tokens, priority=priority, **kw)
        self._streams[stream.request_id] = stream
        return stream.request_id

    @staticmethod
    def _labels(front, deadline_ms, tenant) -> Dict[str, Any]:
        """The deadline and tenant label, for the LM engine, which takes
        both; the disagg router takes the deadline only (dropping the label
        degrades billing, never a submit), the T5 window engine neither."""
        from tpu_air_torch.engine import DisaggRouter, InferenceEngine

        if not isinstance(front, (InferenceEngine, DisaggRouter)):
            return {}
        kw: Dict[str, Any] = {}
        if deadline_ms is not None:
            kw["deadline_ms"] = float(deadline_ms)
        if tenant is not None and isinstance(front, InferenceEngine):
            kw["tenant"] = str(tenant)
        return kw

    def poll(self, request_id: int, cursor: int = 0) -> Dict[str, Any]:
        stream = self._streams.get(request_id)
        if stream is None:
            toks = self._finished.get(request_id)
            if toks is None:
                raise KeyError(f"unknown request_id {request_id}")
            if isinstance(toks, BaseException):
                raise toks  # failed-stream tombstone: every re-poll re-raises
            return {"tokens": toks[cursor:], "done": True}
        # read `done` BEFORE the tokens: done observed first guarantees the
        # token list is complete
        done = stream.done
        toks = stream.tokens_so_far()
        if done:
            self._streams.pop(request_id, None)
            err = getattr(stream, "_error", None)
            self._finished[request_id] = err if err is not None else toks
            while len(self._finished) > 512:
                self._finished.pop(next(iter(self._finished)))
            if err is not None:
                raise err
        return {"tokens": toks[cursor:], "done": done}

    # -- live weights (serve/weights.py WeightsController RPCs) ---------------
    def weights_swap(self, store_root: str, version: Optional[int] = None) -> float:
        """Load ``version`` (default: the latest) from the weight store,
        checksums checked, carry the JAX package's tree into the port's
        state dict (``params_from_jax``) and swap it into the serving
        engine between decode steps.  Returns the swap's stall in ms."""
        from tpu_air_torch.models.lm.convert import params_from_jax

        from .weights import WeightStore

        engine = self._ensure_engine()
        store = WeightStore(store_root)
        if version is None:
            version = store.latest_version()
        state = params_from_jax(store.load(version))
        return engine.swap_params(state, version=version)

    def weights_rollback(self) -> float:
        """Serve the pre-swap weights again (tensors the engine kept: no
        store reads)."""
        return self._ensure_engine().rollback_params()

    def weights_version(self) -> Optional[int]:
        if self._engine is None:
            return None
        return self._engine.weights_version()

    def weights_probe(self, prompts, max_new: int = 8, *,
                      adapter_id: Optional[str] = None, timeout_s: float = 60.0) -> list:
        """The canary probe prompts through THIS replica's engine (the whole
        admit, prefill and decode path, not an offline forward); their
        greedy token lists."""
        engine = self._ensure_engine()
        kw = {} if adapter_id is None else {"adapter_id": str(adapter_id)}
        streams = [engine.submit([int(t) for t in p], int(max_new), **kw) for p in prompts]
        return [s.result(float(timeout_s)) for s in streams]

    def weights_probe_logits(self, prompts) -> list:
        """Last-prompt-position logits under the SERVING weights (the
        surface of the logit-tolerance gate)."""
        from .weights import probe_logits

        return probe_logits(self._ensure_engine().model, prompts)

    def weights_load_adapter(self, name: str, a, b) -> int:
        return self._ensure_engine().load_adapter(name, a, b)

    def weights_unload_adapter(self, name: str) -> bool:
        return self._ensure_engine().unload_adapter(name)

    def weights_adapters(self) -> Dict[str, int]:
        if self._engine is None:
            return {}
        return self._engine.adapters()

    # -- preemption migration (serve/supervisor.py PreemptionWatcher RPCs) ----
    def migrate_out(self) -> list:
        """Freeze this replica's engine and pull every decoding slot into a
        payload (prompt, streamed tokens, KV pages).  The abandoned source
        streams stay in ``_streams``: a poll racing the migration keeps
        getting a correct prefix until the supervisor re-pins its journal
        entry at the destination."""
        engine = self._ensure_engine()
        if not hasattr(engine, "migrate_out"):
            raise ValueError("migrate_out needs the paged causal-LM engine "
                             f"(this replica serves {type(engine).__name__})")
        return engine.migrate_out()

    def submit_migrated(self, payload: Dict[str, Any]) -> int:
        """Land one migrated stream on THIS replica.  Raises synchronously
        (``KVTransferError``, ``RequestValidationError``, crossing as
        ``RemoteError``) when the payload cannot be admitted cleanly, so the
        supervisor falls back to journal replay."""
        engine = self._ensure_engine()
        if not hasattr(engine, "submit_migrated"):
            raise ValueError("submit_migrated needs the paged causal-LM engine "
                             f"(this replica serves {type(engine).__name__})")
        stream = engine.submit_migrated(payload)
        self._streams[stream.request_id] = stream
        return stream.request_id

    def borrow_return(self, notice_s: float = 5.0) -> bool:
        """Elastic borrowing (tpu_air_torch/batch): hand this replica's
        device back THROUGH the preemption path by delivering a revocation
        notice to its own lease, which freezes admission and lets the
        driver-side watcher drain or migrate live slots exactly as a real
        preemption would.  Returns False when there is no lease to revoke
        (the engine was never built: nothing to return)."""
        if self._lease is None:
            return False
        self._lease.deliver_notice(float(notice_s))
        return True

    # -- draining (zero-downtime rollout / scale-down) ------------------------
    def drain(self) -> None:
        """Stop admitting new work; admitted streams retire and stay
        pollable.  Never forces the lazy engine build — a replica that
        served nothing drains instantly."""
        self._draining = True
        front = self._router if self._router is not None else self._engine
        if front is not None:
            front.drain()

    def drain_status(self) -> Dict[str, Any]:
        """``drained`` means: drain was requested, the engine retired all
        admitted work, and every finished stream was polled to its end."""
        pending = len(self._streams)
        engine_done = (self._engine is None
                       or (self._engine.drained() if self._draining else False))
        return {
            "draining": self._draining,
            "pending_streams": pending,
            "drained": bool(self._draining and engine_done and pending == 0),
        }

    def preempt_status(self) -> Dict[str, Any]:
        """Cheap poll surface for the driver-side watcher.  Never forces
        the lazy engine build; ``notice_left_s`` is how much of the
        revocation window remains (the watcher's migrate-vs-replay
        input)."""
        if self._preempt_notice_s is None:
            return {"preempting": False}
        left = self._preempt_notice_s - (time.monotonic() - self._preempt_at)
        return {
            "preempting": True,
            "notice_s": self._preempt_notice_s,
            "notice_left_s": max(0.0, left),
        }

    def stats(self) -> Dict[str, Any]:
        """The engine's metrics snapshot, its device and this process's
        launches of the two inference kernels, with the router's
        ``topology`` keys and ``disagg`` counts when it routes; ``{}``
        before the engine is built (a scrape never forces the build)."""
        if self._engine is None:
            return {}
        from tpu_air_torch.ops.decode_attention import decode_attention
        from tpu_air_torch.ops.flash_attention import flash_attention

        snap = self._engine.metrics.snapshot()
        snap["device"] = str(self._engine.device)
        snap["kernel_launches"] = {"flash_attention": flash_attention.launches,
                                   "decode_attention": decode_attention.launches}
        if self._router is not None:
            rst = self._router.stats()
            snap.setdefault("topology", {}).update(
                disagg="on",
                prefill_replicas=rst["prefill_replicas"],
                live_prefill_replicas=rst["live_prefill_replicas"],
            )
            snap["disagg"] = {k: rst[k] for k in
                              ("handoffs", "reroutes", "fallbacks", "retries", "breakers")}
        return snap


EngineDeployment = Deployment(
    func_or_class=_EngineServer,
    name="EngineDeployment",
    num_replicas=1,
)
