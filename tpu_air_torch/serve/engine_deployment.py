"""EngineDeployment — serve the T5 window engine over HTTP, the counterpart
of ``tpu_air/serve/engine_deployment.py``.

Each replica actor owns one :class:`tpu_air_torch.engine.T5Engine` built
from a Checkpoint on the replica's device: ``cuda:<first leased id>`` when
the deployment leases the card (``num_chips=1``), else what ``device=``
names.  Two client surfaces:

* blocking HTTP: ``POST {"prompts": [[ids...], ...], "max_new_tokens": n,
  "priority": "interactive"}`` → ``{"results": [{"request_id": ...,
  "tokens": [...]}, ...]}`` — every prompt is submitted up front so they
  share windows, then joined.
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

What the port refuses, each with ``NotImplementedError`` naming its ROADMAP
Queue 1 item: an ``EngineConfig`` (the causal-LM slot engine), ``adapter_id``,
the live-weight RPCs and ``migrate_out`` / ``submit_migrated`` (item 6b);
``mesh=`` and ``disagg=`` (items 6b and 9); the borrow return over a
revocable lease (item 11).  The replica attaches no revocable lease, so
``preempt_status`` reports no notice, as a JAX replica does whose lease was
never revoked.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from .deployment import Deployment

_ITEM_6B = "ROADMAP Queue 1 item 6b"


def _refuse(what: str, item: str = _ITEM_6B) -> None:
    raise NotImplementedError(f"{what} is not ported to tpu_air_torch ({item})")


class _EngineServer:
    """The engine itself is built LAZILY on the first request, not in
    ``__init__``: the runtime round-trips a replica instance through the
    (pickle-based) object store at actor creation, and a live engine holds a
    thread, locks and device tensors.  The constructor keeps only the
    picklable recipe (checkpoint + config), and refuses what the port has
    not ported before any replica serves."""

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
        from tpu_air_torch.engine import T5EngineConfig

        if mesh is not None or disagg is not None:
            _refuse("mesh= and disagg= serving (MeshEngine, DisaggRouter)",
                    "ROADMAP Queue 1 items 6b and 9")
        if not isinstance(engine_config, T5EngineConfig):
            _refuse(f"the causal-LM slot engine (engine_config "
                    f"{type(engine_config).__name__}; pass a T5EngineConfig)")
        self._checkpoint = checkpoint
        self._engine_config = engine_config
        self._dtype = dtype
        self._device = device
        self._engine_name = engine_name
        self._join_timeout = join_timeout
        self._engine = None
        self._streams: Dict[int, Any] = {}
        # recently retired streams' full token lists: a poll AFTER the one
        # that delivered `done` still answers (insertion-ordered, bounded)
        self._finished: Dict[int, Any] = {}
        self._draining = False

    def _ensure_engine(self):
        if self._engine is None:
            from tpu_air_torch.engine import T5Engine

            model = self._checkpoint.get_model(dtype=self._dtype, device=self._device)
            self._engine = T5Engine(model, self._engine_config, name=self._engine_name)
        return self._engine

    def close(self) -> None:
        """Stop the engine's thread and fail what it still holds (the
        replica's process ending stops it too)."""
        if self._engine is not None:
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
        if payload.get("adapter_id") is not None:
            _refuse("adapter_id (the LoRA head-delta banks)")
        max_new = payload.get("max_new_tokens")
        priority = payload.get("priority", "interactive")
        engine = self._ensure_engine()
        # submit ALL before joining ANY — concurrent prompts share windows
        streams = [engine.submit(p, max_new, priority=priority) for p in prompts]
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
        # relabels billing); an adapter would change the tokens, so it is
        # refused rather than dropped
        if adapter_id is not None:
            _refuse("adapter_id (the LoRA head-delta banks)")
        stream = self._ensure_engine().submit(prompt, max_new_tokens, priority=priority)
        self._streams[stream.request_id] = stream
        return stream.request_id

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

    # -- what the port refuses ------------------------------------------------
    def weights_swap(self, store_root: str, version: Optional[int] = None) -> float:
        _refuse("live weight swaps (serve/weights.py, swap_params)")

    def weights_rollback(self) -> float:
        _refuse("live weight rollback (serve/weights.py, rollback_params)")

    def weights_probe(self, prompts, max_new: int = 8, **_: Any) -> list:
        _refuse("the live-weight canary probe (serve/weights.py)")

    def migrate_out(self) -> list:
        _refuse("migrate_out (preemption migration of paged KV)")

    def submit_migrated(self, payload: Dict[str, Any]) -> int:
        _refuse("submit_migrated (preemption migration of paged KV)")

    def borrow_return(self, notice_s: float = 5.0) -> bool:
        _refuse("borrow_return over a revocable chip lease (attach_chip_lease)",
                "ROADMAP Queue 1 item 11")

    # -- draining (zero-downtime rollout / scale-down) ------------------------
    def drain(self) -> None:
        """Stop admitting new work; admitted streams retire and stay
        pollable.  Never forces the lazy engine build — a replica that
        served nothing drains instantly."""
        self._draining = True
        if self._engine is not None:
            self._engine.drain()

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
        """The watcher's poll surface: no revocable lease is attached
        (ROADMAP Queue 1 item 11), so no notice ever arrives."""
        return {"preempting": False}

    def stats(self) -> Dict[str, Any]:
        """The engine's metrics snapshot, its device and this process's
        launches of the two inference kernels; ``{}`` before the engine is
        built (a scrape never forces the build)."""
        if self._engine is None:
            return {}
        from tpu_air_torch.ops.decode_attention import decode_attention
        from tpu_air_torch.ops.flash_attention import flash_attention

        snap = self._engine.metrics.snapshot()
        snap["device"] = str(self._engine.device)
        snap["kernel_launches"] = {"flash_attention": flash_attention.launches,
                                   "decode_attention": decode_attention.launches}
        return snap


EngineDeployment = Deployment(
    func_or_class=_EngineServer,
    name="EngineDeployment",
    num_replicas=1,
)
