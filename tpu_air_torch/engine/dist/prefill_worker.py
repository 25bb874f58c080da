"""PrefillWorker — chunked prefill as an actor family of its own, the
counterpart of ``tpu_air/engine/dist/prefill_worker.py``.

Disaggregation splits the two phases of a request across replicas: prefill
is compute-bound (one big attention pass over the prompt), decode is
memory-bound (one token a step against a growing KV cache).  A
PrefillWorker runs only the first: it drives the page-granular chunk
function the engine uses (``make_lm_prefill_chunk_fn``) against a private
single-slot paged cache, keeps a prefix cache of its own so shared-prompt
arrivals skip recompute, and ships the finished pages and the first token
through the object store for a decode engine to land with
``InferenceEngine.submit_prefilled``.

The class is actor-shaped but not actor-bound: the constructor keeps only a
picklable recipe (checkpoint, shapes, device) and builds the model and its
cache at the first call, so ``tpu_air_torch.remote(PrefillWorker).remote(
...)`` round-trips the instance through the object store; a plain local
instance works too.  The model goes on ``device``; with none, on the card
:func:`~tpu_air_torch.device.resolve_device` names (``cuda:<first leased
id>`` in a leased actor, else ``cuda:0``), and without CUDA the first call
raises.  The tests pass ``device="cpu"``.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, Optional

from tpu_air_torch.faults import plan as _faults

from .kv_transfer import extract_kv_pages, payload_nbytes, payload_pages


class PrefillWorker:
    """One prefill replica: prompt ids in, ``{"kv": ObjectRef,
    "first_token", "prompt_len"}`` out."""

    def __init__(self, checkpoint, *, page_len: int = 16,
                 slot_len: int = 256, num_pages: Optional[int] = None,
                 dtype: Optional[str] = None, device: Optional[str] = None,
                 name: str = "prefill"):
        if slot_len % page_len != 0:
            raise ValueError("slot_len must be a multiple of page_len")
        self._checkpoint = checkpoint
        self.page_len = page_len
        self.slot_len = slot_len
        self.pages_per_slot = slot_len // page_len
        # headroom beyond one slot keeps evicted-prefix pages resident
        # across requests (the worker-side prefix cache's working set)
        self.num_pages = (num_pages if num_pages is not None
                          else 4 * self.pages_per_slot + 1)
        self._dtype = dtype
        self._device = device
        self.name = name
        self._built = False
        self._prefills = 0
        self._pages_shipped = 0
        self._bytes_shipped = 0

    # -- lazy device state (unpicklable) -------------------------------------
    def _ensure_built(self) -> None:
        if self._built:
            return
        from tpu_air_torch.engine.kvpool import PagedKVPool
        from tpu_air_torch.models.lm.generate import init_paged_cache, make_lm_prefill_chunk_fn

        self.model = self._checkpoint.get_model(dtype=self._dtype, device=self._device)
        self.pool = PagedKVPool(self.num_pages, self.page_len, 1, self.pages_per_slot)
        self.cache = init_paged_cache(self.model, 1, self.num_pages, self.page_len,
                                      self.pages_per_slot)
        self._chunk_fn = make_lm_prefill_chunk_fn(self.model, self.page_len, self.slot_len)
        self._built = True

    # -- the one rpc ----------------------------------------------------------
    def prefill(self, prompt, carrier: Optional[Dict[str, str]] = None) -> Dict[str, Any]:
        """Run the prompt's chunked prefill, ship the pages, return the
        handoff descriptor.  ``carrier`` continues the submitter's trace:
        this records as the ``engine.prefill`` span of the request's one
        trace, in THIS process."""
        import numpy as np
        import torch

        import tpu_air_torch
        from tpu_air_torch.observability.tracing import task_span

        if _faults.enabled():
            # "slow" sleeps past the router's prefill timeout (gray failure:
            # alive but useless); "kill" dies the involuntary way, no
            # cleanup, and the router sees the actor-death sentinel
            spec = _faults.perturb("prefill.worker", key=self.name)
            if spec is not None and spec.action == "kill":
                os._exit(1)
        self._ensure_built()
        prompt = [int(t) for t in prompt]
        n = len(prompt)
        if n == 0:
            raise ValueError("empty prompt")
        if n > self.slot_len:
            raise ValueError(f"prompt length {n} exceeds worker slot_len {self.slot_len}")
        with task_span("engine.prefill", carrier) as sp:
            t0 = time.monotonic()
            # budget 1: the worker never decodes; it needs the prompt's
            # pages and the greedy first token, nothing more
            plan = self.pool.admit(0, prompt, 1)
            C = self.page_len
            dev = self.model.device
            tok = None
            while not plan.done:
                p0 = plan.next_start
                ids = np.full((1, C), self.model.config.pad_token_id, np.int64)
                chunk = prompt[p0:p0 + C]
                ids[0, :len(chunk)] = chunk
                is_last = plan.chunks_done == len(plan.chunk_starts) - 1
                last_local = (n - 1 - p0) if is_last else (C - 1)
                row = self.pool.chunk_row(0, p0, plan.null_target)
                self.cache, tok = self._chunk_fn(
                    self.cache, torch.from_numpy(ids).to(dev), p0, last_local,
                    torch.from_numpy(np.asarray(row, np.int64)).to(dev))
                plan.chunks_done += 1
            first = int(tok)
            self.pool.register(0, prompt)
            page_ids = self.pool.prompt_page_ids(0, n)
            payload = extract_kv_pages(self.cache, page_ids)
            # release AFTER extraction: prefix-registered pages stay
            # resident (refcounted) for the next shared-prefix arrival
            self.pool.release(0)
            ref = tpu_air_torch.put(payload)
            nbytes = payload_nbytes(payload)
            self._prefills += 1
            self._pages_shipped += payload_pages(payload)
            self._bytes_shipped += nbytes
            if sp is not None and hasattr(sp, "attrs"):
                sp.attrs.update({
                    "prompt_len": n,
                    "pages": payload_pages(payload),
                    "kv_bytes": nbytes,
                    "chunks": len(plan.chunk_starts),
                    "worker": self.name,
                    "prefill_s": round(time.monotonic() - t0, 6),
                })
        return {"kv": ref, "first_token": first, "prompt_len": n}

    # -- observability ---------------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        """Counts, shapes and, once built, the prefix pool's stats and the
        device the model runs on."""
        out = {
            "name": self.name,
            "role": "prefill",
            "prefills": self._prefills,
            "pages_shipped": self._pages_shipped,
            "bytes_shipped": self._bytes_shipped,
            "page_len": self.page_len,
            "slot_len": self.slot_len,
        }
        if self._built:
            out["kvpool"] = self.pool.stats()
            out["device"] = str(self.model.device)
        return out

    def ping(self) -> str:
        return "ok"
