"""Windowed continuous decoding for the T5 family, the counterpart of
``tpu_air/engine/t5_engine.py`` on torch tensors on the model's device.

The T5 engine entry points (``models/t5/generate.py``:
``make_t5_prefill_fn`` / ``make_t5_decode_step_fn``) are BATCH-
SYNCHRONIZED: the decode cache carries one position and the whole batch's
cross-attention K/V, so rows cannot sit at different decode positions.
:class:`T5Engine` is therefore a WINDOW engine:

* requests queue through the :class:`~tpu_air_torch.engine.scheduler.
  Scheduler` (backpressure, FIFO) and stream back per token on a
  :class:`~tpu_air_torch.engine.types.ResponseStream`;
* a *window* is one prefill (encode + cache build + first token) over up
  to ``max_batch`` queued requests padded to a fixed shape, followed by
  per-token decode steps — tokens stream out as they are decoded, rows
  retire individually on EOS (inclusive) or budget;
* admission happens only at window boundaries: a window drains fully
  before the next batch starts.  Early-retired rows ride along until the
  window closes.

A window is always ``max_batch`` rows by ``max_input_len`` tokens (all-pad
filler rows), so a row's tokens do not depend on which requests share its
window, and the streams are token-identical to greedy decoding with the
two entry points over the same window batch.  The engine does not call
``generate``, which pads a batch to a power of two.

Every tensor the engine's thread makes names the model's device (the
current CUDA device is per thread), and each step makes one host sync: the
step's tokens come to the host once, then the rows are walked there.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from tpu_air_torch.models.t5.generate import make_t5_decode_step_fn, make_t5_prefill_fn

from .metrics import EngineMetrics, unregister
from .scheduler import Scheduler
from .types import (
    PRIORITIES,
    EngineClosedError,
    EngineDrainingError,
    EngineOverloadedError,
    Request,
    ResponseStream,
)


@dataclass
class T5EngineConfig:
    """Dials for the T5 window engine.

    * ``max_batch`` — rows per window (the fixed prefill/decode batch
      shape; short windows pad with dead all-pad rows).
    * ``max_input_len`` — encoder-side prompt cap; prompts right-pad to
      this fixed length.
    * ``max_new_tokens`` — decode budget cap per request (the cache is
      sized to it).
    * ``max_queue`` — queued request cap; beyond it ``submit`` raises
      :class:`EngineOverloadedError`.
    * ``queue_shares`` — per-priority-class fraction of ``max_queue`` at
      which submits shed, same contract as
      :class:`~tpu_air_torch.engine.types.EngineConfig.queue_shares`.
    """

    max_batch: int = 4
    max_input_len: int = 64
    max_new_tokens: int = 32
    max_queue: int = 256
    reorder_window: int = 0  # window admission is FIFO; kept for Scheduler
    queue_shares: Optional[dict] = None

    def queue_cap(self, priority: str) -> int:
        """Total queue depth at which ``priority``-class submits shed
        (shares mirror EngineConfig's defaults)."""
        shares = self.queue_shares or {
            "interactive": 1.0, "batch": 0.85, "best_effort": 0.5,
        }
        return int(self.max_queue * float(shares.get(priority, 1.0)))


class _Window:
    """One in-flight batch: the device cache, the device tokens to feed
    next, and per-row host bookkeeping."""

    def __init__(self, requests: List[Optional[Request]], cache, tok: torch.Tensor):
        self.requests = requests
        self.cache = cache
        # fed straight back as the next step's input: a retired or filler
        # row's token is never read, and rows do not see each other
        self.tok = tok
        self.budget_left = np.zeros((len(requests),), np.int64)

    def live_rows(self):
        return [i for i, r in enumerate(self.requests) if r is not None]


class T5Engine:
    """Window-level continuous decoding over a T5 model (see module doc).
    The model holds its weights and sits on the device the engine runs on."""

    def __init__(self, model, config: Optional[T5EngineConfig] = None,
                 *, auto_start: bool = True, name: str = "t5-engine"):
        self.model = model
        self.device = model.device
        self.config = config or T5EngineConfig()
        self.name = name
        self.eos_token_id = model.config.eos_token_id
        self.pad_token_id = model.config.pad_token_id

        cfg = self.config
        self._prefill = make_t5_prefill_fn(model, cfg.max_new_tokens + 1)
        self._decode_step = make_t5_decode_step_fn(model)
        self._window: Optional[_Window] = None

        self.scheduler = Scheduler(cfg)
        self.metrics = EngineMetrics(name=name, num_slots=cfg.max_batch)

        self._next_request_id = 0
        self._id_lock = threading.Lock()
        self._step_lock = threading.Lock()
        self._closed = False
        self._draining = False
        self._thread: Optional[threading.Thread] = None
        if auto_start:
            self.start()

    # -- submission (any thread) ---------------------------------------------
    def submit(self, input_ids: Sequence[int],
               max_new_tokens: Optional[int] = None, *,
               priority: str = "interactive") -> ResponseStream:
        """Queue one encoder prompt; returns its token stream immediately.
        ``priority`` follows the same SLO-class contract as the causal-LM
        engine (admission is window-FIFO here, but shed thresholds and
        per-class gauges still apply)."""
        if self._closed:
            raise EngineClosedError("engine is shut down")
        if self._draining:
            raise EngineDrainingError(
                f"engine {self.name!r} is draining; submit elsewhere")
        if priority not in PRIORITIES:
            raise ValueError(
                f"unknown priority {priority!r} (expected one of {PRIORITIES})"
            )
        prompt = [int(t) for t in input_ids]
        if not prompt:
            raise ValueError("empty prompt")
        if len(prompt) > self.config.max_input_len:
            raise ValueError(
                f"prompt ({len(prompt)}) exceeds max_input_len "
                f"({self.config.max_input_len})"
            )
        budget = (self.config.max_new_tokens if max_new_tokens is None
                  else int(max_new_tokens))
        if not 1 <= budget <= self.config.max_new_tokens:
            raise ValueError(
                f"max_new_tokens must be in [1, "
                f"{self.config.max_new_tokens}], got {budget}"
            )
        with self._id_lock:
            rid = self._next_request_id
            self._next_request_id += 1
        stream = ResponseStream(rid)
        req = Request(request_id=rid, prompt=prompt, max_new_tokens=budget,
                      stream=stream, priority=priority)
        try:
            self.scheduler.submit(req)
        except EngineOverloadedError:
            self.metrics.record_reject(priority)
            raise
        self.metrics.record_submit(priority)
        return stream

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

    # -- the engine loop -----------------------------------------------------
    def step(self) -> bool:
        """One engine iteration: open a window if none is in flight (one
        prefill over the queued batch), else one decode step.  Returns True
        if any work happened."""
        with self._step_lock:
            worked = False
            if self._window is None:
                worked = self._open_window()
            else:
                self._decode_window()
                worked = True
            occ = len(self._window.live_rows()) if self._window else 0
            self.metrics.observe_gauges(
                self.scheduler.depth(), occ,
                queue_by_class=self.scheduler.depth_by_class(),
                draining=self._draining,
            )
            return worked

    def idle(self) -> bool:
        with self._step_lock:  # _window is step-loop state (see step())
            return self.scheduler.depth() == 0 and self._window is None

    # -- draining (same contract as the JAX package's engines) ---------------
    def drain(self) -> None:
        """Refuse new submits; queued + in-window work retires normally."""
        # airlint: disable=CC001 — monotonic GIL-atomic bool, flips
        # False→True once; a racing step() reads either value correctly
        self._draining = True

    @property
    def draining(self) -> bool:
        return self._draining

    def drained(self) -> bool:
        return self._draining and self.idle()

    def _open_window(self) -> bool:
        reqs = self.scheduler.pop_admissible(self.config.max_batch)
        if not reqs:
            return False
        cfg = self.config
        b, li = cfg.max_batch, cfg.max_input_len
        ids = np.full((b, li), self.pad_token_id, np.int64)
        mask = np.zeros((b, li), np.int64)
        for row, req in enumerate(reqs):
            ids[row, :len(req.prompt)] = req.prompt
            mask[row, :len(req.prompt)] = 1
        # rows past len(reqs) are dead filler: all-pad, zero mask — their
        # decode outputs are discarded host-side
        tok, cache, _enc = self._prefill(torch.from_numpy(ids).to(self.device),
                                         torch.from_numpy(mask).to(self.device))
        first_toks = tok.cpu().numpy()          # the window's one host sync
        rows: List[Optional[Request]] = list(reqs) + [None] * (b - len(reqs))
        win = _Window(rows, cache, tok)
        now = time.monotonic()
        emitted = 0
        for row, req in enumerate(reqs):
            first = int(first_toks[row])
            req.first_token_at = now
            self.metrics.record_ttft(now - req.submitted_at)
            req.stream._emit(first)
            emitted += 1
            win.budget_left[row] = req.max_new_tokens - 1
            if win.budget_left[row] == 0 or first == self.eos_token_id:
                self._retire(win, row)
        self.metrics.record_tokens(emitted)
        self._window = win if win.live_rows() else None
        return True

    def _decode_window(self) -> None:
        win = self._window
        t0 = time.monotonic()
        win.cache, win.tok = self._decode_step(win.cache, win.tok)
        nxt = win.tok.cpu().numpy()  # airlint: disable=PT004 — the step's one host sync
        dt = time.monotonic() - t0
        emitted = 0
        for row in win.live_rows():
            # airlint: disable=PT004 — nxt is host memory: the sync was above the loop
            token = int(nxt[row])
            req = win.requests[row]
            req.stream._emit(token)
            emitted += 1
            win.budget_left[row] -= 1
            if win.budget_left[row] == 0 or token == self.eos_token_id:
                self._retire(win, row)
        self.metrics.record_step(dt, emitted)
        if not win.live_rows():
            # window drained: drop its cache, admit the next batch on the
            # following step
            self._window = None

    def _retire(self, win: _Window, row: int) -> None:
        win.requests[row].stream._finish()
        win.requests[row] = None
        self.metrics.record_complete()

    # -- background loop / lifecycle -----------------------------------------
    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._loop, name=f"tpu-air-{self.name}", daemon=True
        )
        self._thread.start()

    def _loop(self) -> None:
        # airlint: disable=CC001 — GIL-atomic stop flag; close() sets it
        # then joins this thread, so a stale read costs one extra iteration
        while not self._closed:
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
            if self._window is not None:
                for row in self._window.live_rows():
                    self._window.requests[row].stream._finish(err)
                self._window = None
        unregister(self.name)

    def __enter__(self) -> "T5Engine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
