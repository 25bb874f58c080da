"""Autoregressive generation for the causal LM, the counterpart of
``tpu_air/models/lm/generate.py``.

PyTorch runs eagerly, so the JAX package's ``lax.scan`` / ``while_loop``
becomes a Python loop over single-token steps, and its ``eval_shape`` cache
init becomes :func:`init_cache`, which allocates zeroed flat slabs.  As
there:

* the cache is right-sized to ``L_prompt + max_new_tokens``, so each step
  attends over the prompt and what it generated, not ``max_seq_len``;
* prefill applies the head to the last position only (``return_hidden``
  and :func:`head_weight`): the ``(B, L, V)`` prompt logits never exist;
* the prefill emits token 0, and the loop computes the other
  ``max_new_tokens - 1``.

Greedy tokens equal the JAX package's.  Sampled tokens cannot: the port
draws from a ``torch.Generator``, whose stream is not JAX's.  The port has
no compile cache, so the JAX wrapper's cache of compiled functions and its
power-of-two batch padding are left out: neither changes greedy tokens.

The engines' entry points follow: slab (``init_slot_cache``,
``make_lm_prefill_fn``, ``make_lm_decode_step_fn``) and paged
(``init_paged_cache``, ``make_lm_paged_decode_step_fn``,
``make_lm_prefill_chunk_fn``, ``page_copy``).  Where the JAX package donates
the cache and returns a new one, these write the cache's tensors in place
and return the same list.  Each enters ``torch.inference_mode()`` itself
(grad mode is per thread, and the engine steps in a thread of its own) and
makes its tensors on the model's device.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np
import torch

from tpu_air_torch.models.sampling import sample_token

from .modeling import AttnCache, CausalLM, head_weight, torch_dtype

def _slabs(model: CausalLM, rows: int, length: int):
    cfg = model.config
    shape = (rows, length, cfg.n_heads * cfg.head_dim)
    dt, dev = torch_dtype(cfg.dtype), model.device
    return torch.zeros(shape, dtype=dt, device=dev), torch.zeros(shape, dtype=dt, device=dev)


def init_cache(model: CausalLM, batch_size: int,
               cache_len: Optional[int] = None) -> List[AttnCache]:
    """Zeroed flat slabs ``[batch_size, cache_len, h*d]`` in the model's type
    on its device, one :class:`AttnCache` per layer, index 0.  ``cache_len``
    defaults to ``config.max_seq_len``."""
    length = model.config.max_seq_len if cache_len is None else cache_len
    return [AttnCache(*_slabs(model, batch_size, length), 0)
            for _ in range(model.config.n_layers)]


def _as_ids(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.long)
    return torch.as_tensor(np.asarray(x), dtype=torch.long, device=device)


def _head(model: CausalLM) -> torch.Tensor:
    """The f32 (d_model, vocab) head, made once per generate call or step
    function (the model's weights may be in a half type).  It is a copy of
    a half-type head and a view of an f32 one, so after the model's weights
    change the step functions that hold it are made anew
    (``InferenceEngine.swap_params`` does)."""
    return head_weight(model).float()


def make_lm_generate_fn(model: CausalLM, max_new_tokens: int,
                        do_sample: bool = False, temperature: float = 1.0,
                        top_k: int = 0, eos_token_id: Optional[int] = None,
                        early_stop: bool = True) -> Callable:
    """``fn(input_ids, generator=None, live_mask=None) -> (B, max_new_tokens)``
    int64 on the model's device.

    ``input_ids``: (B, L_prompt) un-padded prompts.  After ``eos_token_id``
    a row emits pad.  ``live_mask`` (B,) bool marks real rows; False rows
    are filler the caller appended, born finished (they emit pad and never
    hold the loop open).  ``early_stop`` (with ``eos_token_id``) ends the
    loop once every row has emitted EOS, one host sync a step; the outputs
    are those of the full budget.  Without ``eos_token_id`` the loop runs
    the whole budget and never syncs."""
    cfg = model.config
    pad = cfg.pad_token_id

    def generate(input_ids, generator: Optional[torch.Generator] = None,
                 live_mask=None) -> torch.Tensor:
        dev = model.device
        ids = _as_ids(input_ids, dev)
        b, lp = ids.shape
        total = lp + max_new_tokens
        if total > cfg.max_seq_len:
            raise ValueError(f"prompt {lp} + max_new_tokens {max_new_tokens} exceeds "
                             f"max_seq_len {cfg.max_seq_len}")
        with torch.inference_mode():
            cache = init_cache(model, b, total)
            positions = torch.arange(lp, device=dev).expand(b, lp)
            hidden = model(ids, positions, return_hidden=True, decode=True, cache=cache)
            head_w = _head(model)
            tok = sample_token(hidden[:, -1].float() @ head_w, generator, do_sample,
                               temperature, top_k)
            done = None
            if eos_token_id is not None:
                filler = (torch.zeros(b, dtype=torch.bool, device=dev) if live_mask is None
                          else ~torch.as_tensor(np.asarray(live_mask), dtype=torch.bool,
                                                device=dev))
                tok = torch.where(filler, torch.full_like(tok, pad), tok)
                done = filler | (tok == eos_token_id)
            toks = torch.full((b, max_new_tokens), pad, dtype=torch.long, device=dev)
            toks[:, 0] = tok
            for step in range(1, max_new_tokens):
                # airlint: disable=PT004 — early stop, as the reference's while_loop condition
                if early_stop and done is not None and bool(done.all()):
                    break
                pos = torch.full((b, 1), lp + step - 1, dtype=torch.long, device=dev)
                hidden = model(tok[:, None], pos, return_hidden=True, decode=True,
                               cache=cache)
                nxt = sample_token(hidden[:, -1].float() @ head_w, generator, do_sample,
                                   temperature, top_k)
                if done is not None:
                    nxt = torch.where(done, torch.full_like(nxt, pad), nxt)
                    done = done | (nxt == eos_token_id)
                toks[:, step] = nxt
                tok = nxt
            return toks

    return generate


def generate(model: CausalLM, input_ids, max_new_tokens: int = 64,
             do_sample: bool = False, temperature: float = 1.0, top_k: int = 0,
             eos_token_id: Optional[int] = None,
             generator: Optional[torch.Generator] = None,
             early_stop: bool = True) -> torch.Tensor:
    """Generate ``max_new_tokens`` per row of un-padded, equal-length prompts
    ``input_ids`` (numpy or torch) on the model's device; returns int64
    ``(n, max_new_tokens)`` there."""
    return make_lm_generate_fn(model, max_new_tokens, do_sample, temperature, top_k,
                               eos_token_id, early_stop)(input_ids, generator)


# -- the slab engine's entry points ---------------------------------------------
#
# ``generate`` keeps the prefill and the per-token step inside one call; an
# engine that admits and retires between steps needs them apart.  The slab
# layout is per-layer flat slabs [S, slot_len, h*d] with a PER-ROW index:
# each slot sits at its own position.  The factories keep the JAX
# signatures' ``slot_len``; the cache carries its own length.


def init_slot_cache(model: CausalLM, num_slots: int, slot_len: int) -> List[AttnCache]:
    """Zeroed slab pool: ``num_slots`` rows of ``slot_len`` positions in every
    layer, with a per-slot index ``[S]``; the cache a slab engine carries
    over its whole life."""
    dev = model.device
    return [AttnCache(*_slabs(model, num_slots, slot_len),
                      torch.zeros(num_slots, dtype=torch.long, device=dev))
            for _ in range(model.config.n_layers)]


def make_lm_prefill_fn(model: CausalLM, prompt_len: int) -> Callable:
    """``fn(input_ids, last_index) -> (tok, segment)``: one cached pass over
    prompts right-padded to ``prompt_len`` (``(B, prompt_len)`` int64 on the
    model's device) giving each row's greedy first token, read at
    ``last_index`` ``(B,)`` (its last real token: the causal mask keeps the
    padding out of earlier positions, so a bucketed prefill gives the tokens
    of an exact-length one), and the prompt's K/V segment, per-layer
    ``[B, prompt_len, h*d]``, for :func:`make_insert_fn`."""

    def prefill(input_ids: torch.Tensor, last_index: torch.Tensor):
        with torch.inference_mode():
            b, lp = input_ids.shape
            cache = init_cache(model, b, lp)
            positions = torch.arange(lp, device=input_ids.device).expand(b, lp)
            hidden = model(input_ids, positions, return_hidden=True, decode=True, cache=cache)
            rows = torch.arange(b, device=input_ids.device)
            h_last = hidden[rows, last_index.long()].float()
            return torch.argmax(h_last @ _head(model), dim=-1), cache

    return prefill


def make_lm_decode_step_fn(model: CausalLM, slot_len: int) -> Callable:
    """THE slab engine step: ``fn(cache, tok, pos) -> (cache, next_tok)``
    over the fixed slot pool.  ``tok`` / ``pos`` ``(S,)`` int64 on the
    model's device: each slot's current token and cache position.  Every
    slot steps every call (free slots ride along at position 0; the engine
    drops their outputs).  Greedy: the engine's anchor is token equality
    with offline greedy ``generate``."""
    head_w = _head(model)

    def step(cache: List[AttnCache], tok: torch.Tensor, pos: torch.Tensor):
        with torch.inference_mode():
            for c in cache:
                c.cache_index = pos
            hidden = model(tok[:, None], pos[:, None], return_hidden=True, decode=True,
                           cache=cache)
            return cache, torch.argmax(hidden[:, -1].float() @ head_w, dim=-1)

    return step


# -- the paged engine's entry points --------------------------------------------
#
# Per-layer page pools [num_pages, page_len, h*d] shared by all slots, and a
# block table [S, pages_per_slot] mapping each slot's positions onto pages.
# The table and the per-slot indices are host state (engine/kvpool/pool.py),
# set into the cache at every call.  Prefill runs in page-sized chunks.


def init_paged_cache(model: CausalLM, num_slots: int, num_pages: int, page_len: int,
                     pages_per_slot: int) -> List[AttnCache]:
    """Zeroed page pools ``[num_pages, page_len, h*d]`` per layer (page 0 is
    the pinned null page), a per-slot index ``[S]`` and a block table
    ``[S, pages_per_slot]`` of page ids (0: unreached)."""
    dev = model.device
    return [AttnCache(*_slabs(model, num_pages, page_len),
                      torch.zeros(num_slots, dtype=torch.long, device=dev),
                      torch.zeros((num_slots, pages_per_slot), dtype=torch.long, device=dev))
            for _ in range(model.config.n_layers)]


def make_lm_paged_decode_step_fn(model: CausalLM, slot_len: int,
                                 adapters: bool = False) -> Callable:
    """The paged engine step: ``fn(cache, tok, pos, block_table) -> (cache,
    next_tok)``, the contract of :func:`make_lm_decode_step_fn` plus the
    table ``[S, pages_per_slot]`` (the host pool's, with the rows of slots
    that are not decoding pointed at the null page).

    ``adapters=True`` appends the multi-tenant LoRA banks: ``fn(cache, tok,
    pos, block_table, bank_a, bank_b, adapter_ids)`` with f32 ``bank_a``
    ``[A+1, d_model, r]``, ``bank_b`` ``[A+1, r, vocab]`` and ``adapter_ids``
    ``[S]`` int64, all on the model's device; each row's f32 logits gain
    ``(h @ bank_a[id]) @ bank_b[id]``, gathered the way the table gathers
    pages.  Bank row 0 is the zero adapter, so a row with id 0 gains an
    exact zero and its token is the base model's."""
    head_w = _head(model)

    def step(cache: List[AttnCache], tok: torch.Tensor, pos: torch.Tensor,
             block_table: torch.Tensor, bank_a: Optional[torch.Tensor] = None,
             bank_b: Optional[torch.Tensor] = None,
             adapter_ids: Optional[torch.Tensor] = None):
        with torch.inference_mode():
            for c in cache:
                c.cache_index, c.block_table = pos, block_table
            hidden = model(tok[:, None], pos[:, None], return_hidden=True, decode=True,
                           cache=cache)
            h = hidden[:, -1].float()
            logits = h @ head_w
            if adapters:
                a, b = bank_a[adapter_ids], bank_b[adapter_ids]    # [S, d, r], [S, r, V]
                logits = logits + torch.einsum("sr,srv->sv",
                                               torch.einsum("sd,sdr->sr", h, a), b)
            return cache, torch.argmax(logits, dim=-1)

    return step


def make_lm_prefill_chunk_fn(model: CausalLM, page_len: int, slot_len: int,
                             adapters: bool = False) -> Callable:
    """``fn(cache, ids, p0, last_local, table_row) -> (cache, tok)``: ONE
    page-sized chunk of ONE slot's prompt.

    * ``ids`` ``[1, page_len]`` int64: the chunk's tokens, right-padded on
      the final chunk; the padding writes don't-care K/V into the page's
      tail, which the validity mask hides until decode overwrites it;
    * ``p0``: the chunk's first position (page-aligned), an int;
    * ``last_local``: the prompt's last real token within the chunk (used
      on the final chunk: the greedy first token is read there);
    * ``table_row`` ``[pages_per_slot]``: the slot's table row (the pool
      may point a fully covered prompt's re-run chunk at the null page).

    ``adapters=True`` appends ``bank_a``, ``bank_b`` (as in
    :func:`make_lm_paged_decode_step_fn`) and one int ``adapter_id`` (a
    chunk is one slot's work): the first token gets the same head delta,
    so a tenant's stream is the adapter's from its first token."""
    head_w = _head(model)

    def prefill_chunk(cache: List[AttnCache], ids: torch.Tensor, p0: int, last_local: int,
                      table_row: torch.Tensor, bank_a: Optional[torch.Tensor] = None,
                      bank_b: Optional[torch.Tensor] = None, adapter_id: int = 0):
        with torch.inference_mode():
            dev = ids.device
            index = torch.full((1,), p0, dtype=torch.long, device=dev)
            for c in cache:           # b = 1: the chunk's slot is row 0
                c.cache_index, c.block_table = index, table_row[None]
            positions = (p0 + torch.arange(page_len, device=dev))[None]
            hidden = model(ids, positions, return_hidden=True, decode=True, cache=cache)
            h_last = hidden[0, last_local].float()
            logits = h_last @ head_w
            if adapters:
                logits = logits + (h_last @ bank_a[adapter_id]) @ bank_b[adapter_id]
            return cache, torch.argmax(logits)

    return prefill_chunk


def page_copy(cache: List[AttnCache], dst: int, src: int) -> List[AttnCache]:
    """Copy-on-write: page ``src`` onto page ``dst`` in every layer's K and V
    pools, in place.  Run once, when a slot's first decode append would land
    in a prefix-shared tail page (``PagedKVPool.resolve_cow``)."""
    with torch.inference_mode():
        for c in cache:
            c.cached_key[dst].copy_(c.cached_key[src])
            c.cached_value[dst].copy_(c.cached_value[src])
    return cache
