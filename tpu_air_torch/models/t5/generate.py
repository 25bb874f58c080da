"""Autoregressive generation over a pre-allocated decode cache, the
counterpart of ``tpu_air/models/t5/generate.py``.

PyTorch runs eagerly, so the JAX package's ``lax.while_loop`` becomes a
Python loop over single-token steps and its ``eval_shape`` cache graft
becomes :func:`init_cache`, which allocates zeroed self-attention slabs and
computes the cross-attention K/V once from the encoder output.  Greedy
decoding is the default; temperature / top-k sampling draws from an explicit
``torch.Generator``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from tpu_air_torch.models.sampling import sample_token

from .modeling import DecodeCache, LayerCache, T5ForConditionalGeneration, torch_dtype


def init_cache(model: T5ForConditionalGeneration, batch_size: int,
               max_decode_len: int, enc_hidden: torch.Tensor,
               enc_mask: torch.Tensor) -> DecodeCache:
    """Build the decode cache: zeroed flat self-attention slabs of length
    ``max_decode_len`` (int8 with f32 per-position scales when
    ``config.decode_cache_int8``), and the cross-attention K/V of
    ``enc_hidden``, computed once here."""
    cfg = model.config
    hd = cfg.num_heads * cfg.d_kv
    dev = enc_hidden.device
    int8 = cfg.decode_cache_int8
    slab_dtype = torch.int8 if int8 else torch_dtype(cfg.dtype)
    self_attn = []
    for _ in range(cfg.num_decoder_layers):
        shape = (batch_size, max_decode_len, hd)
        lc = LayerCache(torch.zeros(shape, dtype=slab_dtype, device=dev),
                        torch.zeros(shape, dtype=slab_dtype, device=dev))
        if int8:
            sshape = (batch_size, max_decode_len, cfg.num_heads)
            lc.k_scale = torch.zeros(sshape, dtype=torch.float32, device=dev)
            lc.v_scale = torch.zeros(sshape, dtype=torch.float32, device=dev)
        self_attn.append(lc)
    return DecodeCache(self_attn=self_attn,
                       cross_attn=model.init_decode_cache(enc_hidden, enc_mask),
                       enc_mask=enc_mask.float().contiguous())


def _as_tensor(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.long)
    return torch.as_tensor(np.asarray(x), dtype=torch.long, device=device)


@torch.no_grad()
def generate(model: T5ForConditionalGeneration, input_ids, attention_mask=None,
             max_new_tokens: int = 128, do_sample: bool = False,
             temperature: float = 1.0, top_k: int = 0,
             generator: Optional[torch.Generator] = None,
             early_stop: bool = True) -> torch.Tensor:
    """Generate ``max_new_tokens`` tokens per row on the model's device.

    ``input_ids`` / ``attention_mask`` ``[n, L]`` (numpy or torch; the mask
    defaults to ``input_ids != pad``).  Returns ``[n, max_new_tokens]``
    int64 on the model's device; rows that finished emit pad.  An all-pad
    input row is born finished.  ``early_stop`` ends the loop once every row
    has emitted EOS (the outputs are the same either way).  The batch is
    padded with all-pad rows up to the next power of two, as the JAX package
    does, so a stream of ragged batches sees few distinct shapes; greedy
    outputs of the real rows do not change."""
    cfg = model.config
    dev = model.device
    pad_id, eos_id = cfg.pad_token_id, cfg.eos_token_id
    input_ids = _as_tensor(input_ids, dev)
    if attention_mask is None:
        attention_mask = (input_ids != pad_id).long()
    else:
        attention_mask = _as_tensor(attention_mask, dev)
    n, L = input_ids.shape
    bucket = 1 << max(0, int(n - 1).bit_length())
    if bucket != n:
        input_ids = torch.cat([input_ids, torch.full((bucket - n, L), pad_id,
                                                     dtype=torch.long, device=dev)])
        attention_mask = torch.cat([attention_mask, torch.zeros(
            (bucket - n, L), dtype=torch.long, device=dev)])

    enc = model.encode(input_ids, attention_mask)
    cache = init_cache(model, bucket, max_new_tokens + 1, enc, attention_mask)
    tok = torch.full((bucket, 1), cfg.decoder_start_token_id, dtype=torch.long,
                     device=dev)
    finished = attention_mask.sum(dim=-1) == 0
    toks = torch.full((bucket, max_new_tokens), pad_id, dtype=torch.long, device=dev)
    for step in range(max_new_tokens):
        if early_stop and bool(finished.all()):
            break
        logits = model.decode(tok, cache=cache)[:, -1, :]
        nxt = sample_token(logits, generator, do_sample, temperature, top_k)
        nxt = torch.where(finished, torch.full_like(nxt, pad_id), nxt)
        finished = finished | (nxt == eos_id)
        toks[:, step] = nxt
        tok = nxt[:, None]
    return toks[:n]


# -- the engine's entry points ------------------------------------------------
#
# ``generate`` keeps the prefill (encode, cache build, first token) and the
# per-token step inside one call.  These expose the two phases on their own
# so an online engine (``tpu_air_torch.engine.T5Engine``) can admit and retire
# between steps.  The cache carries one position for the whole batch and the
# cross-attention K/V of every row, so the pair is batch-synchronized: every
# row sits at the same decode position.  Each call enters
# ``torch.inference_mode()`` itself: grad mode is per thread, and the engine
# decodes in a thread of its own.


def make_t5_prefill_fn(model: T5ForConditionalGeneration, max_decode_len: int):
    """``fn(input_ids, attention_mask) -> (first_tok, cache, enc_hidden)``:
    encode the prompts (int64 ``[b, L]`` on the model's device), build the
    decode cache of ``max_decode_len`` positions (zeroed self slabs, the
    cross K/V of the encoder output) and run the first decode step from
    ``decoder_start_token_id``; ``first_tok`` is the greedy int64 ``[b]``."""
    cfg = model.config

    def prefill(input_ids: torch.Tensor, attention_mask: torch.Tensor):
        with torch.inference_mode():
            enc = model.encode(input_ids, attention_mask)
            b = input_ids.shape[0]
            cache = init_cache(model, b, max_decode_len, enc, attention_mask)
            tok0 = torch.full((b, 1), cfg.decoder_start_token_id, dtype=torch.long,
                              device=input_ids.device)
            logits = model.decode(tok0, cache=cache)
            return torch.argmax(logits[:, -1, :], dim=-1), cache, enc

    return prefill


def make_t5_decode_step_fn(model: T5ForConditionalGeneration):
    """``fn(cache, tok) -> (cache, next_tok)``: one greedy cached step of the
    int64 ``[b]`` tokens.  The JAX package donates the cache and returns a
    new one; here the step writes the self-attention slabs in place and
    returns the same :class:`DecodeCache`, one position further on (it holds
    the encoder's K/V and mask, so the encoder output is not passed again)."""

    def step(cache: DecodeCache, tok: torch.Tensor):
        with torch.inference_mode():
            logits = model.decode(tok[:, None], cache=cache)
            return cache, torch.argmax(logits[:, -1, :], dim=-1)

    return step
