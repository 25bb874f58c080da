"""PyTorch T5 (encoder-decoder), the counterpart of
``tpu_air/models/t5/modeling.py``.

Architecture (T5 v1.1 == FLAN-T5): RMSNorm pre-norm, a bucketed relative
position bias computed once per stack and added in every layer, NO
attention score scaling, gated-GELU feed-forward, untied lm_head.

Parameters are float32; each projection and embedding casts its weight to
``config.dtype`` at the call, as Flax's ``nn.Dense(dtype=...)`` does, so a
bf16 model trains on f32 master weights.  For inference the predictors cast
the parameters once, at load, after which the per-call casts do nothing.
Dropout (``config.dropout_rate``, in ``train()`` mode only) hits the
attention probabilities and the feed-forward hidden layer, as in the JAX
package, with masks drawn from the ``generator`` the caller passes.

Attention runs through the port's kernels by device: on a CUDA tensor the
encoder self-attention (and any other structured-mask call with qlen > 1
and no active dropout) goes to the flash kernel, and every cached decode
step, self and cross, to the decode kernel; on a CPU tensor the same calls
take the kernels' plain versions.  Module names follow the Flax tree
(``shared``, ``encoder.rel_bias``, ``layers.<i>.self_attn.q`` ...), so
:func:`tpu_air_torch.models.t5.convert.params_from_jax` is a rename and a
transpose.

Split over a worker's ``model`` axis (``parallel/sharding.py::shard_module``
with ``t5_param_spec``), attention runs per shard over its heads and its
slice of the position bias, the feed-forward over its d_ff columns, and the
head over its vocab columns, whose cross entropy combines the shards'
log-sum-exp (``parallel/tensor_parallel.py``); dropout masks are drawn at the
logical shape and sliced, so a split model drops what the whole one drops.

Decode caches are flat ``[b, L, h*d]`` slabs (optionally int8 with scales)
held in :class:`DecodeCache` and written in place, one position per step.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tpu_air_torch.device import DeviceLike, resolve_device
from tpu_air_torch.models.layers import (Dense, Embed, apply_dropout, dropout,  # noqa: F401
                                         dropout_mask, torch_dtype)
from tpu_air_torch.ops.decode_attention import decode_attention
from tpu_air_torch.ops.flash_attention import flash_attention
from tpu_air_torch.parallel.tensor_parallel import ShardedDense, broadcast

from .config import T5Config

NEG_INF = -1e9


class RMSNorm(nn.Module):
    """T5 LayerNorm: scale-only RMS normalization, computed in f32."""

    def __init__(self, dim: int, eps: float, dtype: torch.dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.eps = eps
        self.out_dtype = dtype

    def forward(self, x):
        xf = x.float()
        var = xf.square().mean(-1, keepdim=True)
        y = xf * torch.rsqrt(var + self.eps)
        return (self.weight.float() * y).to(self.out_dtype)


def relative_position_bucket(relative_position: torch.Tensor, bidirectional: bool,
                             num_buckets: int, max_distance: int) -> torch.Tensor:
    """Bucketed relative positions (T5 paper 2.1), ``key - query``.  The log
    is taken in float32 with the same ``+1e-6`` and the cast truncates toward
    zero, as in the JAX package, so both give the same buckets."""
    ret = torch.zeros_like(relative_position)
    n = relative_position
    if bidirectional:
        num_buckets //= 2
        ret = ret + (n > 0).to(n.dtype) * num_buckets
        n = n.abs()
    else:
        n = -torch.clamp(n, max=0)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    denom = torch.log(torch.tensor(max_distance / max_exact, dtype=torch.float32))
    val_if_large = max_exact + (
        torch.log(n.float() / max_exact + 1e-6) / denom.to(n.device)
        * (num_buckets - max_exact)
    ).to(n.dtype)
    val_if_large = torch.clamp(val_if_large, max=num_buckets - 1)
    return ret + torch.where(is_small, n, val_if_large)


class RelativePositionBias(nn.Module):
    """Relative attention bias table -> ``[1, heads, qlen, klen]``."""

    def __init__(self, config: T5Config, bidirectional: bool):
        super().__init__()
        self.config = config
        self.bidirectional = bidirectional
        self.embedding = nn.Parameter(
            torch.zeros(config.relative_attention_num_buckets, config.num_heads))

    def forward(self, query_positions, key_positions):
        cfg = self.config
        rel = key_positions[None, :] - query_positions[:, None]
        buckets = relative_position_bucket(
            rel, self.bidirectional, cfg.relative_attention_num_buckets,
            cfg.relative_attention_max_distance)
        # an embedding lookup, not indexing: the gradient adds q*k positions
        # into 32 buckets, which indexing's backward (index_put_ with
        # accumulate) serializes on the card: it led the W1 step's profile
        bias = F.embedding(buckets, self.embedding)        # [q, k, heads]
        # rounded to the model type here, as the JAX package does: the kernels
        # then see this rounded bias widened back to f32
        return bias.permute(2, 0, 1)[None].to(torch_dtype(cfg.dtype))


@dataclass
class LayerCache:
    """One attention layer's decode cache: flat ``[b, L, h*d]`` slabs in the
    model type, or int8 with f32 scales (per-position ``[b, L, h]`` for self
    attention, per-channel ``[b, 1, h*d]`` for cross attention)."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None


@dataclass
class DecodeCache:
    """Everything the cached decode step reads: per decoder layer the self
    slabs (zeroed, length ``max_new_tokens + 1``) and the cross K/V computed
    once from the encoder output; the encoder key mask as f32; and the
    current decode position."""

    self_attn: List[LayerCache]
    cross_attn: List[LayerCache]
    enc_mask: torch.Tensor          # [b, enc_len] f32, 1 = attend
    pos: int = 0


def _quant_cross(x, kv_mask):
    """int8 with a per-(batch, head, channel) scale over the length dim.  Pad
    positions are zeroed first so an outlier there cannot coarsen the grid of
    the valid tokens.  Round half to even, as jnp.round."""
    xf = x.float()
    if kv_mask is not None:
        xf = xf * kv_mask[:, :, None, None].float()
    amax = xf.abs().amax(dim=1, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) / 127.0
    q8 = torch.clamp(torch.round(xf / scale), -127, 127)
    return q8.to(torch.int8), scale


def _quant_pos(x):
    """int8 with a per-(batch, position, head) scale over the channel dim."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) / 127.0
    q8 = torch.clamp(torch.round(xf / scale), -127, 127)
    return q8.to(torch.int8), scale


class Attention(nn.Module):
    """Multi-head attention; T5 scores are NOT scaled by sqrt(d_kv)."""

    def __init__(self, config: T5Config):
        super().__init__()
        self.config = config
        inner = config.num_heads * config.d_kv
        dt = torch_dtype(config.dtype)
        self.q = Dense(config.d_model, inner, dt)
        self.k = Dense(config.d_model, inner, dt)
        self.v = Dense(config.d_model, inner, dt)
        self.o = Dense(inner, config.d_model, dt)

    def _heads(self, x):
        """``[b, L, h*d]`` as ``[b, L, h, d]`` (h: all heads, or a shard's)."""
        b, L, _ = x.shape
        return x.view(b, L, -1, self.config.d_kv)

    def forward(self, hidden, kv_hidden, mask=None, position_bias=None,
                kv_mask=None, causal=False, generator=None):
        """Uncached attention.  ``mask`` is a dense additive
        ``[*, 1|h, q, k]`` mask; ``kv_mask`` ``[b, k]`` (1 = attend) and
        ``causal`` are the structured form the flash kernel takes.  With
        dropout active (``train()`` and ``dropout_rate > 0``) the call takes
        the dense path, whose probabilities it drops, as the JAX package
        does."""
        cfg = self.config
        drop = self.training and cfg.dropout_rate > 0
        if isinstance(self.q, ShardedDense):
            return self._forward_shards(hidden, kv_hidden, mask, position_bias, kv_mask,
                                        causal, generator, drop)
        q = self._heads(self.q(hidden))                    # [b, q, h, d]
        k = self._heads(self.k(kv_hidden))
        v = self._heads(self.v(kv_hidden))
        keep = None
        if drop:
            keep = dropout_mask((q.shape[0], cfg.num_heads, q.shape[1], k.shape[1]),
                                cfg.dropout_rate, generator, q.device)
        return self.o(self._attend(q, k, v, mask, position_bias, kv_mask, causal,
                                   keep).reshape(q.shape[0], q.shape[1], -1))

    def _attend(self, q, k, v, mask, position_bias, kv_mask, causal, keep):
        """``[b, q, h, d]`` attention output over ``q``'s heads (all of
        them, or a shard's, with the bias and dropout keep mask sliced to
        them): the flash kernel for a structured mask and no dropout, else
        the dense path."""
        b, qlen = q.shape[:2]
        klen = k.shape[1]
        if qlen > 1 and mask is None and keep is None:
            # flash path: (b, h, L, d) views of the projections, no copies;
            # position_bias stays (1, h, q, k) and is not expanded
            return flash_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                None if position_bias is None else position_bias.float(),
                kv_mask=kv_mask, causal=causal, scale=1.0,
            ).transpose(1, 2)
        dtype = q.dtype
        if mask is None and (kv_mask is not None or causal):
            mask = torch.zeros(1, 1, qlen, klen, device=q.device)
            if kv_mask is not None:
                mask = mask + (1.0 - kv_mask[:, None, None, :].float()) * NEG_INF
            if causal:
                c = torch.ones(qlen, klen, device=q.device).tril()
                mask = mask + ((1.0 - c) * NEG_INF)[None, None]
            mask = mask.to(dtype)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k)
        if position_bias is not None:
            scores = scores + position_bias
        if mask is not None:
            scores = scores + mask
        probs = torch.softmax(scores.float(), dim=-1).to(dtype)
        if keep is not None:
            probs = apply_dropout(probs, keep, self.config.dropout_rate)
        return torch.einsum("bhqk,bkhd->bqhd", probs, v)

    def _forward_shards(self, hidden, kv_hidden, mask, position_bias, kv_mask, causal,
                        generator, drop):
        """Split over the model axis: each shard projects its heads and
        attends over them, with its heads' slice of the position bias and
        of a dropout mask drawn at the logical ``[b, h, q, k]`` shape (the
        single-device layer's masks); its part of o is reduced on
        ``hidden``'s device."""
        cfg = self.config
        devices = self.q.devices
        hs = broadcast(hidden, devices)
        ks = hs if kv_hidden is hidden else broadcast(kv_hidden, devices)
        b, qlen = hidden.shape[:2]
        keep = None
        if drop:
            keep = dropout_mask((b, cfg.num_heads, qlen, kv_hidden.shape[1]),
                                cfg.dropout_rate, generator, hidden.device)
        outs, h0 = [], 0
        for q, k, v in zip(self.q(hs), self.k(ks), self.v(ks)):
            q, k, v = self._heads(q), self._heads(k), self._heads(v)
            h1 = h0 + q.shape[2]
            dev = q.device

            def heads(t):
                return None if t is None else t[:, h0:h1].to(dev)

            ctx = self._attend(q, k, v, None if mask is None else mask.to(dev),
                               heads(position_bias),
                               None if kv_mask is None else kv_mask.to(dev), causal,
                               heads(keep))
            outs.append(ctx.reshape(b, qlen, -1))
            h0 = h1
        return self.o(outs, hidden.device)

    def cross_cache(self, enc_hidden, enc_mask) -> LayerCache:
        """Cross-attention K/V of the encoder output, computed once per
        generate call (re-projecting them every step would dominate it)."""
        k = self._heads(self.k(enc_hidden))
        v = self._heads(self.v(enc_hidden))
        b, L = k.shape[:2]
        if self.config.decode_cache_int8:
            kq, ks = _quant_cross(k, enc_mask)
            vq, vs = _quant_cross(v, enc_mask)
            return LayerCache(kq.reshape(b, L, -1), vq.reshape(b, L, -1),
                              ks.reshape(b, 1, -1), vs.reshape(b, 1, -1))
        return LayerCache(k.reshape(b, L, -1), v.reshape(b, L, -1))

    def step_self(self, hidden, cache: LayerCache, pos: int, bias_hl):
        """Cached self-attention for one token at ``pos``: writes its K/V
        into the slabs IN PLACE, then attends over the whole slab.
        ``bias_hl`` [h, L] f32 carries the position bias and causal row."""
        b = hidden.shape[0]
        q = self._heads(self.q(hidden))                    # [b, 1, h, d]
        k = self.k(hidden)[:, 0]                           # [b, h*d]
        v = self.v(hidden)[:, 0]
        if cache.k_scale is not None:
            h = self.config.num_heads
            k8, ks = _quant_pos(k.view(b, h, -1))
            v8, vs = _quant_pos(v.view(b, h, -1))
            cache.k[:, pos] = k8.view(b, -1)
            cache.v[:, pos] = v8.view(b, -1)
            cache.k_scale[:, pos] = ks[..., 0]
            cache.v_scale[:, pos] = vs[..., 0]
        else:
            cache.k[:, pos] = k
            cache.v[:, pos] = v
        ctx = decode_attention(q, cache.k, cache.v, bias=bias_hl,
                               k_scale=cache.k_scale, v_scale=cache.v_scale)
        return self.o(ctx.reshape(b, 1, -1))

    def step_cross(self, hidden, cache: LayerCache, enc_mask):
        """Cached cross-attention for one token over the encoder K/V."""
        b = hidden.shape[0]
        q = self._heads(self.q(hidden))
        ctx = decode_attention(q, cache.k, cache.v, kv_mask=enc_mask,
                               k_scale=cache.k_scale, v_scale=cache.v_scale)
        return self.o(ctx.reshape(b, 1, -1))


_ACTS = {  # the T5 feed-forward activations (v1.1 / FLAN gated-gelu, v1.0 relu)
    "gelu": lambda x: F.gelu(x, approximate="tanh"),  # jax.nn.gelu's default
    "relu": F.relu,
}


class FeedForward(nn.Module):
    def __init__(self, config: T5Config):
        super().__init__()
        self.config = config
        if config.act_fn not in _ACTS:
            raise ValueError(f"unsupported activation {config.act_fn!r}")
        self.act = _ACTS[config.act_fn]
        dt = torch_dtype(config.dtype)
        if config.is_gated_act:
            self.wi_0 = Dense(config.d_model, config.d_ff, dt)
            self.wi_1 = Dense(config.d_model, config.d_ff, dt)
        else:
            self.wi = Dense(config.d_model, config.d_ff, dt)
        self.wo = Dense(config.d_ff, config.d_model, dt)

    def forward(self, x, generator=None):
        cfg = self.config
        drop = self.training and cfg.dropout_rate > 0
        if isinstance(self.wo, ShardedDense):
            # split by d_ff: each shard its columns of the hidden layer and
            # of a dropout mask drawn at the logical [b, l, d_ff] shape
            xs = broadcast(x, self.wo.devices)
            if cfg.is_gated_act:
                hs = [self.act(a) * g for a, g in zip(self.wi_0(xs), self.wi_1(xs))]
            else:
                hs = [self.act(a) for a in self.wi(xs)]
            if drop:
                keep = dropout_mask(x.shape[:-1] + (cfg.d_ff,), cfg.dropout_rate, generator,
                                    x.device)
                c0 = 0
                for i, h in enumerate(hs):
                    c1 = c0 + h.shape[-1]
                    hs[i] = apply_dropout(h, keep[..., c0:c1].to(h.device), cfg.dropout_rate)
                    c0 = c1
            return self.wo(hs, x.device)
        if cfg.is_gated_act:
            h = self.act(self.wi_0(x)) * self.wi_1(x)
        else:
            h = self.act(self.wi(x))
        if drop:
            h = dropout(h, cfg.dropout_rate, generator)
        return self.wo(h)


class EncoderLayer(nn.Module):
    def __init__(self, config: T5Config):
        super().__init__()
        dt = torch_dtype(config.dtype)
        self.ln_self = RMSNorm(config.d_model, config.layer_norm_epsilon, dt)
        self.self_attn = Attention(config)
        self.ln_mlp = RMSNorm(config.d_model, config.layer_norm_epsilon, dt)
        self.mlp = FeedForward(config)

    def forward(self, x, kv_mask, position_bias, generator=None):
        h = self.ln_self(x)
        x = x + self.self_attn(h, h, None, position_bias, kv_mask=kv_mask,
                               generator=generator)
        return x + self.mlp(self.ln_mlp(x), generator)


class DecoderLayer(nn.Module):
    def __init__(self, config: T5Config):
        super().__init__()
        dt = torch_dtype(config.dtype)
        eps = config.layer_norm_epsilon
        self.ln_self = RMSNorm(config.d_model, eps, dt)
        self.self_attn = Attention(config)
        self.ln_cross = RMSNorm(config.d_model, eps, dt)
        self.cross_attn = Attention(config)
        self.ln_mlp = RMSNorm(config.d_model, eps, dt)
        self.mlp = FeedForward(config)

    def forward(self, x, enc, position_bias, self_kv_mask=None,
                cross_kv_mask=None, generator=None):
        h = self.ln_self(x)
        x = x + self.self_attn(h, h, None, position_bias, kv_mask=self_kv_mask,
                               causal=True, generator=generator)
        h = self.ln_cross(x)
        x = x + self.cross_attn(h, enc, None, None, kv_mask=cross_kv_mask,
                                generator=generator)
        return x + self.mlp(self.ln_mlp(x), generator)

    def step(self, x, self_cache: LayerCache, cross_cache: LayerCache, pos,
             bias_hl, enc_mask):
        x = x + self.self_attn.step_self(self.ln_self(x), self_cache, pos, bias_hl)
        x = x + self.cross_attn.step_cross(self.ln_cross(x), cross_cache, enc_mask)
        return x + self.mlp(self.ln_mlp(x))


class Encoder(nn.Module):
    def __init__(self, config: T5Config):
        super().__init__()
        self.rel_bias = RelativePositionBias(config, bidirectional=True)
        self.layers = nn.ModuleList(EncoderLayer(config)
                                    for _ in range(config.num_layers))
        self.final_ln = RMSNorm(config.d_model, config.layer_norm_epsilon,
                                torch_dtype(config.dtype))

    def forward(self, embeds, attention_mask, generator=None):
        positions = torch.arange(embeds.shape[1], device=embeds.device)
        bias = self.rel_bias(positions, positions)
        x = embeds
        for layer in self.layers:
            x = layer(x, attention_mask, bias, generator)
        return self.final_ln(x)


class Decoder(nn.Module):
    def __init__(self, config: T5Config):
        super().__init__()
        self.config = config
        self.rel_bias = RelativePositionBias(config, bidirectional=False)
        self.layers = nn.ModuleList(DecoderLayer(config)
                                    for _ in range(config.num_decoder_layers))
        self.final_ln = RMSNorm(config.d_model, config.layer_norm_epsilon,
                                torch_dtype(config.dtype))

    def forward(self, embeds, enc, enc_mask, dec_mask=None, generator=None):
        positions = torch.arange(embeds.shape[1], device=embeds.device)
        bias = self.rel_bias(positions, positions)
        x = embeds
        for layer in self.layers:
            x = layer(x, enc, bias, self_kv_mask=dec_mask, cross_kv_mask=enc_mask,
                      generator=generator)
        return self.final_ln(x)

    def step_bias(self, pos: int, klen: int, device) -> torch.Tensor:
        """The ``[h, klen]`` f32 additive bias of the query at ``pos``: the
        position bias (in the model type) plus the causal row at -1e9 (in the
        model type), summed in f32 as the JAX decode path sums them."""
        keys = torch.arange(klen, device=device)
        bias = self.rel_bias(torch.tensor([pos], device=device), keys)
        causal = (keys <= pos).float()
        self_mask = ((1.0 - causal) * NEG_INF).to(bias.dtype)
        return (bias[0, :, 0, :].float() + self_mask.float()[None]).contiguous()

    def step(self, embeds, cache: DecodeCache):
        klen = cache.self_attn[0].k.shape[1]
        bias_hl = self.step_bias(cache.pos, klen, embeds.device)
        x = embeds
        for layer, sc, cc in zip(self.layers, cache.self_attn, cache.cross_attn):
            x = layer.step(x, sc, cc, cache.pos, bias_hl, cache.enc_mask)
        cache.pos += 1
        return self.final_ln(x)


class T5ForConditionalGeneration(nn.Module):
    """Encoder-decoder LM head model.  Built on ``device`` (``cuda:0`` by
    default; raises without a GPU unless ``device="cpu"``) with f32 weights
    that compute in ``config.dtype``; the weights are placeholders until
    loaded or set by :meth:`init_weights`.  Built in ``eval()`` mode."""

    def __init__(self, config: T5Config, device: DeviceLike = None):
        super().__init__()
        self.config = config
        dev = resolve_device(device)
        dt = torch_dtype(config.dtype)
        with torch.device(dev):
            self.shared = Embed(config.vocab_size, config.d_model, dt)
            self.encoder = Encoder(config)
            self.decoder = Decoder(config)
            if not config.tie_word_embeddings:
                self.lm_head = Dense(config.d_model, config.vocab_size, dt)
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.shared.weight.device

    def _init_std(self, name: str) -> Optional[float]:
        """T5's own (Mesh TensorFlow) initializer scale for each weight, as
        the HF T5 the reference fine-tunes uses: unit embeddings and head,
        (d_model*d_kv)^-0.5 for q (it stands in for the 1/sqrt(d_kv) score
        scaling T5 leaves out), (h*d_kv)^-0.5 for o, d_ff^-0.5 for wo and
        d_model^-0.5 for the rest.  None = ones (RMSNorm)."""
        cfg = self.config
        if "ln_" in name or "final_ln" in name:
            return None
        if name in ("shared.weight", "lm_head.weight"):
            return 1.0
        if name.endswith(".q.weight"):
            return (cfg.d_model * cfg.d_kv) ** -0.5
        if name.endswith(".o.weight"):
            return (cfg.num_heads * cfg.d_kv) ** -0.5
        if name.endswith("wo.weight"):
            return cfg.d_ff ** -0.5
        return cfg.d_model ** -0.5

    @torch.no_grad()
    def init_weights(self, seed: int = 0) -> "T5ForConditionalGeneration":
        """Random weights from a numpy seed at T5's initializer scales; the
        same seed gives the same weights on any device."""
        rng = np.random.default_rng(seed)
        for name, p in self.named_parameters():
            std = self._init_std(name)
            if std is None:
                p.fill_(1.0)
                continue
            w = rng.standard_normal(tuple(p.shape), dtype=np.float32) * np.float32(std)
            p.copy_(torch.from_numpy(w))
        return self

    def encode(self, input_ids, attention_mask, generator=None):
        return self.encoder(self.shared(input_ids), attention_mask, generator)

    def _head(self, hidden):
        """The logits; from a ``lm_head`` split over the model axis, a list
        of the vocab shards' logits, which :func:`cross_entropy_sum` takes."""
        cfg = self.config
        if cfg.tie_word_embeddings:
            hidden = hidden * (cfg.d_model ** -0.5)
            return hidden @ self.shared.weight.t().to(hidden.dtype)
        return self.lm_head(hidden)

    def init_decode_cache(self, encoder_hidden, encoder_mask) -> List[LayerCache]:
        """Per decoder layer, the cross-attention K/V of the encoder output."""
        return [layer.cross_attn.cross_cache(encoder_hidden, encoder_mask)
                for layer in self.decoder.layers]

    def decode(self, decoder_input_ids, encoder_hidden=None, encoder_mask=None,
               decoder_attention_mask=None, cache: Optional[DecodeCache] = None,
               generator=None):
        """Decoder + LM head.  With ``cache``, one cached step of
        ``decoder_input_ids`` ``[b, 1]`` (the cache advances by one);
        without, a teacher-forced pass over the whole sequence."""
        embeds = self.shared(decoder_input_ids)
        if cache is not None:
            hidden = self.decoder.step(embeds, cache)
        else:
            hidden = self.decoder(embeds, encoder_hidden, encoder_mask,
                                  dec_mask=decoder_attention_mask, generator=generator)
        return self._head(hidden)

    def forward(self, input_ids, attention_mask, decoder_input_ids,
                decoder_attention_mask=None, generator=None):
        """Logits of a teacher-forced pass.  ``generator`` draws the dropout
        masks in ``train()`` mode (the JAX package's ``rngs={"dropout"}``)."""
        enc = self.encode(input_ids, attention_mask, generator)
        return self.decode(decoder_input_ids, enc, attention_mask,
                           decoder_attention_mask=decoder_attention_mask,
                           generator=generator)


# -- training-loss helpers ---------------------------------------------------


def shift_right(labels: torch.Tensor, decoder_start_token_id: int,
                pad_token_id: int) -> torch.Tensor:
    """Teacher-forcing inputs: [start, y_0, ..., y_{n-2}]."""
    shifted = torch.roll(labels, 1, dims=-1)
    shifted[:, 0] = decoder_start_token_id
    return torch.where(shifted == -100, torch.full_like(shifted, pad_token_id), shifted)


def cross_entropy_sum(logits: torch.Tensor, labels: torch.Tensor,
                      pad_token_id: int):
    """Summed CE over non-pad label positions and their count (f32 and
    int64 device scalars): a data-parallel step divides the sum of every
    rank by the count over all of them."""
    mask = (labels != pad_token_id) & (labels != -100)
    safe = torch.where(mask, labels, torch.zeros_like(labels))
    if isinstance(logits, (list, tuple)):
        nll = _vocab_parallel_nll(logits, safe)
    else:
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -torch.gather(logp, -1, safe[..., None].long())[..., 0]
    return (nll * mask).sum(), mask.sum()


def _vocab_parallel_nll(shards, targets: torch.Tensor) -> torch.Tensor:
    """Per-position NLL from logits split over the vocab (one tensor a
    shard, in vocab order, each on its device): the log-sum-exp combined
    across the shards on ``targets``' device, minus the target's logit,
    taken from the shard that holds it."""
    home = targets.device
    parts = [s.float() for s in shards]
    m = torch.stack([p.detach().amax(-1).to(home) for p in parts]).amax(0)
    se = None
    for p in parts:
        e = torch.exp(p - m.to(p.device)[..., None]).sum(-1).to(home)
        se = e if se is None else se + e
    picked = torch.zeros(targets.shape, dtype=torch.float32, device=home)
    lo = 0
    for p in parts:
        hi = lo + p.shape[-1]
        t = targets.to(p.device)
        mine = (t >= lo) & (t < hi)
        idx = torch.where(mine, t - lo, torch.zeros_like(t)).long()
        got = torch.gather(p, -1, idx[..., None])[..., 0]
        picked = picked + torch.where(mine, got, torch.zeros_like(got)).to(home)
        lo = hi
    return m + torch.log(se) - picked


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       pad_token_id: int):
    """Mean CE over non-pad label positions.  Returns (loss, num_tokens)."""
    total, count = cross_entropy_sum(logits, labels, pad_token_id)
    ntok = torch.clamp(count, min=1)
    return total / ntok, ntok
