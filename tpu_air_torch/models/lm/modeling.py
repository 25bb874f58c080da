"""PyTorch long-context causal LM, the counterpart of
``tpu_air/models/lm/modeling.py``.

Architecture: pre-RMSNorm, RoPE attention (interleaved pairs), SwiGLU MLP,
tied embeddings.  Without a cache, attention is causal flash attention
through the port's kernels by device: the forward and both backward kernels
on a CUDA tensor, their plain versions on a CPU tensor.  Given a
``sequence_group`` of two or more ranks (the input is then this rank's
shard of each sequence, ``positions`` its global positions), attention is
ring attention over that group through the same kernels, the JAX package's
``attention="ring"`` branch.  Split over a worker's ``model`` axis
(``parallel/sharding.py::shard_module``), attention and the SwiGLU run per
shard, at h/tp heads and d_ff/tp columns, through the same kernels
(``parallel/tensor_parallel.py``).  The model is applied deterministically (no
dropout), as every training path of the JAX package applies it.

With ``decode=True`` the model reads and writes a KV cache: one
:class:`AttnCache` per layer, Flax's mutable ``"cache"`` collection made
explicit, under its leaf names.  The cache's tensors are written in place
(the torch form of JAX's donation).  Four branches, as in the JAX package:

* offline, scalar ``cache_index``: a prefill (l > 1) attends densely over
  the flat ``[b, L, h*d]`` slabs from the index on; a 1-token step attends
  through the decode kernel;
* per-row ``cache_index`` ``[S]`` (the slab engine), 1-token steps only;
* paged (a ``block_table``): page pools ``[P, page_len, h*d]``; a 1-token
  step scatters to each row's page and attends over the gathered slabs
  through the decode kernel;
* paged chunk prefill: one slot, one page-sized chunk, dense attention over
  the gathered pages.

Every 1-token step goes through :func:`decode_attention`, the decode kernel
on a CUDA tensor, where the JAX package runs ``flat_decode_attention`` (the
same function in XLA).  Prefill stays dense, as there.  Decode is inference:
call it under ``torch.no_grad()`` or ``torch.inference_mode()``.

Precision as in Flax: parameters stay f32; each dense layer casts its input
and weight to ``config.dtype`` per call (``nn.Dense(dtype=...)``), RMSNorm
and RoPE compute in f32 and cast back, and the logits and the loss are f32.

Module names follow the Flax tree (``embedding``, ``layers.<i>.attn.q``,
``layers.<i>.mlp_norm`` ...), so
:func:`tpu_air_torch.models.lm.convert.params_from_jax` is a rename and a
transpose.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from tpu_air_torch.device import DeviceLike, resolve_device
from tpu_air_torch.models.layers import Dense
from tpu_air_torch.ops.decode_attention import decode_attention, gather_pages
from tpu_air_torch.ops.flash_attention import flash_attention
from tpu_air_torch.ops.ring_attention import ring_attention
from tpu_air_torch.parallel.tensor_parallel import ShardedDense, broadcast

from .config import LMConfig

NEG_INF = -1e30
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    if name not in _DTYPES:
        raise ValueError(f"unsupported dtype {name!r}")
    return _DTYPES[name]


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float, dtype: torch.dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.eps = eps
        self.out_dtype = dtype

    def forward(self, x):
        xf = x.float()
        var = xf.square().mean(-1, keepdim=True)
        return (self.weight * xf * torch.rsqrt(var + self.eps)).to(self.out_dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding of interleaved pairs (x[..., 0::2], x[..., 1::2]).
    x: (B, H, L, D), positions: (B, L) global token positions.  Computes in
    f32 and casts back to x's type."""
    d = x.shape[-1]
    inv_freq = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                             device=x.device) / d))
    ang = positions[:, None, :, None].float() * inv_freq          # (B,1,L,D/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., 0::2], x[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.stack([y1, y2], dim=-1).reshape(x.shape).to(x.dtype)


@dataclass
class AttnCache:
    """One attention layer's decode state, under the Flax cache leaf names.

    ``cached_key`` / ``cached_value``: flat slabs ``[b, L, h*d]``, or page
    pools ``[P, page_len, h*d]`` when ``block_table`` ``[S, pages_per_slot]``
    is set.  ``cache_index``: an int (offline generation: every row at one
    position) or an integer tensor ``[S]`` (the engines: each row at its
    own).  Each call writes the new K/V into the slabs in place and moves
    the index on by the tokens it wrote."""

    cached_key: torch.Tensor
    cached_value: torch.Tensor
    cache_index: Union[int, torch.Tensor]
    block_table: Optional[torch.Tensor] = None

    def key_len(self) -> int:
        """Key positions a step attends over: the slab's length, or the
        pages a row's table reaches."""
        if self.block_table is None:
            return self.cached_key.shape[1]
        return self.block_table.shape[1] * self.cached_key.shape[1]


def step_mask(cache: AttnCache, b: int) -> torch.Tensor:
    """The 1-token step's key mask, f32 ``[b, L]`` (1 = attend): positions up
    to and including each row's index, where the step writes its own K/V.
    Built once per step and shared by every layer (all sit at one index)."""
    i = cache.cache_index
    L = cache.key_len()
    keys = torch.arange(L, device=cache.cached_key.device)
    if isinstance(i, int):
        return (keys <= i).float().expand(b, L).contiguous()
    return (keys[None, :] <= i[:, None]).float()


def _ring_size(group) -> int:
    """Ranks of a sequence group (1 for None)."""
    if group is None:
        return 1
    import torch.distributed as dist

    return dist.get_world_size(group)


def _dense_causal_attention(q, k, v, scale, q_offset=0):
    """(B, H, L, D) attention with f32 scores and a causal mask whose
    queries start at ``q_offset`` (an int or a 0-d tensor); the JAX
    package's ``_dense_causal_attention``."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    lq, lk = q.shape[2], k.shape[2]
    qi = q_offset + torch.arange(lq, device=q.device)[:, None]
    kj = torch.arange(lk, device=q.device)[None, :]
    s = torch.where(qi >= kj, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


class CausalSelfAttention(nn.Module):
    def __init__(self, config: LMConfig):
        super().__init__()
        self.config = config
        dt = torch_dtype(config.dtype)
        inner = config.n_heads * config.head_dim
        self.q = Dense(config.d_model, inner, dt)
        self.k = Dense(config.d_model, inner, dt)
        self.v = Dense(config.d_model, inner, dt)
        self.o = Dense(inner, config.d_model, dt)
        self.scale = 1.0 / (config.head_dim ** 0.5)
        # the JAX package scales q in the model type before the decode call:
        # a Python float there is first rounded to that type, so the port
        # multiplies by the same rounded value
        self.q_scale = float(torch.tensor(self.scale, dtype=dt, device="cpu"))

    def forward(self, x, positions, cache: Optional[AttnCache] = None,
                kv_mask: Optional[torch.Tensor] = None, sequence_group=None):
        cfg = self.config
        if isinstance(self.q, ShardedDense):
            if cache is not None or _ring_size(sequence_group) > 1:
                raise ValueError("a tensor-parallel LM trains on whole sequences: no cache, "
                                 "no sequence group")
            return self._forward_shards(x, positions)
        b, l, _ = x.shape
        h, d = cfg.n_heads, cfg.head_dim

        def heads(t):                                    # (b, h, l, d) view
            return t.view(b, l, h, d).transpose(1, 2)

        q = rope(heads(self.q(x)), positions, cfg.rope_theta)
        k = rope(heads(self.k(x)), positions, cfg.rope_theta)
        if cache is not None:
            v = self.v(x)
            kflat = k.transpose(1, 2).reshape(b, l, h * d)
            return self.o(self._decode(q, kflat, v, cache, kv_mask))
        v = heads(self.v(x))
        if _ring_size(sequence_group) > 1:
            o = ring_attention(q, k, v, sequence_group, scale=self.scale, causal=True)
        else:
            o = flash_attention(q, k, v, scale=self.scale, causal=True)
        return self.o(o.transpose(1, 2).reshape(b, l, h * d))

    def _forward_shards(self, x, positions):
        """Split over the model axis: each shard projects its heads, runs
        causal flash attention over them and its part of o, which is
        reduced on ``x``'s device."""
        cfg = self.config
        b, l, _ = x.shape
        d = cfg.head_dim
        xs = broadcast(x, self.q.devices)
        outs = []
        for q, k, v in zip(self.q(xs), self.k(xs), self.v(xs)):
            hs = q.shape[-1] // d
            pos = positions.to(q.device)
            q = rope(q.view(b, l, hs, d).transpose(1, 2), pos, cfg.rope_theta)
            k = rope(k.view(b, l, hs, d).transpose(1, 2), pos, cfg.rope_theta)
            o = flash_attention(q, k, v.view(b, l, hs, d).transpose(1, 2), scale=self.scale,
                                causal=True)
            outs.append(o.transpose(1, 2).reshape(b, l, hs * d))
        return self.o(outs, x.device)

    def _step(self, q, ks, vs, kv_mask):
        """One query token per row through the decode kernel (its plain
        version on the CPU), q scaled first as the JAX package scales it."""
        b, h, _, d = q.shape
        o = decode_attention(q.transpose(1, 2) * self.q_scale, ks, vs, kv_mask=kv_mask)
        return o.reshape(b, 1, h * d)

    def _dense(self, q, ks, vs, q_offset):
        b, h, l, d = q.shape
        k4 = ks.view(ks.shape[0], -1, h, d).transpose(1, 2)
        v4 = vs.view(vs.shape[0], -1, h, d).transpose(1, 2)
        o = _dense_causal_attention(q, k4, v4, self.scale, q_offset)
        return o.transpose(1, 2).reshape(b, l, h * d)

    def _decode(self, q, kflat, vflat, c: AttnCache, kv_mask):
        b, _, l, _ = q.shape
        ck, cv, i = c.cached_key, c.cached_value, c.cache_index
        kflat, vflat = kflat.to(ck.dtype), vflat.to(cv.dtype)
        if c.block_table is not None:
            table = c.block_table
            C = ck.shape[1]
            if l == 1:
                rows = torch.arange(b, device=ck.device)
                page, off = table[rows, i // C], i % C
                # Rows that are free or mid-prefill point at the null page 0
                # and sit at position 0, so several rows write (0, 0) at
                # once; a non-accumulating index_put_ on CUDA keeps one of
                # them at random.  That is harmless only because page 0 is
                # never read unmasked: live rows reach it only past their
                # index, and the rows reading it are ones whose output the
                # engine drops.
                ck[page, off] = kflat[:, 0]
                cv[page, off] = vflat[:, 0]
                c.cache_index = i + 1
                return self._step(q, gather_pages(ck, table), gather_pages(cv, table), kv_mask)
            if b != 1 or l != C:
                raise ValueError(f"paged chunk prefill wants b=1, l=page_len ({C}); "
                                 f"got b={b}, l={l}")
            p0 = i[0]
            page = table[0, p0 // C].reshape(1)
            ck.index_copy_(0, page, kflat)
            cv.index_copy_(0, page, vflat)
            c.cache_index = i + l
            return self._dense(q, gather_pages(ck, table[:1]), gather_pages(cv, table[:1]), p0)
        if not isinstance(i, int):
            # per-row index: each slot at its own position; positions past
            # i[row] may hold a retired occupant's stale K/V, which the
            # per-row mask hides until later steps overwrite them
            if l != 1:
                raise ValueError(f"per-row cache_index supports single-token decode "
                                 f"steps only; got l={l}")
            rows = torch.arange(b, device=ck.device)
            ck[rows, i] = kflat[:, 0]
            cv[rows, i] = vflat[:, 0]
            c.cache_index = i + 1
            return self._step(q, ck, cv, kv_mask)
        ck[:, i:i + l] = kflat
        cv[:, i:i + l] = vflat
        c.cache_index = i + l
        if l == 1:
            return self._step(q, ck, cv, kv_mask)
        # prefill (any multi-token window): dense over the whole slab with
        # the queries at the index; future positions are zeros, masked
        return self._dense(q, ck, cv, i)


class SwiGLU(nn.Module):
    def __init__(self, config: LMConfig):
        super().__init__()
        dt = torch_dtype(config.dtype)
        self.gate = Dense(config.d_model, config.d_ff, dt)
        self.up = Dense(config.d_model, config.d_ff, dt)
        self.down = Dense(config.d_ff, config.d_model, dt)

    def forward(self, x):
        if isinstance(self.gate, ShardedDense):
            xs = broadcast(x, self.gate.devices)
            return self.down([F.silu(g) * u for g, u in zip(self.gate(xs), self.up(xs))],
                             x.device)
        return self.down(F.silu(self.gate(x)) * self.up(x))


class Block(nn.Module):
    def __init__(self, config: LMConfig):
        super().__init__()
        dt = torch_dtype(config.dtype)
        self.attn_norm = RMSNorm(config.d_model, config.rmsnorm_eps, dt)
        self.attn = CausalSelfAttention(config)
        self.mlp_norm = RMSNorm(config.d_model, config.rmsnorm_eps, dt)
        self.mlp = SwiGLU(config)

    def forward(self, x, positions, cache: Optional[AttnCache] = None,
                kv_mask: Optional[torch.Tensor] = None, sequence_group=None):
        x = x + self.attn(self.attn_norm(x), positions, cache, kv_mask, sequence_group)
        return x + self.mlp(self.mlp_norm(x))


class CausalLM(nn.Module):
    """``model(input_ids, positions=None) -> logits`` (f32).

    Built on ``device`` (``cuda:0`` by default; raises without a GPU unless
    ``device="cpu"``) with f32 parameters; they are placeholders until
    loaded or set by :meth:`init_weights`.  ``positions`` (B, L) defaults
    to 0..L-1.  ``return_hidden=True`` returns the final-norm hidden states
    instead of the logits, for :func:`lm_chunked_loss_with_targets` and the
    generate loops.  ``decode=True`` reads and writes ``cache``, one
    :class:`AttnCache` per layer (``models/lm/generate.py`` builds them).
    ``sequence_group``: a ``torch.distributed`` group of two or more ranks,
    each calling with its shard of the same sequences, attends through ring
    attention over it (training only, no cache)."""

    def __init__(self, config: LMConfig, device: DeviceLike = None):
        super().__init__()
        self.config = config
        with torch.device(resolve_device(device)):
            self.embedding = nn.Parameter(torch.empty(config.vocab_size, config.d_model))
            self.layers = nn.ModuleList(Block(config) for _ in range(config.n_layers))
            self.final_norm = RMSNorm(config.d_model, config.rmsnorm_eps,
                                      torch_dtype(config.dtype))
            if not config.tie_embeddings:
                self.lm_head = Dense(config.d_model, config.vocab_size, torch.float32)

    @property
    def device(self) -> torch.device:
        return self.embedding.device

    @torch.no_grad()
    def init_weights(self, seed: int = 0) -> "CausalLM":
        """The JAX package's initializer scales from a numpy seed: normal(0.02)
        for the embedding and every dense kernel, ones for the norms.  The
        same seed gives the same weights on any device."""
        rng = np.random.default_rng(seed)
        for name, p in self.named_parameters():
            if name.endswith("norm.weight"):
                p.fill_(1.0)
                continue
            w = rng.standard_normal(tuple(p.shape), dtype=np.float32) * np.float32(0.02)
            p.copy_(torch.from_numpy(w))
        return self

    def forward(self, input_ids, positions: Optional[torch.Tensor] = None,
                return_hidden: bool = False, decode: bool = False,
                cache: Optional[List[AttnCache]] = None, sequence_group=None):
        cfg = self.config
        b, l = input_ids.shape
        if l > cfg.max_seq_len:
            raise ValueError(f"sequence length {l} exceeds max_seq_len {cfg.max_seq_len}")
        if decode and _ring_size(sequence_group) > 1:
            raise ValueError("decode=True runs on whole sequences, not over a sequence group")
        if decode and (cache is None or len(cache) != cfg.n_layers):
            raise ValueError(f"decode=True needs one AttnCache per layer ({cfg.n_layers})")
        if not decode:
            cache = [None] * cfg.n_layers
        if positions is None:
            positions = torch.arange(l, device=input_ids.device).expand(b, l)
        # the 1-token step's key mask: one contiguous f32 [b, L] per step,
        # shared by the layers
        kv_mask = step_mask(cache[0], b) if decode and l == 1 else None
        x = self.embedding[input_ids].to(torch_dtype(cfg.dtype))
        for layer, c in zip(self.layers, cache):
            x = layer(x, positions, c, kv_mask, sequence_group)
        x = self.final_norm(x)
        if return_hidden:
            return x
        if cfg.tie_embeddings:
            return x.float() @ self.embedding.t()
        return self.lm_head(x.float())


def head_weight(model: CausalLM) -> torch.Tensor:
    """The (d_model, vocab) head matrix of a CausalLM."""
    if model.config.tie_embeddings:
        return model.embedding.t()
    return model.lm_head.weight.t()


def lm_loss_with_targets(logits, targets, pad_token_id: int):
    """CE against precomputed targets (the global next-token shift); returns
    (sum, count) over non-pad targets, f32."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None].long())[..., 0]
    mask = (targets != pad_token_id).float()
    return (nll * mask).sum(), mask.sum()


def lm_loss(logits, input_ids, pad_token_id: int):
    """Next-token cross entropy over non-pad targets; returns (sum, count)."""
    return lm_loss_with_targets(logits[:, :-1], input_ids[:, 1:], pad_token_id)


def _chunk_loss(hidden, head_w, targets, pad_token_id):
    return lm_loss_with_targets(hidden.float() @ head_w.float(), targets, pad_token_id)


def lm_chunked_loss_with_targets(hidden, head_w, targets, pad_token_id: int,
                                 chunk_size: int = 512):
    """CE without materializing the (B, L, V) logits.

    Runs the head and the loss over sequence chunks, each under activation
    checkpointing, so a chunk's logits exist only while that chunk is
    computed, in the forward and again in the backward: peak memory is
    O(B * chunk * V), not O(B * L * V).  L is padded to a chunk multiple
    with pad targets, which count (0, 0).  Returns (sum, count) like
    :func:`lm_loss_with_targets`."""
    b, l, _ = hidden.shape
    chunk_size = min(chunk_size, l)
    if l % chunk_size:
        extra = (l + chunk_size - 1) // chunk_size * chunk_size - l
        hidden = F.pad(hidden, (0, 0, 0, extra))
        targets = F.pad(targets, (0, extra), value=pad_token_id)
        l += extra
    s = torch.zeros((), dtype=torch.float32, device=hidden.device)
    c = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(0, l, chunk_size):
        cs, cc = checkpoint(_chunk_loss, hidden[:, i:i + chunk_size], head_w,
                            targets[:, i:i + chunk_size], pad_token_id,
                            use_reentrant=False)
        s = s + cs
        c = c + cc
    return s, c
