"""PyTorch long-context causal LM, the counterpart of the non-decode path of
``tpu_air/models/lm/modeling.py``.

Architecture: pre-RMSNorm, RoPE attention (interleaved pairs), SwiGLU MLP,
tied embeddings.  Attention is causal flash attention through the port's
kernels by device: the forward and both backward kernels on a CUDA tensor,
their plain versions on a CPU tensor.  The model is applied
deterministically (no dropout), as every training path of the JAX package
applies it.

Precision as in Flax: parameters stay f32; each dense layer casts its input
and weight to ``config.dtype`` per call (``nn.Dense(dtype=...)``), RMSNorm
and RoPE compute in f32 and cast back, and the logits and the loss are f32.

Module names follow the Flax tree (``embedding``, ``layers.<i>.attn.q``,
``layers.<i>.mlp_norm`` ...), so
:func:`tpu_air_torch.models.lm.convert.params_from_jax` is a rename and a
transpose.  The KV-cache, paged and per-row decode paths wait for the
LM-generate slice.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from tpu_air_torch.device import DeviceLike, resolve_device
from tpu_air_torch.models.layers import Dense
from tpu_air_torch.ops.flash_attention import flash_attention

from .config import LMConfig

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


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

    def forward(self, x, positions):
        cfg = self.config
        b, l, _ = x.shape
        h, d = cfg.n_heads, cfg.head_dim

        def heads(t):                                    # (b, h, l, d) view
            return t.view(b, l, h, d).transpose(1, 2)

        q = rope(heads(self.q(x)), positions, cfg.rope_theta)
        k = rope(heads(self.k(x)), positions, cfg.rope_theta)
        o = flash_attention(q, k, heads(self.v(x)), scale=1.0 / (d ** 0.5), causal=True)
        return self.o(o.transpose(1, 2).reshape(b, l, h * d))


class SwiGLU(nn.Module):
    def __init__(self, config: LMConfig):
        super().__init__()
        dt = torch_dtype(config.dtype)
        self.gate = Dense(config.d_model, config.d_ff, dt)
        self.up = Dense(config.d_model, config.d_ff, dt)
        self.down = Dense(config.d_ff, config.d_model, dt)

    def forward(self, x):
        return self.down(F.silu(self.gate(x)) * self.up(x))


class Block(nn.Module):
    def __init__(self, config: LMConfig):
        super().__init__()
        dt = torch_dtype(config.dtype)
        self.attn_norm = RMSNorm(config.d_model, config.rmsnorm_eps, dt)
        self.attn = CausalSelfAttention(config)
        self.mlp_norm = RMSNorm(config.d_model, config.rmsnorm_eps, dt)
        self.mlp = SwiGLU(config)

    def forward(self, x, positions):
        x = x + self.attn(self.attn_norm(x), positions)
        return x + self.mlp(self.mlp_norm(x))


class CausalLM(nn.Module):
    """``model(input_ids, positions=None) -> logits`` (f32).

    Built on ``device`` (``cuda:0`` by default; raises without a GPU unless
    ``device="cpu"``) with f32 parameters; they are placeholders until
    loaded or set by :meth:`init_weights`.  ``positions`` (B, L) defaults
    to 0..L-1.  ``return_hidden=True`` returns the final-norm hidden states
    instead of the logits, for :func:`lm_chunked_loss_with_targets`."""

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
                return_hidden: bool = False, decode: bool = False):
        cfg = self.config
        if decode:
            raise NotImplementedError(
                "CausalLM decode (KV cache) waits for the port's LM-generate slice")
        b, l = input_ids.shape
        if l > cfg.max_seq_len:
            raise ValueError(f"sequence length {l} exceeds max_seq_len {cfg.max_seq_len}")
        if positions is None:
            positions = torch.arange(l, device=input_ids.device).expand(b, l)
        x = self.embedding[input_ids].to(torch_dtype(cfg.dtype))
        for layer in self.layers:
            x = layer(x, positions)
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
