"""PyTorch SegFormer, the counterpart of ``tpu_air/models/segformer/modeling.py``.

The hierarchical Mix-Transformer encoder and the all-MLP decode head
(SegFormer, Xie et al. 2021), with the JAX package's module names and
boundary: ``pixel_values`` come in NHWC, and the semantic model returns
NHWC logits at 1/4 of the input resolution.

- Tensors stay NHWC between layers.  A convolution (:class:`Conv`) sees its
  input as a channels-last NCHW view and gives NHWC back, with no layout
  copy; a resize does the same.
- Parameters are f32 and compute in ``config.dtype``, cast per call as the
  Flax layers cast them.
- Attention over the flattened (H*W) sequence, with the spatial-reduction
  conv on keys and values: q·kᵀ/√d, softmax in f32 cast back to the compute
  type, then ·v, as two ``torch.matmul`` (the JAX package computes it with
  two einsums, outside any kernel).
- The decode head's :class:`BatchNorm` is Flax's ``nn.BatchNorm(momentum=0.9,
  epsilon=1e-5)``: the running variance takes the *biased* batch variance
  (``torch.nn.BatchNorm2d`` takes the unbiased one), and in a group of
  workers (and over a worker's in-process replicas) the batch moments are
  those of the global batch
  (:func:`tpu_air_torch.parallel.distributed.cross_replica_sum`), as the JAX
  package computes them over its sharded batch.
- ``train()`` mode is Flax's ``deterministic=False``: dropout, drop-path and
  the batch norm's batch statistics, with masks drawn from the
  ``generator`` passed to ``forward``.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tpu_air_torch.device import DeviceLike, resolve_device
from tpu_air_torch.models.layers import Conv, Dense, dropout, torch_dtype

from .config import SegformerConfig


def _resize_bilinear(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Bilinear resize of NHWC ``x``, half-pixel centres (the model only
    upsamples, where Flax's ``jax.image.resize`` and this agree)."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(h, w), mode="bilinear",
                      align_corners=False)
    return y.permute(0, 2, 3, 1)


class LayerNorm(nn.LayerNorm):
    """Flax's ``nn.LayerNorm(dtype=...)``: statistics and scale in f32, the
    output in the compute type."""

    def __init__(self, dim: int, eps: float, dtype: torch.dtype):
        super().__init__(dim, eps=eps)
        self.compute_dtype = dtype

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias,
                            self.eps).to(self.compute_dtype)


class BatchNorm(nn.Module):
    """Flax's ``nn.BatchNorm`` over the last axis of an NHWC tensor.

    In ``train()`` mode it normalizes with the batch's mean and biased
    variance, E[x²] - E[x]² floored at 0 (Flax's fast variance), summed over
    every worker of the group, and moves the running stats by
    ``momentum * old + (1 - momentum) * batch`` with that same biased
    variance; in ``eval()`` mode it normalizes with the running stats.
    Statistics in f32, the output in the compute type."""

    def __init__(self, num_features: int, dtype: torch.dtype, momentum: float = 0.9,
                 eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.momentum = momentum
        self.eps = eps
        self.compute_dtype = dtype

    def forward(self, x):
        from tpu_air_torch.parallel.distributed import cross_replica_sum, local_replica

        xf = x.float()
        c = xf.shape[-1]
        if self.training:
            flat = xf.reshape(-1, c)
            count = torch.full((1,), float(flat.shape[0]), device=x.device)
            sums = cross_replica_sum(torch.cat([flat.sum(0), flat.square().sum(0), count]))
            n = sums[-1]
            mean = sums[:c] / n
            var = torch.clamp(sums[c:2 * c] / n - mean.square(), min=0.0)
            # every in-process replica sees the same global moments: the
            # first one moves the running stats
            if local_replica() == 0:
                with torch.no_grad():
                    self.running_mean.mul_(self.momentum).add_(mean.detach(),
                                                               alpha=1.0 - self.momentum)
                    self.running_var.mul_(self.momentum).add_(var.detach(),
                                                              alpha=1.0 - self.momentum)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((xf - mean) * mul + self.bias).to(self.compute_dtype)


class DropPath(nn.Module):
    """Per-sample stochastic depth (the SegFormer block regularizer)."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x, generator: Optional[torch.Generator] = None):
        if not self.training or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        shape = (x.shape[0],) + (1,) * (x.ndim - 1)
        mask = torch.rand(shape, generator=generator, device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def _dropout(module: nn.Module, x, rate: float, generator):
    return dropout(x, rate, generator) if module.training and rate > 0.0 else x


class OverlapPatchEmbed(nn.Module):
    """Overlapping patch embedding: strided conv + LayerNorm."""

    def __init__(self, config: SegformerConfig, in_channels: int, patch_size: int,
                 stride: int, hidden_size: int):
        super().__init__()
        dt = torch_dtype(config.dtype)
        self.proj = Conv(in_channels, hidden_size, patch_size, dt, stride=stride,
                         padding=patch_size // 2)
        self.layer_norm = LayerNorm(hidden_size, config.layer_norm_eps, dt)

    def forward(self, x):
        return self.layer_norm(self.proj(x))


class EfficientSelfAttention(nn.Module):
    """MHA over the flattened spatial sequence with sequence-reduction convs.

    The sr conv shrinks K/V spatially by `sr_ratio`, so attention cost is
    O(N * N/sr^2) — this is what makes stage-1 (N = (H/4)(W/4)) tractable.
    """

    def __init__(self, config: SegformerConfig, hidden_size: int, num_heads: int,
                 sr_ratio: int):
        super().__init__()
        dt = torch_dtype(config.dtype)
        self.config = config
        self.num_heads = num_heads
        self.sr_ratio = sr_ratio
        self.query = Dense(hidden_size, hidden_size, dt, bias=True)
        if sr_ratio > 1:
            self.sr = Conv(hidden_size, hidden_size, sr_ratio, dt, stride=sr_ratio)
            self.sr_norm = LayerNorm(hidden_size, config.layer_norm_eps, dt)
        self.key = Dense(hidden_size, hidden_size, dt, bias=True)
        self.value = Dense(hidden_size, hidden_size, dt, bias=True)
        self.out = Dense(hidden_size, hidden_size, dt, bias=True)

    def forward(self, x, generator=None):
        cfg = self.config
        b, h, w, c = x.shape
        heads, head_dim = self.num_heads, c // self.num_heads
        q = self.query(x.reshape(b, h * w, c))
        kv = self.sr_norm(self.sr(x)) if self.sr_ratio > 1 else x
        kv = kv.reshape(b, -1, c)
        k, v = self.key(kv), self.value(kv)
        q = q.reshape(b, h * w, heads, head_dim).transpose(1, 2)
        k = k.reshape(b, -1, heads, head_dim).transpose(1, 2)
        v = v.reshape(b, -1, heads, head_dim).transpose(1, 2)
        scores = torch.matmul(q, k.transpose(-1, -2)) / (head_dim ** 0.5)
        probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
        probs = _dropout(self, probs, cfg.attention_probs_dropout_prob, generator)
        out = torch.matmul(probs, v).transpose(1, 2).reshape(b, h * w, c)
        out = _dropout(self, self.out(out), cfg.hidden_dropout_prob, generator)
        return out.reshape(b, h, w, c)


class MixFFN(nn.Module):
    """Mix-FFN: dense → 3x3 depthwise conv (positional signal) → GELU → dense."""

    def __init__(self, config: SegformerConfig, hidden_size: int, mlp_ratio: int):
        super().__init__()
        dt = torch_dtype(config.dtype)
        inner = hidden_size * mlp_ratio
        self.rate = config.hidden_dropout_prob
        self.dense1 = Dense(hidden_size, inner, dt, bias=True)
        self.dwconv = Conv(inner, inner, 3, dt, padding=1, groups=inner)
        self.dense2 = Dense(inner, hidden_size, dt, bias=True)

    def forward(self, x, generator=None):
        x = F.gelu(self.dwconv(self.dense1(x)))
        x = _dropout(self, x, self.rate, generator)
        return _dropout(self, self.dense2(x), self.rate, generator)


class Block(nn.Module):
    def __init__(self, config: SegformerConfig, hidden_size: int, num_heads: int,
                 sr_ratio: int, mlp_ratio: int, drop_path: float):
        super().__init__()
        dt = torch_dtype(config.dtype)
        self.layer_norm_1 = LayerNorm(hidden_size, config.layer_norm_eps, dt)
        self.attention = EfficientSelfAttention(config, hidden_size, num_heads, sr_ratio)
        self.drop_path_attn = DropPath(drop_path)
        self.layer_norm_2 = LayerNorm(hidden_size, config.layer_norm_eps, dt)
        self.mlp = MixFFN(config, hidden_size, mlp_ratio)
        self.drop_path_mlp = DropPath(drop_path)

    def forward(self, x, generator=None):
        x = x + self.drop_path_attn(self.attention(self.layer_norm_1(x), generator), generator)
        return x + self.drop_path_mlp(self.mlp(self.layer_norm_2(x), generator), generator)


class SegformerEncoder(nn.Module):
    """4-stage hierarchical encoder; returns all stage feature maps (NHWC)."""

    def __init__(self, config: SegformerConfig):
        super().__init__()
        cfg = self.config = config
        dt = torch_dtype(cfg.dtype)
        # linearly-increasing stochastic-depth schedule over total depth
        total = sum(cfg.depths)
        dp_rates = [cfg.drop_path_rate * i / max(total - 1, 1) for i in range(total)]
        cursor, channels = 0, cfg.num_channels
        for s in range(cfg.num_encoder_blocks):
            self.add_module(f"patch_embed_{s}", OverlapPatchEmbed(
                cfg, channels, cfg.patch_sizes[s], cfg.strides[s], cfg.hidden_sizes[s]))
            for d in range(cfg.depths[s]):
                self.add_module(f"block_{s}_{d}", Block(
                    cfg, cfg.hidden_sizes[s], cfg.num_attention_heads[s], cfg.sr_ratios[s],
                    cfg.mlp_ratios[s], dp_rates[cursor]))
                cursor += 1
            self.add_module(f"stage_norm_{s}",
                            LayerNorm(cfg.hidden_sizes[s], cfg.layer_norm_eps, dt))
            channels = cfg.hidden_sizes[s]

    def forward(self, pixel_values, generator=None) -> List[torch.Tensor]:
        cfg = self.config
        x = pixel_values
        features: List[torch.Tensor] = []
        for s in range(cfg.num_encoder_blocks):
            x = getattr(self, f"patch_embed_{s}")(x)
            for d in range(cfg.depths[s]):
                x = getattr(self, f"block_{s}_{d}")(x, generator)
            x = getattr(self, f"stage_norm_{s}")(x)
            features.append(x)
        return features


class SegformerDecodeHead(nn.Module):
    """All-MLP decode head: per-stage linear → upsample to 1/4 res → fuse."""

    def __init__(self, config: SegformerConfig):
        super().__init__()
        cfg = self.config = config
        dt = torch_dtype(cfg.dtype)
        hid = cfg.decoder_hidden_size
        for i in range(cfg.num_encoder_blocks):
            self.add_module(f"linear_c_{i}", Dense(cfg.hidden_sizes[i], hid, dt, bias=True))
        self.linear_fuse = Conv(hid * cfg.num_encoder_blocks, hid, 1, dt, bias=False)
        self.batch_norm = BatchNorm(hid, dt)
        self.classifier = Conv(hid, cfg.num_labels, 1, dt)

    def forward(self, features: List[torch.Tensor], generator=None) -> torch.Tensor:
        h0, w0 = features[0].shape[1], features[0].shape[2]
        projected = []
        for i, f in enumerate(features):
            p = getattr(self, f"linear_c_{i}")(f)
            if i > 0:
                p = _resize_bilinear(p, h0, w0)
            projected.append(p)
        # fuse deepest-first (matches the published head's concat order)
        x = self.linear_fuse(torch.cat(projected[::-1], dim=-1))
        x = F.relu(self.batch_norm(x))
        x = _dropout(self, x, self.config.classifier_dropout_prob, generator)
        return self.classifier(x)  # (B, H/4, W/4, num_labels)


def _init_segformer(model: nn.Module, seed: int) -> None:
    """HF's ``SegformerPreTrainedModel._init_weights`` from a numpy seed:
    every linear and conv weight normal with std ``initializer_range``
    (0.02), their biases 0, norm scales 1 and shifts 0; a batch norm's
    running stats 0 and 1.  The same seed gives the same weights on any
    device."""
    rng = np.random.default_rng(seed)
    for name, p in model.named_parameters():
        module = model.get_submodule(name.rsplit(".", 1)[0])
        if name.endswith(".bias"):
            p.zero_()
        elif isinstance(module, (LayerNorm, BatchNorm)):
            p.fill_(1.0)
        else:
            w = rng.standard_normal(tuple(p.shape), dtype=np.float32) * np.float32(0.02)
            p.copy_(torch.from_numpy(w))
    for name, buf in model.named_buffers():
        buf.fill_(1.0 if name.endswith("running_var") else 0.0)


class _Model(nn.Module):
    """Built on ``device`` (``cuda:0`` by default; raises without a GPU
    unless ``device="cpu"``) with f32 weights that compute in
    ``config.dtype``; the weights are placeholders until loaded or set by
    :meth:`init_weights`.  Built in ``eval()`` mode."""

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    @torch.no_grad()
    def init_weights(self, seed: int = 0):
        _init_segformer(self, seed)
        return self


class SegformerForSemanticSegmentation(_Model):
    """Encoder + decode head.  Input NHWC; logits at 1/4 input resolution."""

    def __init__(self, config: SegformerConfig, device: DeviceLike = None):
        super().__init__()
        self.config = config
        with torch.device(resolve_device(device)):
            self.encoder = SegformerEncoder(config)
            self.decode_head = SegformerDecodeHead(config)
        self.eval()

    def forward(self, pixel_values, generator: Optional[torch.Generator] = None):
        return self.decode_head(self.encoder(pixel_values, generator), generator)

    def features(self, pixel_values, generator=None) -> List[torch.Tensor]:
        return self.encoder(pixel_values, generator)


class SegformerForImageClassification(_Model):
    """MiT backbone + mean-pool + linear head (the `nvidia/mit-b0` form)."""

    def __init__(self, config: SegformerConfig, num_classes: int = 1000,
                 device: DeviceLike = None):
        super().__init__()
        self.config = config
        with torch.device(resolve_device(device)):
            self.encoder = SegformerEncoder(config)
            self.classifier = Dense(config.hidden_sizes[-1], num_classes,
                                    torch_dtype(config.dtype), bias=True)
        self.eval()

    def forward(self, pixel_values, generator: Optional[torch.Generator] = None):
        x = self.encoder(pixel_values, generator)[-1]
        return self.classifier(x.reshape(x.shape[0], -1, x.shape[-1]).mean(1))


def segmentation_nll(logits: torch.Tensor, labels: torch.Tensor,
                     ignore_index: int = 255) -> Tuple[torch.Tensor, torch.Tensor]:
    """(summed NLL over the valid pixels, their count) of
    :func:`segmentation_loss`: a worker of a group divides its sum by the
    count of the whole batch."""
    h, w = labels.shape[1], labels.shape[2]
    logits = _resize_bilinear(logits.float(), h, w)
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    return torch.where(valid, nll, torch.zeros_like(nll)).sum(), valid.sum()


def segmentation_loss(logits: torch.Tensor, labels: torch.Tensor,
                      ignore_index: int = 255) -> torch.Tensor:
    """Cross-entropy vs full-resolution integer label maps.

    Upsamples the 1/4-resolution logits to the label size (the published
    model's training objective) and masks `ignore_index` pixels.
    logits: (B, h, w, L) NHWC; labels: (B, H, W) int.
    """
    total, count = segmentation_nll(logits, labels, ignore_index)
    return total / torch.clamp(count, min=1)
