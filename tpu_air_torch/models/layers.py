"""Layers the port's models share: f32 parameters that compute in the
model's type, cast per call as Flax's ``nn.Dense(dtype=...)``,
``nn.Conv(dtype=...)`` and ``nn.Embed(dtype=...)`` do.  A weight that
already has the compute type (a model cast once at load) is used as it is,
with no copy.  Also the compute types the port takes and Flax's dropout."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

# the types the port's kernels take
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name) -> torch.dtype:
    if isinstance(name, torch.dtype):
        return name
    if name not in _DTYPES:
        raise ValueError(f"unsupported dtype {name!r}")
    return _DTYPES[name]


def dropout_mask(shape, rate: float, generator: Optional[torch.Generator],
                 device) -> torch.Tensor:
    """The keep mask :func:`dropout` draws for a tensor of ``shape``: a
    tensor-parallel layer draws it at the logical shape and slices it, so
    its masks are the single-device layer's."""
    return torch.rand(shape, generator=generator, device=device) < 1.0 - rate


def apply_dropout(x, keep: torch.Tensor, rate: float):
    """``x`` through a keep mask: kept elements scaled by 1 / (1 - rate)."""
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


def dropout(x, rate: float, generator: Optional[torch.Generator]):
    """Flax's ``nn.Dropout``: keep each element with probability 1 - rate
    and scale it by 1 / (1 - rate), in x's type.  The mask comes from
    ``generator`` (on x's device), so a seed fixes every mask of a step."""
    return apply_dropout(x, dropout_mask(x.shape, rate, generator, x.device), rate)


def _cast(t: Optional[torch.Tensor], dt: torch.dtype) -> Optional[torch.Tensor]:
    return None if t is None else t.to(dt)


class Dense(nn.Linear):
    """Linear layer with an f32 weight (and, with ``bias=True``, an f32
    bias); input, weight and bias are cast to the compute type per call, as
    Flax's ``nn.Dense(dtype=...)`` does.  Bias-free by default (T5, the LM)."""

    def __init__(self, in_features: int, out_features: int, dtype: torch.dtype,
                 bias: bool = False):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), _cast(self.bias, dt))


class Conv(nn.Conv2d):
    """Flax's ``nn.Conv(dtype=...)`` on NHWC tensors: an f32 OIHW weight
    (Flax's HWIO kernel transposed) and bias, cast with the input to the
    compute type per call.  The input is handed to the convolution as a
    channels-last NCHW view and the output comes back NHWC, so no layout
    copy is made around it.  ``padding`` is symmetric (Flax's
    ``[(p, p), (p, p)]``; 0 is ``"VALID"``)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 dtype: torch.dtype, stride: int = 1, padding: int = 0, groups: int = 1,
                 bias: bool = True):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride,
                         padding=padding, groups=groups, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        y = F.conv2d(x.to(dt).permute(0, 3, 1, 2), self.weight.to(dt), _cast(self.bias, dt),
                     self.stride, self.padding, self.dilation, self.groups)
        return y.permute(0, 2, 3, 1)


class Embed(nn.Embedding):
    """Token embedding with an f32 table; the looked-up rows are cast to the
    compute type (Flax's ``nn.Embed(dtype=...)`` casts the table, then takes:
    the same values)."""

    def __init__(self, num: int, dim: int, dtype: torch.dtype):
        super().__init__(num, dim)
        self.compute_dtype = dtype

    def forward(self, ids):
        return F.embedding(ids, self.weight).to(self.compute_dtype)
