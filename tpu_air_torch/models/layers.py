"""Layers the port's models share: f32 parameters that compute in the
model's type, cast per call as Flax's ``nn.Dense(dtype=...)`` and
``nn.Embed(dtype=...)`` do.  A weight that already has the compute type
(a model cast once at load) is used as it is, with no copy."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class Dense(nn.Linear):
    """Bias-free linear layer with an f32 weight; input and weight are cast to
    the compute type per call, as Flax's ``nn.Dense(dtype=...)`` does."""

    def __init__(self, in_features: int, out_features: int, dtype: torch.dtype):
        super().__init__(in_features, out_features, bias=False)
        self.compute_dtype = dtype

    def forward(self, x):
        return F.linear(x.to(self.compute_dtype), self.weight.to(self.compute_dtype))


class Embed(nn.Embedding):
    """Token embedding with an f32 table; the looked-up rows are cast to the
    compute type (Flax's ``nn.Embed(dtype=...)`` casts the table, then takes:
    the same values)."""

    def __init__(self, num: int, dim: int, dtype: torch.dtype):
        super().__init__(num, dim)
        self.compute_dtype = dtype

    def forward(self, ids):
        return F.embedding(ids, self.weight).to(self.compute_dtype)
