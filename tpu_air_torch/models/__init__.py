"""tpu_air_torch.models — PyTorch model families: ``t5``, ``lm`` and
``segformer``."""

from . import segformer

__all__ = ["segformer"]
