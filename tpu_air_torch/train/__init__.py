"""tpu_air_torch.train — the Trainer API on the card (counterpart of
tpu_air.train; the long-context LM trainer so far)."""

from .checkpoint import Checkpoint
from .config import CheckpointConfig, FailureConfig, RunConfig, ScalingConfig
from .lm_trainer import LMTrainer, lm_train_loop
from .result import Result
from .t5_trainer import TrainingArguments

__all__ = [
    "Checkpoint",
    "CheckpointConfig",
    "FailureConfig",
    "LMTrainer",
    "Result",
    "RunConfig",
    "ScalingConfig",
    "TrainingArguments",
    "lm_train_loop",
]
