"""tpu_air_torch.train — the Trainer API on the card (counterpart of
tpu_air.train): FLAN-T5 fine-tuning and the long-context LM trainer."""

from .checkpoint import Checkpoint
from .config import CheckpointConfig, FailureConfig, RunConfig, ScalingConfig
from .lm_trainer import LMTrainer, lm_train_loop
from .result import Result
from .t5_trainer import T5Trainer, TrainingArguments, t5_train_loop

__all__ = [
    "Checkpoint",
    "CheckpointConfig",
    "FailureConfig",
    "LMTrainer",
    "Result",
    "RunConfig",
    "ScalingConfig",
    "T5Trainer",
    "TrainingArguments",
    "lm_train_loop",
    "t5_train_loop",
]
