"""tpu_air_torch.train — the Trainer API (counterpart of tpu_air.train):
FLAN-T5 fine-tuning and the long-context LM trainer on the card, the
function trainer, the host-side GBDT trainer and the session API."""

from . import session
from .checkpoint import Checkpoint
from .config import CheckpointConfig, FailureConfig, RunConfig, ScalingConfig
from .gbdt_trainer import GBDTTrainer, XGBoostTrainer
from .lm_trainer import LMTrainer, lm_train_loop
from .result import Result
from .session import StopTrial, get_dataset_shard, get_session, report
from .t5_trainer import T5Trainer, TrainingArguments, t5_train_loop
from .trainer import BaseTrainer, TorchTrainer

__all__ = [
    "BaseTrainer",
    "Checkpoint",
    "CheckpointConfig",
    "FailureConfig",
    "GBDTTrainer",
    "LMTrainer",
    "Result",
    "RunConfig",
    "ScalingConfig",
    "StopTrial",
    "T5Trainer",
    "TorchTrainer",
    "TrainingArguments",
    "XGBoostTrainer",
    "get_dataset_shard",
    "get_session",
    "lm_train_loop",
    "report",
    "session",
    "t5_train_loop",
]
