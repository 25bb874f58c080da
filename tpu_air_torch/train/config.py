"""Typed training configs, copied from ``tpu_air/train/config.py`` (the port
imports nothing of ``tpu_air``): ``ScalingConfig``, ``CheckpointConfig``,
``FailureConfig`` and ``RunConfig``."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional


@dataclass
class ScalingConfig:
    """How many devices a run uses.

    ``num_workers`` is the data-parallel degree; ``model_parallel`` the
    tensor-parallel and ``sequence_parallel`` the sequence-parallel degree
    inside each worker.  The port trains on one card so far: the trainers
    raise for any degree above 1 and name the ROADMAP item that ports it.
    The JAX package's device-placement fields (``use_tpu``, ``use_gpu``,
    ``num_chips_per_worker``, ``topology``, ``resources_per_worker``) are
    left out: nothing in the port reads them yet.
    """

    num_workers: int = 1
    model_parallel: Optional[int] = None
    sequence_parallel: Optional[int] = None

    def __post_init__(self):
        # validate BEFORE the `or 1` defaulting: an explicit 0 must raise
        if self.model_parallel is not None and self.model_parallel < 1:
            raise ValueError("model_parallel must be >= 1")
        if self.sequence_parallel is not None and self.sequence_parallel < 1:
            raise ValueError("sequence_parallel must be >= 1")
        self.model_parallel = self.model_parallel or 1
        self.sequence_parallel = self.sequence_parallel or 1


@dataclass
class CheckpointConfig:
    """Score-based checkpoint retention: keep ``num_to_keep`` checkpoints,
    ranked by ``checkpoint_score_attribute`` (most recent when unset).
    ``publish_weights_to`` (the live-serving handoff) waits for the port's
    serve plane; a session given it raises."""

    num_to_keep: Optional[int] = None
    checkpoint_score_attribute: Optional[str] = None
    checkpoint_score_order: str = "min"
    publish_weights_to: Optional[str] = None

    def __post_init__(self):
        if self.checkpoint_score_order not in ("min", "max"):
            raise ValueError("checkpoint_score_order must be 'min' or 'max'")


@dataclass
class FailureConfig:
    """Retry policy: restart a failed run from its latest checkpoint."""

    max_failures: int = 0


@dataclass
class RunConfig:
    name: Optional[str] = None
    storage_path: Optional[str] = None  # defaults to ~/tpu_air_results
    checkpoint_config: CheckpointConfig = field(default_factory=CheckpointConfig)
    failure_config: FailureConfig = field(default_factory=FailureConfig)
