"""Typed training configs, copied from ``tpu_air/train/config.py`` (the port
imports nothing of ``tpu_air``): ``ScalingConfig``, ``CheckpointConfig``,
``FailureConfig`` and ``RunConfig``."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional


@dataclass
class ScalingConfig:
    """How many devices a run uses.

    ``num_workers`` is the data-parallel degree: that many worker processes,
    on the CPU (``gloo``) or one card each (``nccl``, rank r on ``cuda:r``);
    1 trains in the calling process.  ``use_gpu`` picks the device when the
    trainer is given none (``False``: the CPU) and must agree with it when
    it is.  ``num_chips_per_worker`` is 1: a worker over several cards needs
    tensor parallelism.  ``model_parallel`` is the tensor-parallel and
    ``sequence_parallel`` the sequence-parallel degree inside each worker;
    the trainers raise for either above 1 and name the ROADMAP item that
    ports it.  ``total_chips`` is the lease a Tune trial holds.  The JAX
    package's ``use_tpu``, ``topology`` and ``resources_per_worker`` are
    left out: nothing in the port reads them.
    """

    num_workers: int = 1
    use_gpu: Optional[bool] = None
    num_chips_per_worker: int = 1
    model_parallel: Optional[int] = None
    sequence_parallel: Optional[int] = None

    def __post_init__(self):
        if self.num_workers < 1:
            raise ValueError("num_workers must be >= 1")
        if self.num_chips_per_worker != 1:
            raise NotImplementedError(
                f"num_chips_per_worker={self.num_chips_per_worker}: a worker over several "
                "cards needs tensor parallelism, not ported yet (ROADMAP Queue 1 item 9)")
        # validate BEFORE the `or 1` defaulting: an explicit 0 must raise
        if self.model_parallel is not None and self.model_parallel < 1:
            raise ValueError("model_parallel must be >= 1")
        if self.sequence_parallel is not None and self.sequence_parallel < 1:
            raise ValueError("sequence_parallel must be >= 1")
        self.model_parallel = self.model_parallel or 1
        self.sequence_parallel = self.sequence_parallel or 1

    @property
    def total_chips(self) -> int:
        """The cards a trial leases: ``num_workers x num_chips_per_worker``,
        or 0 with ``use_gpu=False``."""
        return 0 if self.use_gpu is False else self.num_workers * self.num_chips_per_worker


@dataclass
class CheckpointConfig:
    """Score-based checkpoint retention: keep ``num_to_keep`` checkpoints,
    ranked by ``checkpoint_score_attribute`` (most recent when unset).
    ``publish_weights_to`` (the live-serving handoff) waits for the port's
    live-weight plane (ROADMAP Queue 1 item 6b); a session given it raises."""

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
