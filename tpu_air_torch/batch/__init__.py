"""tpu_air_torch.batch — the elastic offline batch-inference lane, the
counterpart of ``tpu_air.batch``.  Public surface:

* :class:`BatchJob` / :class:`BatchJobConfig` — run a resumable epoch of
  a dataset through a deployed serve route at ``best_effort`` priority.
* :mod:`tpu_air_torch.batch.reader` — deterministic sharded readers
  (:func:`shard_plan`, :class:`ShardedReader`, :class:`ShardCursor`).
* :func:`jobs_stats` — the observability snapshot behind ``/-/stats`` →
  ``batch``, the dashboard's ``/api/batch``, and ``tpu_air_batch_*``.
"""

from tpu_air_torch.batch.job import (
    BatchJob,
    BatchJobConfig,
    BatchJobKilled,
    clear_registry,
    get_job,
    jobs_stats,
    register_job,
)
from tpu_air_torch.batch.reader import ShardCursor, ShardedReader, shard_plan

__all__ = [
    "BatchJob",
    "BatchJobConfig",
    "BatchJobKilled",
    "ShardCursor",
    "ShardedReader",
    "shard_plan",
    "clear_registry",
    "get_job",
    "jobs_stats",
    "register_job",
]
