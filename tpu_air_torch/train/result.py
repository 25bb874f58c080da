"""Result of a training run (a copy of ``tpu_air/train/result.py``):
``.checkpoint``, ``.best_checkpoints``, ``.metrics``, ``.error``."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from .checkpoint import Checkpoint


@dataclass
class Result:
    metrics: Dict[str, Any] = field(default_factory=dict)
    checkpoint: Optional[Checkpoint] = None
    error: Optional[Exception] = None
    path: Optional[str] = None
    metrics_history: List[Dict[str, Any]] = field(default_factory=list)
    best_checkpoints: List[Tuple[Checkpoint, Dict[str, Any]]] = field(default_factory=list)
    config: Dict[str, Any] = field(default_factory=dict)

    @property
    def metrics_dataframe(self):
        import pandas as pd

        return pd.DataFrame(self.metrics_history)

    def __repr__(self) -> str:
        keys = {k: v for k, v in self.metrics.items() if not k.startswith("_")}
        return f"Result(metrics={keys}, error={self.error!r}, checkpoint={self.checkpoint})"
