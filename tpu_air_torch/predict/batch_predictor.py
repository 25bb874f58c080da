"""BatchPredictor — distributed batch inference over a Dataset, copied from
``tpu_air/predict/batch_predictor.py``.

``BatchPredictor.from_checkpoint(checkpoint, predictor_cls,
**predictor_kwargs)`` and ``.predict(dataset, num_gpus_per_worker=...,
batch_size=..., **predict_kwargs)`` fan the dataset's blocks across an actor
pool of the port's runtime.  Each scoring actor leases its cards
(``num_gpus_per_worker``, or its alias ``num_chips_per_worker``), builds the
predictor once with ``predictor_cls.from_checkpoint(checkpoint,
**predictor_kwargs)`` (so ``dtype`` and ``device`` pass through; with no
``device`` the model lands on ``cuda:<first leased id>``), and maps whole
blocks; the pool is released when ``predict`` returns.
"""

from __future__ import annotations

from typing import Any, List, Optional, Type

import pandas as pd

from tpu_air_torch.data.dataset import ActorPoolStrategy, Dataset
from tpu_air_torch.predict.predictor import Predictor


class _ScoringWrapper:
    """Callable class instantiated once per pool actor; holds the predictor."""

    def __init__(self, checkpoint_payload, predictor_cls, predictor_kwargs,
                 feature_columns, keep_columns, predict_kwargs):
        from tpu_air_torch.train.checkpoint import Checkpoint

        if isinstance(checkpoint_payload, str):
            ckpt = Checkpoint.from_directory(checkpoint_payload)
        elif isinstance(checkpoint_payload, Checkpoint):
            ckpt = checkpoint_payload
        else:
            ckpt = Checkpoint.from_dict(checkpoint_payload)
        self.predictor: Predictor = predictor_cls.from_checkpoint(ckpt, **predictor_kwargs)
        self.feature_columns = feature_columns
        self.keep_columns = keep_columns
        self.predict_kwargs = predict_kwargs

    def __call__(self, batch: pd.DataFrame) -> pd.DataFrame:
        inputs = batch
        if self.feature_columns:
            cols = [c for c in self.feature_columns if c in batch.columns]
            inputs = batch[cols] if cols else batch
        kwargs = dict(self.predict_kwargs)
        # predictors that filter internally get the column list too
        if self.feature_columns and type(self.predictor)._predict_numpy is not Predictor._predict_numpy:
            kwargs.setdefault("feature_columns", self.feature_columns)
        out = self.predictor.predict(inputs, **kwargs)
        if not isinstance(out, pd.DataFrame):
            out = pd.DataFrame(out)
        if self.keep_columns:
            out = out.reset_index(drop=True)
            for c in self.keep_columns:
                if c in batch.columns:
                    out[c] = batch[c].reset_index(drop=True)
        return out


class BatchPredictor:
    def __init__(self, checkpoint, predictor_cls: Type[Predictor], **predictor_kwargs):
        self._checkpoint = checkpoint
        self._predictor_cls = predictor_cls
        self._predictor_kwargs = predictor_kwargs

    @classmethod
    def from_checkpoint(cls, checkpoint, predictor_cls: Type[Predictor],
                        **predictor_kwargs) -> "BatchPredictor":
        return cls(checkpoint, predictor_cls, **predictor_kwargs)

    def get_preprocessor(self):
        return self._checkpoint.get_preprocessor()

    def _checkpoint_payload(self):
        """Ship directory checkpoints by path (cheap; workers re-open), dict
        checkpoints by value."""
        path = self._checkpoint.path
        return path if path else self._checkpoint.to_dict()

    def predict(
        self,
        data: Dataset,
        *,
        feature_columns: Optional[List[str]] = None,
        keep_columns: Optional[List[str]] = None,
        batch_size: int = 4096,
        min_scoring_workers: int = 1,
        max_scoring_workers: Optional[int] = None,
        num_chips_per_worker: float = 0,
        num_gpus_per_worker: float = 0,  # reference-API alias → chips
        separate_preprocessor: bool = False,  # reference-API, accepted and unused
        **predict_kwargs: Any,
    ) -> Dataset:
        chips = num_chips_per_worker or num_gpus_per_worker
        strategy = ActorPoolStrategy(
            min_size=min_scoring_workers,
            max_size=max_scoring_workers or max(data.num_blocks(), 1),
            num_chips=chips,
        )
        return data.map_batches(
            _ScoringWrapper,
            batch_size=batch_size,
            batch_format="pandas",
            compute=strategy,
            fn_constructor_args=(
                self._checkpoint_payload(),
                self._predictor_cls,
                self._predictor_kwargs,
                feature_columns,
                keep_columns,
                predict_kwargs,
            ),
        )

    def __repr__(self):
        return (f"BatchPredictor(checkpoint={self._checkpoint!r}, "
                f"predictor_cls={self._predictor_cls.__name__})")
