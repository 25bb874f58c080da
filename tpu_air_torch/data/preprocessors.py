"""Persistent preprocessors, copied from ``tpu_air/data/preprocessors.py``
(``Preprocessor``, ``BatchMapper`` and W8's ``MinMaxScaler``; the port
imports nothing of ``tpu_air``).

The contract: a preprocessor is fitted during training, saved inside the
checkpoint, and applied again to every batch at predict time, so it pickles
with its fitted state.  ``transform`` takes a dataset with ``map_batches``
(the trainers' pandas-backed dataset); ``transform_batch`` one in-memory
batch, a DataFrame or a dict of arrays, where the JAX package's block
helpers become plain pandas.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import pandas as pd

from tpu_air_torch.predict.predictor import _batch_to_numpy, _batch_to_pandas


class Preprocessor:
    """Base class.  Subclasses implement ``_fit(dataset)`` (optional) and
    ``_transform_pandas(df)``."""

    _is_fittable = True

    def __init__(self):
        self._fitted = False

    # -- fitting -----------------------------------------------------------
    def fit(self, dataset) -> "Preprocessor":
        if self._is_fittable:
            self._fit(dataset)
        self._fitted = True
        return self

    def fit_transform(self, dataset):
        return self.fit(dataset).transform(dataset)

    def _fit(self, dataset):  # pragma: no cover - default no-op
        pass

    def check_is_fitted(self) -> bool:
        return self._fitted or not self._is_fittable

    # -- transforming ------------------------------------------------------
    def transform(self, dataset):
        """Apply to a dataset, producing a new dataset."""
        return dataset.map_batches(self._transform_pandas, batch_format="pandas")

    def transform_batch(self, batch):
        """Apply to a single in-memory batch (the predict path)."""
        if isinstance(batch, pd.DataFrame):
            return self._transform_pandas(batch.copy())
        if isinstance(batch, dict):
            return _batch_to_numpy(self._transform_pandas(_batch_to_pandas(batch)))
        return self._transform_pandas(pd.DataFrame(batch))

    def _transform_pandas(self, df: pd.DataFrame) -> pd.DataFrame:
        raise NotImplementedError

    def __repr__(self):
        return f"{type(self).__name__}(fitted={self._fitted})"


class BatchMapper(Preprocessor):
    """Stateless function preprocessor
    (``BatchMapper(preprocess_function, batch_format="pandas", batch_size=4096)``)."""

    _is_fittable = False

    def __init__(self, fn: Callable, batch_format: str = "pandas",
                 batch_size: Optional[int] = 4096):
        super().__init__()
        self.fn = fn
        self.batch_format = batch_format
        self.batch_size = batch_size

    def transform(self, dataset):
        return dataset.map_batches(self.fn, batch_format=self.batch_format,
                                   batch_size=self.batch_size)

    def transform_batch(self, batch):
        if self.batch_format == "pandas" and not isinstance(batch, pd.DataFrame):
            batch = _batch_to_pandas(batch)
        elif self.batch_format == "numpy" and isinstance(batch, pd.DataFrame):
            batch = _batch_to_numpy(batch)
        return self.fn(batch)

    def _transform_pandas(self, df):
        return self.fn(df)


class MinMaxScaler(Preprocessor):
    """Scale columns to [0, 1] by fitted min/max (Introduction…ipynb:cc-20)."""

    def __init__(self, columns: List[str]):
        super().__init__()
        self.columns = columns
        self.stats_: Dict[str, tuple] = {}

    def _fit(self, dataset):
        df = dataset.to_pandas()
        self.stats_ = {
            c: (float(df[c].min()), float(df[c].max())) for c in self.columns
        }

    def _transform_pandas(self, df):
        for c in self.columns:
            lo, hi = self.stats_[c]
            span = hi - lo
            df[c] = 0.0 if span == 0 else (df[c] - lo) / span
        return df
