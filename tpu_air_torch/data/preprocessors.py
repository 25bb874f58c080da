"""Persistent preprocessors, copied from ``tpu_air/data/preprocessors.py``
(``Preprocessor``, ``BatchMapper``, W8's ``MinMaxScaler``, ``StandardScaler``,
``PowerTransformer``, ``Normalizer`` and ``Chain``; the port imports nothing
of ``tpu_air``).  Each keeps the JAX class's state attributes, so a
preprocessor that the JAX package pickled into a checkpoint loads as the
port's (``train/checkpoint.py::PortUnpickler``).

The contract: a preprocessor is fitted during training, saved inside the
checkpoint, and applied again to every batch at predict time, so it pickles
with its fitted state.  ``transform`` takes a dataset with ``map_batches``
(the trainers' pandas-backed dataset); ``transform_batch`` one in-memory
batch, a DataFrame or a dict of arrays, where the JAX package's block
helpers become plain pandas.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
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


class StandardScaler(Preprocessor):
    """Scale columns to zero mean and unit (sample) standard deviation."""

    def __init__(self, columns: List[str]):
        super().__init__()
        self.columns = columns
        self.stats_: Dict[str, tuple] = {}

    def _fit(self, dataset):
        df = dataset.to_pandas()
        self.stats_ = {
            c: (float(df[c].mean()), float(df[c].std() or 1.0)) for c in self.columns
        }

    def _transform_pandas(self, df):
        for c in self.columns:
            mu, sd = self.stats_[c]
            df[c] = (df[c] - mu) / (sd if sd else 1.0)
        return df


class PowerTransformer(Preprocessor):
    """Box-Cox / Yeo-Johnson style power transform with explicit power
    (``PowerTransformer(columns, power)``, Introduction…ipynb:cc-25)."""

    _is_fittable = False

    def __init__(self, columns: List[str], power: float, method: str = "yeo-johnson"):
        super().__init__()
        self.columns = columns
        self.power = power
        self.method = method

    def _yeo_johnson(self, x: np.ndarray) -> np.ndarray:
        lam = self.power
        out = np.empty_like(x, dtype=np.float64)
        pos = x >= 0
        if lam != 0:
            out[pos] = ((x[pos] + 1.0) ** lam - 1.0) / lam
        else:
            out[pos] = np.log1p(x[pos])
        if lam != 2:
            out[~pos] = -(((-x[~pos] + 1.0) ** (2.0 - lam)) - 1.0) / (2.0 - lam)
        else:
            out[~pos] = -np.log1p(-x[~pos])
        return out

    def _transform_pandas(self, df):
        for c in self.columns:
            x = df[c].to_numpy(dtype=np.float64)
            if self.method == "yeo-johnson":
                df[c] = self._yeo_johnson(x)
            else:  # box-cox (positive inputs)
                lam = self.power
                df[c] = np.log(x) if lam == 0 else (x**lam - 1.0) / lam
        return df


class Normalizer(Preprocessor):
    """Row-wise vector normalization (named at Introduction…ipynb:cc-27)."""

    _is_fittable = False

    def __init__(self, columns: List[str], norm: str = "l2"):
        super().__init__()
        self.columns = columns
        self.norm = norm

    def _transform_pandas(self, df):
        mat = df[self.columns].to_numpy(dtype=np.float64)
        if self.norm == "l2":
            denom = np.sqrt((mat**2).sum(axis=1))
        elif self.norm == "l1":
            denom = np.abs(mat).sum(axis=1)
        elif self.norm == "max":
            denom = np.abs(mat).max(axis=1)
        else:
            raise ValueError(f"unknown norm {self.norm!r}")
        denom[denom == 0] = 1.0
        df[self.columns] = mat / denom[:, None]
        return df


class Chain(Preprocessor):
    """Sequential composition of preprocessors."""

    def __init__(self, *preprocessors: Preprocessor):
        super().__init__()
        self.preprocessors = list(preprocessors)

    def _fit(self, dataset):
        for p in self.preprocessors:
            dataset = p.fit_transform(dataset)

    def fit_transform(self, dataset):
        for p in self.preprocessors:
            dataset = p.fit_transform(dataset)
        self._fitted = True
        return dataset

    def transform(self, dataset):
        for p in self.preprocessors:
            dataset = p.transform(dataset)
        return dataset

    def transform_batch(self, batch):
        for p in self.preprocessors:
            batch = p.transform_batch(batch)
        return batch
