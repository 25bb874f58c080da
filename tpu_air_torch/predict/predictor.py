"""Predictor — single-process inference (a copy of
``tpu_air/predict/predictor.py``).

Parity surface (SURVEY.md §1-L5): ``ray.train.predictor.Predictor`` with
user-overridable ``_predict_numpy`` (reference predictor.py:74) /
``_predict_pandas`` (Scaling_batch_inference.ipynb:cc-73) and classmethod
``from_checkpoint``.  The key contract: ``predict()`` first applies the
checkpoint's *fitted preprocessor* to the incoming batch ("we get already
tokenized text here because we have the tokenizer as an AIR preprocessor",
reference predictor.py:93), then dispatches to whichever ``_predict_*`` the
subclass implements, converting the batch format as needed.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Type, Union

import numpy as np
import pandas as pd

DataBatchType = Union[pd.DataFrame, np.ndarray, Dict[str, np.ndarray]]


def _batch_to_pandas(data: DataBatchType) -> pd.DataFrame:
    if isinstance(data, pd.DataFrame):
        return data
    if isinstance(data, dict):
        return pd.DataFrame({k: list(v) for k, v in data.items()})
    if isinstance(data, np.ndarray):
        if data.ndim == 1:
            return pd.DataFrame({"__value__": data})
        return pd.DataFrame({"__value__": list(data)})
    raise TypeError(f"unsupported batch type {type(data)}")


def _batch_to_numpy(data: DataBatchType) -> Dict[str, np.ndarray]:
    if isinstance(data, dict):
        return {k: np.asarray(v) for k, v in data.items()}
    if isinstance(data, np.ndarray):
        return {"__value__": data}
    if isinstance(data, pd.DataFrame):
        out = {}
        for col in data.columns:
            vals = data[col].to_numpy()
            # column of fixed-length sequences (e.g. input_ids lists) → 2-D
            if len(vals) and isinstance(vals[0], (list, tuple, np.ndarray)):
                out[col] = np.stack([np.asarray(v) for v in vals])
            else:
                out[col] = vals
        return out
    raise TypeError(f"unsupported batch type {type(data)}")


class PredictorNotSerializableException(RuntimeError):
    pass


class Predictor:
    """Base class.  Subclasses implement ``from_checkpoint`` and one of
    ``_predict_numpy`` / ``_predict_pandas``."""

    def __init__(self, preprocessor=None):
        self._preprocessor = preprocessor

    @classmethod
    def from_checkpoint(cls, checkpoint, **kwargs) -> "Predictor":
        raise NotImplementedError

    # -- preprocessor plumbing ---------------------------------------------
    def get_preprocessor(self):
        return self._preprocessor

    def set_preprocessor(self, preprocessor) -> None:
        self._preprocessor = preprocessor

    # -- the public entry point --------------------------------------------
    def predict(self, data: DataBatchType, **kwargs) -> DataBatchType:
        if self._preprocessor is not None:
            data = self._preprocessor.transform_batch(data)
        has_pandas = type(self)._predict_pandas is not Predictor._predict_pandas
        has_numpy = type(self)._predict_numpy is not Predictor._predict_numpy
        if has_pandas:
            return self._predict_pandas(_batch_to_pandas(data), **kwargs)
        if has_numpy:
            return self._predict_numpy(_batch_to_numpy(data), **kwargs)
        raise NotImplementedError(
            f"{type(self).__name__} implements neither _predict_pandas nor _predict_numpy"
        )

    # -- subclass surface ---------------------------------------------------
    def _predict_pandas(self, data: pd.DataFrame, **kwargs) -> pd.DataFrame:
        raise NotImplementedError

    def _predict_numpy(self, data: Dict[str, np.ndarray], **kwargs) -> DataBatchType:
        raise NotImplementedError

    def __repr__(self):
        return f"{type(self).__name__}(preprocessor={self._preprocessor!r})"
