"""Dataset constructors of the port, copied from ``tpu_air/data/io.py``:
``from_items``, ``from_pandas``, ``from_numpy``, ``from_arrow`` and
``from_huggingface`` (which needs the ``datasets`` package and refuses
without it).  The file readers (``read_parquet``, ``read_csv``,
``read_json``) and ``range`` are not copied.
"""

from __future__ import annotations

import builtins
from typing import Any, List, Union

import numpy as np
import pandas as pd

from tpu_air_torch.core import put

from . import block as B
from .dataset import Dataset

_DEFAULT_PARALLELISM = 8


def df_chunks(df: pd.DataFrame, nb: int):
    """Split a DataFrame into nb nearly-equal row slices."""
    n = len(df)
    nb = max(1, nb)
    bounds = [round(i * n / nb) for i in builtins.range(nb + 1)]
    return [
        df.iloc[bounds[i] : bounds[i + 1]].reset_index(drop=True)
        for i in builtins.range(nb)
    ]


def _split_df(df: pd.DataFrame, parallelism: int) -> Dataset:
    nb = max(1, min(parallelism, len(df)) or 1)
    parts = df_chunks(df, nb) if len(df) else [df]
    return Dataset([put(B.block_from_pandas(p)) for p in parts])


def from_items(items: List[Any], parallelism: int = _DEFAULT_PARALLELISM) -> Dataset:
    """List of dicts → columns; list of arbitrary objects → column "item"
    (ray.data.from_items parity)."""
    if items and isinstance(items[0], dict):
        df = pd.DataFrame(items)
    else:
        df = pd.DataFrame({B.VALUE_COLUMN: list(items)})
    return _split_df(df, parallelism)


def from_pandas(dfs: Union[pd.DataFrame, List[pd.DataFrame]]) -> Dataset:
    if isinstance(dfs, pd.DataFrame):
        return Dataset([put(B.block_from_pandas(dfs))])
    return Dataset([put(B.block_from_pandas(df)) for df in dfs])


def from_numpy(arrs: Union[np.ndarray, List[np.ndarray]], column: str = "data") -> Dataset:
    if isinstance(arrs, np.ndarray):
        arrs = [arrs]
    return Dataset(
        [put(B.block_from_pandas(pd.DataFrame({column: list(a)}))) for a in arrs]
    )


def from_arrow(tables) -> Dataset:
    if not isinstance(tables, list):
        tables = [tables]
    return Dataset([put(t) for t in tables])


def from_huggingface(dataset):
    """Convert a HuggingFace ``datasets.Dataset`` (or DatasetDict) into the
    port's Dataset(s)."""
    try:
        import datasets as hf_datasets
    except ImportError as e:  # pragma: no cover
        raise ImportError("from_huggingface requires the 'datasets' package") from e

    if isinstance(dataset, hf_datasets.DatasetDict):
        return {k: from_huggingface(v) for k, v in dataset.items()}
    df = dataset.to_pandas()
    return _split_df(df, _DEFAULT_PARALLELISM)
