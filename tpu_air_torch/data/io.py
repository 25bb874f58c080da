"""Dataset constructors and readers of the port, copied from
``tpu_air/data/io.py``: ``from_items``, ``from_pandas``, ``from_numpy``,
``from_arrow``, ``from_huggingface`` (which needs the ``datasets``
package and refuses without it), ``range`` and the file readers
``read_parquet`` (W8's entry, Introduction…ipynb:cc-9; needs ``pyarrow``),
``read_csv`` and ``read_json``.  A reader takes a file, a directory (its
files of the reader's suffix, in name order) or a list of either; an
``s3://`` or ``gs://`` path is handed to pyarrow's filesystem layer.
"""

from __future__ import annotations

import builtins
import glob as _glob
import os
from typing import Any, List, Optional, Union

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


def range(n: int, parallelism: int = _DEFAULT_PARALLELISM) -> Dataset:  # noqa: A001
    return _split_df(pd.DataFrame({"id": np.arange(n)}), parallelism)


def _expand_paths(paths: Union[str, List[str]], suffix: str) -> List[str]:
    if isinstance(paths, str):
        paths = [paths]
    out: List[str] = []
    for p in paths:
        if p.startswith(("s3://", "gs://")):
            out.append(p)  # handed to pyarrow's filesystem layer
        elif os.path.isdir(p):
            out.extend(sorted(_glob.glob(os.path.join(p, f"*{suffix}"))))
        else:
            out.append(p)
    return out


def read_parquet(
    paths: Union[str, List[str]],
    columns: Optional[List[str]] = None,
    parallelism: int = _DEFAULT_PARALLELISM,
) -> Dataset:
    """Parquet reader over local or object-store paths: a block a file,
    repartitioned into ``parallelism`` blocks when there are fewer files
    and enough rows."""
    try:
        import pyarrow.parquet as pq
    except ImportError as e:
        raise ImportError("read_parquet requires the 'pyarrow' package "
                          "(read_csv and read_json do not)") from e

    files = _expand_paths(paths, ".parquet")
    refs = []
    for f in files:
        table = pq.read_table(f, columns=columns)
        refs.append(put(table))
    ds = Dataset(refs)
    if len(files) < parallelism:
        total = ds.count()
        if total >= parallelism:
            ds = ds.repartition(parallelism)
    return ds


def read_csv(paths: Union[str, List[str]], parallelism: int = _DEFAULT_PARALLELISM,
             **pandas_kwargs) -> Dataset:
    files = _expand_paths(paths, ".csv")
    dfs = [pd.read_csv(f, **pandas_kwargs) for f in files]
    if len(dfs) == 1:
        return _split_df(dfs[0], parallelism)
    return from_pandas(dfs)


def read_json(paths: Union[str, List[str]], parallelism: int = _DEFAULT_PARALLELISM,
              **pandas_kwargs) -> Dataset:
    files = _expand_paths(paths, ".json")
    dfs = [pd.read_json(f, **pandas_kwargs) for f in files]
    if len(dfs) == 1:
        return _split_df(dfs[0], parallelism)
    return from_pandas(dfs)
