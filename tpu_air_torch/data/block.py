"""Block format for the port's data layer, copied from
``tpu_air/data/block.py``.

The reference's Ray Data represents a Dataset as a list of Arrow-backed
blocks in the object store (SURVEY.md §1-L2: "distributed datasets as lists
of Arrow-backed blocks"; "Backed by PyArrow", Introduction…ipynb:cc-3).  We
keep that: the canonical block is a ``pyarrow.Table``; when rows hold values
Arrow can't type (PIL images, raw tensors with object dtype), the block falls
back to a ``pandas.DataFrame`` with object columns — mirroring Ray's
simple-block fallback.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Union

import numpy as np
import pandas as pd

try:
    import pyarrow as pa
except ImportError:  # pragma: no cover
    pa = None

Block = Union["pa.Table", pd.DataFrame]

#: Column name used when items are not dicts (ray.data.from_items parity).
VALUE_COLUMN = "item"


def block_from_rows(rows: Sequence[Dict[str, Any]]) -> Block:
    df = pd.DataFrame(list(rows))
    return block_from_pandas(df)


def block_from_pandas(df: pd.DataFrame) -> Block:
    if pa is not None:
        try:
            return pa.Table.from_pandas(df, preserve_index=False)
        except (pa.ArrowInvalid, pa.ArrowNotImplementedError, pa.ArrowTypeError,
                ValueError, TypeError):
            pass
    return df.reset_index(drop=True)


def block_to_pandas(block: Block) -> pd.DataFrame:
    if pa is not None and isinstance(block, pa.Table):
        return block.to_pandas()
    return block


def block_to_numpy(block: Block) -> Dict[str, np.ndarray]:
    df = block_to_pandas(block)
    out = {}
    for col in df.columns:
        vals = df[col].to_numpy()
        if vals.dtype == object and len(vals) and isinstance(vals[0], np.ndarray):
            try:
                vals = np.stack(vals)
            except ValueError:
                pass
        out[col] = vals
    return out


def block_num_rows(block: Block) -> int:
    if pa is not None and isinstance(block, pa.Table):
        return block.num_rows
    return len(block)


def block_columns(block: Block) -> List[str]:
    if pa is not None and isinstance(block, pa.Table):
        return list(block.column_names)
    return list(block.columns)


def block_slice(block: Block, start: int, stop: int) -> Block:
    if pa is not None and isinstance(block, pa.Table):
        return block.slice(start, stop - start)
    return block.iloc[start:stop].reset_index(drop=True)


def concat_blocks(blocks: Sequence[Block]) -> Block:
    blocks = [b for b in blocks if block_num_rows(b) > 0] or list(blocks[:1])
    if pa is not None and all(isinstance(b, pa.Table) for b in blocks):
        try:
            return pa.concat_tables(blocks, promote_options="default")
        except (pa.ArrowInvalid, TypeError):
            pass
    return pd.concat(
        [block_to_pandas(b) for b in blocks], ignore_index=True
    )


def block_schema(block: Block):
    if pa is not None and isinstance(block, pa.Table):
        return block.schema
    return list(zip(block.columns, block.dtypes))


def to_batch_format(block: Block, batch_format: str):
    """Convert a block to the user-facing batch format of ``map_batches``
    (``batch_format="pandas"`` at Model_finetuning…ipynb:cc-27)."""
    if batch_format in ("pandas", "default"):
        return block_to_pandas(block)
    if batch_format == "numpy":
        return block_to_numpy(block)
    if batch_format == "pyarrow":
        if pa is not None and isinstance(block, pa.Table):
            return block
        return pa.Table.from_pandas(block_to_pandas(block), preserve_index=False)
    if batch_format == "native":
        return block
    raise ValueError(f"unknown batch_format: {batch_format!r}")


def from_batch(batch) -> Block:
    """Normalize a user-returned batch back into a block."""
    if pa is not None and isinstance(batch, pa.Table):
        return batch
    if isinstance(batch, pd.DataFrame):
        return block_from_pandas(batch)
    if isinstance(batch, dict):
        cols = {}
        for k, v in batch.items():
            arr = np.asarray(v)
            if arr.ndim > 1:
                cols[k] = list(arr)  # keep multi-dim arrays as object cells
            else:
                cols[k] = v
        return block_from_pandas(pd.DataFrame(cols))
    if isinstance(batch, (list, tuple)):
        if batch and isinstance(batch[0], dict):
            return block_from_rows(batch)
        return block_from_pandas(pd.DataFrame({VALUE_COLUMN: list(batch)}))
    raise TypeError(
        f"map_batches fn must return DataFrame / dict-of-arrays / Table, got {type(batch)}"
    )
