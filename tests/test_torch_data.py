"""The port's data layer (``tpu_air_torch.data``) on the CPU: the patterns of
tests/test_data.py that the copied modules serve, over a runtime of the
port's own (``init(num_cpus=4, num_chips=2)``)."""

import numpy as np
import pandas as pd
import pytest

import tpu_air_torch
from tpu_air_torch import data as tad
from tpu_air_torch.data import ActorPoolStrategy, BatchMapper


@pytest.fixture(scope="module")
def tair():
    tpu_air_torch.init(num_cpus=4, num_chips=2)
    yield tpu_air_torch
    tpu_air_torch.shutdown()


def test_from_items_dicts_and_objects(tair):
    ds = tad.from_items([{"a": i, "b": 2 * i} for i in range(10)])
    assert ds.count() == 10
    assert sorted(ds.columns()) == ["a", "b"]
    assert ds.num_blocks() == 8
    assert tad.from_items(["x", "y", "z"]).take(2) == [{"item": "x"}, {"item": "y"}]


def test_from_pandas_numpy_arrow(tair):
    df = pd.DataFrame({"x": np.arange(6), "y": list("abcdef")})
    assert tad.from_pandas(df).to_pandas().equals(df)
    assert tad.from_pandas([df, df]).count() == 12
    ds = tad.from_numpy(np.arange(12).reshape(4, 3))
    assert [list(r["data"]) for r in ds.take(2)] == [[0, 1, 2], [3, 4, 5]]
    pa = pytest.importorskip("pyarrow")
    assert tad.from_arrow(pa.table({"z": [1, 2, 3]})).to_pandas()["z"].tolist() == [1, 2, 3]


def test_from_huggingface_refuses_without_datasets(tair, monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "datasets", None)     # as where it is absent
    with pytest.raises(ImportError, match="datasets"):
        tad.from_huggingface(object())


def test_map_batches_tasks_and_batch_size(tair):
    ds = tad.from_pandas(pd.DataFrame({"id": np.arange(40)}))

    def tag(df: pd.DataFrame) -> pd.DataFrame:
        return df.assign(id=df["id"] * 2, bs=len(df))

    out = ds.map_batches(tag, batch_size=16, batch_format="pandas").to_pandas()
    assert out["id"].tolist() == [2 * i for i in range(40)]
    assert out["bs"].max() <= 16


def test_map_batches_numpy_format(tair):
    ds = tad.from_items([{"v": float(i)} for i in range(10)])
    out = ds.map_batches(lambda b: {"v": b["v"] + 1.0}, batch_format="numpy")
    assert sorted(r["v"] for r in out.take_all()) == [float(i + 1) for i in range(10)]


def test_map_batches_actor_pool_strategy(tair):
    """The BatchPredictor architecture: a callable class constructed once
    per pool actor, with a chip lease each."""
    class AddOffset:
        def __init__(self, offset):
            import os

            self.offset = offset
            self.lease = os.environ.get("TPU_AIR_CHIP_IDS")

        def __call__(self, df):
            return df.assign(id=df["id"] + self.offset, lease=self.lease)

    ds = tad.from_items([{"id": i} for i in range(20)], parallelism=4)
    out = ds.map_batches(AddOffset, compute=ActorPoolStrategy(size=2, num_chips=1),
                         fn_constructor_args=(100,), batch_format="pandas").to_pandas()
    assert sorted(out["id"]) == [100 + i for i in range(20)]
    assert set(out["lease"]) == {"0", "1"}


def test_train_test_split_and_split(tair):
    ds = tad.from_items([{"id": i} for i in range(100)])
    tr, te = ds.train_test_split(0.2, shuffle=True, seed=57)
    assert tr.count() == 80 and te.count() == 20
    assert sorted([r["id"] for r in tr.take_all()] + [r["id"] for r in te.take_all()]) \
        == list(range(100))
    tr2, te2 = ds.train_test_split(0.25)
    assert [r["id"] for r in te2.take_all()] == list(range(75, 100))
    shards = ds.split(4)
    assert [s.count() for s in shards] == [25, 25, 25, 25]


def test_batch_mapper_transforms_a_dataset(tair):
    ds = tad.from_items([{"x": i} for i in range(10)])
    bm = BatchMapper(lambda df: df.assign(y=df["x"] * 3), batch_format="pandas")
    out = bm.transform(ds).to_pandas()
    assert out["y"].tolist() == [3 * i for i in range(10)]
    assert bm.transform_batch(pd.DataFrame({"x": [1, 2]}))["y"].tolist() == [3, 6]
