"""tpu_air_torch.data — the port's datasets over its object store's blocks,
its readers and its preprocessors (copied from ``tpu_air.data``)."""

from . import preprocessors
from .dataset import ActorPoolStrategy, Dataset, GroupedData
from .io import (
    from_arrow,
    from_huggingface,
    from_items,
    from_numpy,
    from_pandas,
    range,
    read_csv,
    read_json,
    read_parquet,
)
from .preprocessors import (
    BatchMapper,
    Chain,
    MinMaxScaler,
    Normalizer,
    PowerTransformer,
    Preprocessor,
    StandardScaler,
)

__all__ = [
    "ActorPoolStrategy",
    "BatchMapper",
    "Chain",
    "Dataset",
    "GroupedData",
    "MinMaxScaler",
    "Normalizer",
    "PowerTransformer",
    "Preprocessor",
    "StandardScaler",
    "from_arrow",
    "from_huggingface",
    "from_items",
    "from_numpy",
    "from_pandas",
    "preprocessors",
    "range",
    "read_csv",
    "read_json",
    "read_parquet",
]
