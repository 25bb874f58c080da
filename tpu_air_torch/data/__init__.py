"""tpu_air_torch.data — the port's datasets over its object store's blocks,
and its preprocessors (copied from ``tpu_air.data``)."""

from . import preprocessors
from .dataset import ActorPoolStrategy, Dataset, GroupedData
from .io import from_arrow, from_huggingface, from_items, from_numpy, from_pandas
from .preprocessors import BatchMapper, MinMaxScaler, Preprocessor

__all__ = [
    "ActorPoolStrategy",
    "BatchMapper",
    "Dataset",
    "GroupedData",
    "MinMaxScaler",
    "Preprocessor",
    "from_arrow",
    "from_huggingface",
    "from_items",
    "from_numpy",
    "from_pandas",
    "preprocessors",
]
