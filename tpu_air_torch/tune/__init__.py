"""tpu_air_torch.tune — trial-parallel hyperparameter optimization (L4), the
port's counterpart of ``tpu_air.tune``.

Reference surface (SURVEY.md §1-L4): ``Tuner``, ``TuneConfig``, search-space
primitives (``choice``/``uniform``/``randint``/…), ``ASHAScheduler``,
``ResultGrid``.  Each trial runs in an actor that leases its cards.
"""

from .result_grid import ResultGrid
from .schedulers import ASHAScheduler, FIFOScheduler, TrialScheduler
from .search import (
    choice,
    grid_search,
    loguniform,
    quniform,
    randint,
    sample_from,
    uniform,
)
from .tuner import TuneConfig, Tuner

# reference import spellings: ray.tune.tuner.TuneConfig and
# ray.tune.schedulers.async_hyperband.ASHAScheduler both resolve here
from . import schedulers  # noqa: F401

__all__ = [
    "ASHAScheduler",
    "FIFOScheduler",
    "ResultGrid",
    "TrialScheduler",
    "TuneConfig",
    "Tuner",
    "choice",
    "grid_search",
    "loguniform",
    "quniform",
    "randint",
    "sample_from",
    "uniform",
]
