"""tpu_air_torch.predict — offline inference (counterpart of tpu_air.predict):
``Predictor``, ``T5GenerativePredictor``, the GBDT predictors and
``BatchPredictor`` over the port's Dataset and actor pool."""

from tpu_air_torch.predict.batch_predictor import BatchPredictor
from tpu_air_torch.predict.predictor import Predictor
from tpu_air_torch.predict.predictors import (
    GBDTPredictor,
    SklearnPredictor,
    T5GenerativePredictor,
    XGBoostPredictor,
)

__all__ = ["BatchPredictor", "GBDTPredictor", "Predictor", "SklearnPredictor",
           "T5GenerativePredictor", "XGBoostPredictor"]
