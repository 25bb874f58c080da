"""tpu_air_torch.predict — offline inference (counterpart of tpu_air.predict):
``Predictor``, ``T5GenerativePredictor``, ``LMGenerativePredictor``,
``SemanticSegmentationPredictor``,
``TorchPredictor``, the GBDT predictors and ``BatchPredictor`` over the
port's Dataset and actor pool."""

from tpu_air_torch.predict.batch_predictor import BatchPredictor
from tpu_air_torch.predict.predictor import Predictor
from tpu_air_torch.predict.predictors import (
    GBDTPredictor,
    LMGenerativePredictor,
    SemanticSegmentationPredictor,
    SklearnPredictor,
    T5GenerativePredictor,
    TorchPredictor,
    XGBoostPredictor,
)

__all__ = ["BatchPredictor", "GBDTPredictor", "LMGenerativePredictor", "Predictor",
           "SemanticSegmentationPredictor", "SklearnPredictor", "T5GenerativePredictor", "TorchPredictor", "XGBoostPredictor"]
