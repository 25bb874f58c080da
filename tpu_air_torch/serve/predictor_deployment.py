"""PredictorDeployment — serve any Predictor from a Checkpoint over HTTP.
Copied from ``tpu_air/serve/predictor_deployment.py``; it serves the port's
predictors.

Parity: ``serve.run(PredictorDeployment.options(name="XGBoostService",
num_replicas=2, route_prefix="/rayair").bind(XGBoostPredictor, best_ckpt,
http_adapter=pandas_read_json))`` (Introduction_to_Ray_AI_Runtime.ipynb:cc-71).

Each replica instantiates ``predictor_cls.from_checkpoint(checkpoint)`` once
(a model's weights land on the replica's leased card, ``cuda:<id>``, or
where ``device=`` among ``from_checkpoint_kwargs`` says), then serves
``adapter(body) → predictor.predict → jsonable`` per request.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

from .deployment import Deployment
from .http_adapters import pandas_read_json


class _PredictorServer:
    def __init__(
        self,
        predictor_cls,
        checkpoint,
        http_adapter: Optional[Callable[[bytes], Any]] = None,
        predict_kwargs: Optional[dict] = None,
        **from_checkpoint_kwargs,
    ):
        self._predictor = predictor_cls.from_checkpoint(
            checkpoint, **from_checkpoint_kwargs
        )
        self._http_adapter = http_adapter or pandas_read_json
        self._predict_kwargs = predict_kwargs or {}

    def __call__(self, data):
        out = self._predictor.predict(data, **self._predict_kwargs)
        return out


PredictorDeployment = Deployment(
    func_or_class=_PredictorServer,
    name="PredictorDeployment",
    num_replicas=1,
)
