"""tpu_air_torch.serve — online inference over replica actors + HTTP proxy,
the counterpart of ``tpu_air.serve``.

Parity surface (SURVEY.md §1-L5 "Online (serving)", §3.5):
``serve.run(PredictorDeployment.options(name=..., num_replicas=2,
route_prefix="/rayair").bind(PredictorCls, checkpoint,
http_adapter=pandas_read_json))`` and client ``requests.post`` to
``http://localhost:8000/<route>`` (Introduction_to_Ray_AI_Runtime.ipynb:cc-70-74).

Each replica is an actor of the port's runtime; one that leases the card
(``num_chips=1``) builds its model on ``cuda:<leased id>``.  The proxy is a
threaded HTTP server in the driver, routing least-loaded across replicas,
and touches no CUDA.  The live-weight plane (``serve/weights.py``): a
versioned ``WeightStore`` and the canary ``WeightsController`` that
``attach_weights`` binds to a route of ``EngineDeployment``.
"""

from .admission import AdmissionController, AdmissionPolicy, AdmissionShedError
from .autoscaler import Autoscaler, AutoscalerConfig
from .deployment import (
    Application,
    Deployment,
    DeploymentHandle,
    NoLiveReplicasError,
    ReplicaGoneError,
    deployment,
)
from .engine_deployment import EngineDeployment
from .http_adapters import json_request, pandas_read_json
from .predictor_deployment import PredictorDeployment
from .proxy import rollout, run, shutdown, status
from .weights import (
    GateFailedError,
    TornPublishError,
    WeightsController,
    WeightsIntegrityError,
    WeightStore,
    attach_weights,
    compute_probe,
)


__all__ = [
    "AdmissionController",
    "AdmissionPolicy",
    "AdmissionShedError",
    "Application",
    "Autoscaler",
    "AutoscalerConfig",
    "Deployment",
    "DeploymentHandle",
    "EngineDeployment",
    "GateFailedError",
    "NoLiveReplicasError",
    "PredictorDeployment",
    "ReplicaGoneError",
    "TornPublishError",
    "WeightStore",
    "WeightsController",
    "WeightsIntegrityError",
    "attach_weights",
    "compute_probe",
    "deployment",
    "json_request",
    "pandas_read_json",
    "rollout",
    "run",
    "shutdown",
    "status",
]
