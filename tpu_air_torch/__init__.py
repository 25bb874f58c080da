"""tpu_air_torch — the PyTorch/CUDA port of tpu_air for NVIDIA Hopper.

Imports torch, numpy, the standard library, pandas (datasets) and
cloudpickle (the object plane, a checkpoint's preprocessor); never jax or
tpu_air.  The runtime's API sits at the top level, as in tpu_air::

    import tpu_air_torch

    tpu_air_torch.init()            # leases the CUDA devices
    ref = tpu_air_torch.put(x)

    @tpu_air_torch.remote
    def f(x): ...
    tpu_air_torch.get([f.remote(ref) for _ in range(8)])
    tpu_air_torch.shutdown()

Subpackages mirror tpu_air's layout (``core``, ``data``, ``models.t5``,
``models.lm``, ``models.segformer``, ``ops``, ``parallel``, ``predict``,
``train``, ``tune``) and are imported on first use (``tpu_air_torch.tune``)
or explicitly; importing this package builds nothing.
"""

from tpu_air_torch._exports import lazy_exports
from tpu_air_torch.core import (
    ActorDiedError,
    ActorHandle,
    ActorPool,
    ObjectRef,
    RemoteError,
    TpuAirError,
    get,
    init,
    is_initialized,
    kill,
    nodes,
    put,
    remote,
    shutdown,
    wait,
)

__version__ = "0.1.0"

__getattr__ = lazy_exports(__name__, {},
                           ("data", "models", "ops", "parallel", "predict", "train", "tune"))


__all__ = [
    "ActorDiedError",
    "ActorHandle",
    "ActorPool",
    "ObjectRef",
    "RemoteError",
    "TpuAirError",
    "__version__",
    "get",
    "init",
    "is_initialized",
    "kill",
    "nodes",
    "put",
    "remote",
    "shutdown",
    "wait",
]
