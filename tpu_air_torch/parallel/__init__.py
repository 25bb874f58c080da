"""tpu_air_torch.parallel — work across devices: the one-card LM step, data
parallelism over worker processes, ring attention's sequence groups, and
device meshes with the parameter partitioning rules (``mesh.py``,
``sharding.py``) that the sharded engine places its shards by.

The package exports the JAX package's names: the host collectives
(``collectives.py``) and the mesh helpers (``mesh.py``)."""

from tpu_air_torch._exports import lazy_exports

_EXPORTS = {
    "Barrier": "collectives",
    "allreduce": "collectives",
    "broadcast": "collectives",
    "batch_sharding": "mesh",
    "data_parallel_mesh": "mesh",
    "leased_chip_ids": "mesh",
    "make_mesh": "mesh",
    "replicated_sharding": "mesh",
    "topology": "mesh",
    "visible_devices": "mesh",
}

__getattr__ = lazy_exports(__name__, _EXPORTS)

__all__ = sorted(_EXPORTS)
