"""tpu_air_torch.parallel — work across devices: the one-card LM step, data
parallelism over worker processes, ring attention's sequence groups, and
device meshes with the parameter partitioning rules (``mesh.py``,
``sharding.py``) that the sharded engine places its shards by."""
