"""tpu_air_torch.control — the port's client of its C++ GCS control plane
(``tpu_air_torch/_native/gcs_server.cpp``), copied from ``tpu_air.control``:
cluster membership, heartbeats and failure detection, the actor and object
directories, a metadata KV."""

from .client import GcsClient, HeartbeatThread, ensure_gcs_binary, start_gcs

__all__ = ["GcsClient", "HeartbeatThread", "ensure_gcs_binary", "start_gcs"]
