"""Python client for the port's C++ GCS control-plane daemon
(``tpu_air_torch/_native/gcs_server.cpp``), copied from
``tpu_air/control/client.py``.

Framing: 4-byte big-endian length + protobuf (``gcs.proto``, wire-compatible
with the JAX package's, so this client talks to either package's daemon).
One socket per client, guarded by a lock — control traffic is
request/reply and low-rate.  The daemon is built at first use into
``tpu_air_torch/_build/`` (``tpu_air_torch._native.build_gcs``).
"""

from __future__ import annotations

import socket
import struct
import subprocess
import threading
import time
from typing import Dict, List, Optional, Tuple

pb = None  # gcs_pb2, resolved lazily (importing this module needs no protobuf)


def _ensure_pb():
    """Resolve the generated protobuf bindings (``gcs_pb2.py``, committed
    beside this module) — lazily, never at module import."""
    global pb
    if pb is None:
        from . import gcs_pb2 as _pb

        pb = _pb
    return pb


def ensure_gcs_binary() -> str:
    """Path of the daemon, built first if needed; raises RuntimeError where
    the protobuf toolchain is missing."""
    from tpu_air_torch import _native

    return _native.build_gcs()


def start_gcs(port: int = 0, dead_after_ms: int = 10000,
              timeout: float = 30.0) -> Tuple[subprocess.Popen, int]:
    """Launch the daemon; returns (process, bound_port)."""
    import select

    _ensure_pb()
    proc = subprocess.Popen(
        [ensure_gcs_binary(), str(port), str(dead_after_ms)],
        stdout=subprocess.PIPE, text=True,
    )
    deadline = time.monotonic() + timeout
    line = ""
    while time.monotonic() < deadline:
        # select before readline: a daemon wedged pre-printf must not turn
        # the timeout contract into an indefinite block
        ready, _, _ = select.select([proc.stdout], [], [],
                                    max(deadline - time.monotonic(), 0.0))
        if not ready:
            break
        line = proc.stdout.readline()
        if line.startswith("LISTENING"):
            return proc, int(line.split()[1])
        if proc.poll() is not None:
            break
    proc.kill()
    raise RuntimeError(f"gcs daemon failed to start: {line!r}")


class GcsClient:
    def __init__(self, address: str):
        _ensure_pb()
        host, port = address.rsplit(":", 1)
        self._sock = socket.create_connection((host, int(port)), timeout=30)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._lock = threading.Lock()
        self._seq = 0

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass

    def _call(self, **op) -> pb.Reply:
        with self._lock:
            self._seq += 1
            req = pb.Request(seq=self._seq, **op)
            blob = req.SerializeToString()
            self._sock.sendall(struct.pack(">I", len(blob)) + blob)
            (n,) = struct.unpack(">I", self._recv_exact(4))
            rep = pb.Reply()
            rep.ParseFromString(self._recv_exact(n))
        if not rep.ok:
            raise RuntimeError(f"gcs: {rep.error}")
        return rep

    def _recv_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self._sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("gcs connection closed")
            buf += chunk
        return buf

    # -- membership / failure detection -------------------------------------
    def register_node(self, node_id: str, address: str = "", num_chips: int = 0):
        self._call(register_node=pb.NodeInfo(
            node_id=node_id, address=address, num_chips=num_chips))

    def heartbeat(self, node_id: str):
        self._call(heartbeat=node_id)

    def list_nodes(self) -> List[Dict]:
        rep = self._call(list_nodes=True)
        return [
            {"node_id": n.node_id, "address": n.address, "num_chips": n.num_chips,
             "alive": n.alive}
            for n in rep.nodes
        ]

    # -- actor directory -----------------------------------------------------
    def register_actor(self, actor_id: str, node_id: str, name: str = "",
                       chip_ids: Optional[List[int]] = None):
        self._call(register_actor=pb.ActorInfo(
            actor_id=actor_id, name=name, node_id=node_id,
            chip_ids=chip_ids or []))

    def lookup_actor(self, name_or_id: str) -> Optional[Dict]:
        rep = self._call(lookup_actor=name_or_id)
        if not rep.found:
            return None
        a = rep.actor
        return {"actor_id": a.actor_id, "name": a.name, "node_id": a.node_id,
                "chip_ids": list(a.chip_ids), "dead": a.dead}

    def mark_actor_dead(self, actor_id: str):
        self._call(mark_actor_dead=actor_id)

    # -- object directory ----------------------------------------------------
    def publish_object(self, object_id: str, node_id: str, size_bytes: int = 0):
        self._call(publish_object=pb.ObjectLocation(
            object_id=object_id, node_ids=[node_id], size_bytes=size_bytes))

    def locate_object(self, object_id: str) -> Optional[Dict]:
        rep = self._call(locate_object=object_id)
        if not rep.found:
            return None
        return {"object_id": rep.location.object_id,
                "node_ids": list(rep.location.node_ids),
                "size_bytes": rep.location.size_bytes}

    # -- metadata KV ---------------------------------------------------------
    def kv_put(self, key: str, value: bytes):
        self._call(kv_put=pb.KVPut(key=key, value=value))

    def kv_get(self, key: str) -> Optional[bytes]:
        rep = self._call(kv_get=key)
        return rep.value if rep.found else None

    def kv_del(self, key: str):
        self._call(kv_del=key)


class HeartbeatThread(threading.Thread):
    """Periodic node heartbeat (daemon thread; its own client/socket).

    Resilient: a transient RPC failure or a GCS restart must not silently
    stop heartbeats forever — the thread reconnects and re-registers
    ("unknown node" after a daemon restart) until stop() is called."""

    def __init__(self, address: str, node_id: str, interval: float = 1.0,
                 node_address: str = "", num_chips: int = 0):
        super().__init__(daemon=True)
        self.address = address
        self.node_id = node_id
        self.node_address = node_address
        self.num_chips = num_chips
        self.interval = interval
        # NB: must not be named _stop — that shadows Thread._stop and
        # makes threading._after_fork() blow up in forked children
        self._stop_evt = threading.Event()

    def run(self):
        client = None
        while not self._stop_evt.wait(self.interval):
            try:
                if client is None:
                    client = GcsClient(self.address)
                client.heartbeat(self.node_id)
            except RuntimeError:
                # daemon forgot us (restart) — re-register and carry on
                try:
                    client.register_node(self.node_id, self.node_address,
                                         self.num_chips)
                except (ConnectionError, RuntimeError, OSError):
                    pass
            except (ConnectionError, OSError):
                if client is not None:
                    client.close()
                client = None  # reconnect next tick
        if client is not None:
            client.close()

    def stop(self):
        self._stop_evt.set()
