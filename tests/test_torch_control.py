"""The port's C++ GCS control plane (tpu_air_torch/_native/gcs_server.cpp,
tpu_air_torch/control): the twins of tests/test_control.py on the port —
KV, membership and failure detection, the actor and object directories,
the default ``init()`` path surviving a daemon restart, concurrent
clients — then each package's client against the other's daemon, which
must give the same replies to the same calls."""

import os
import subprocess
import sys
import threading
import time

import pytest

from tpu_air_torch import _native

_gcs_err = _native.gcs_missing()

pytestmark = pytest.mark.skipif(_gcs_err is not None, reason=f"gcs unavailable: {_gcs_err}")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture()
def gcs():
    from tpu_air_torch.control import GcsClient, start_gcs

    proc, port = start_gcs(dead_after_ms=600)
    client = GcsClient(f"127.0.0.1:{port}")
    yield client, f"127.0.0.1:{port}"
    client.close()
    proc.kill()
    proc.wait()


def test_daemon_and_bindings_come_from_the_port(tmp_path):
    """The daemon is built from the port's sources into tpu_air_torch/_build/
    under a name that hashes them, and the committed gcs_pb2.py is what
    protoc makes of the port's gcs.proto now."""
    from tpu_air_torch.control import ensure_gcs_binary

    path = ensure_gcs_binary()
    assert os.path.dirname(path) == _native.BUILD_DIR
    assert os.path.basename(path).startswith("tpu_air_torch_gcs-") and os.access(path, os.X_OK)
    fresh = _native.generate_python_bindings(str(tmp_path))
    committed = os.path.join(ROOT, "tpu_air_torch", "control", "gcs_pb2.py")
    with open(fresh) as a, open(committed) as b:
        assert a.read() == b.read()


def test_kv_roundtrip(gcs):
    client, _ = gcs
    client.kv_put("mesh/topology", b"h100-1")
    assert client.kv_get("mesh/topology") == b"h100-1"
    client.kv_del("mesh/topology")
    assert client.kv_get("mesh/topology") is None


def test_node_membership_and_failure_detection(gcs):
    from tpu_air_torch.control import HeartbeatThread

    client, addr = gcs
    client.register_node("host-0", address="127.0.0.1:9999", num_chips=4)
    client.register_node("host-1", address="127.0.0.1:9998", num_chips=4)
    hb = HeartbeatThread(addr, "host-0", interval=0.1)
    hb.start()
    try:
        time.sleep(0.9)  # host-1 never heartbeats past dead_after=600ms
        nodes = {n["node_id"]: n for n in client.list_nodes()}
    finally:
        hb.stop()
        hb.join(timeout=5)
    assert not hb.is_alive()
    assert nodes["host-0"]["alive"] is True
    assert nodes["host-1"]["alive"] is False, "dead host not detected"
    assert nodes["host-0"]["num_chips"] == 4


def test_actor_directory(gcs):
    client, _ = gcs
    client.register_actor("a-123", node_id="host-0", name="trainer", chip_ids=[0, 1])
    byname = client.lookup_actor("trainer")
    assert byname and byname["actor_id"] == "a-123" and byname["chip_ids"] == [0, 1]
    client.mark_actor_dead("a-123")
    assert client.lookup_actor("trainer") is None  # name released
    byid = client.lookup_actor("a-123")
    assert byid and byid["dead"] is True


def test_object_directory(gcs):
    client, _ = gcs
    assert client.locate_object("obj-1") is None
    client.publish_object("obj-1", "host-0", size_bytes=128)
    client.publish_object("obj-1", "host-1", size_bytes=128)
    loc = client.locate_object("obj-1")
    assert sorted(loc["node_ids"]) == ["host-0", "host-1"]


_DEFAULT_INIT_SCRIPT = """
import time
import tpu_air_torch
from tpu_air_torch.control import GcsClient, ensure_gcs_binary, start_gcs
from tpu_air_torch.core import runtime as rt_mod

if __name__ == "__main__":
    ensure_gcs_binary()   # built: init() launches the daemon synchronously
    tpu_air_torch.init(num_cpus=2, num_chips=8)
    rt = rt_mod.get_runtime()
    assert rt.gcs_address, "default init() did not start the GCS daemon"
    nodes = {n["node_id"]: n for n in tpu_air_torch.nodes()}
    assert nodes["host-0"]["alive"] is True
    assert nodes["host-0"]["num_chips"] == 8

    @tpu_air_torch.remote(num_chips=2)
    class A:
        def ping(self):
            return "pong"

    a = A.options(name="gcs-probe").remote()
    assert tpu_air_torch.get(a.ping.remote()) == "pong"
    client = GcsClient(rt.gcs_address)
    info = client.lookup_actor("gcs-probe")
    assert info is not None and not info["dead"], info
    assert info["node_id"] == "host-0" and info["chip_ids"] == [0, 1], info

    # actor death reaches the directory (checked before the restart: a
    # restarted daemon forgets directory state)
    tpu_air_torch.kill(a)
    deadline = time.time() + 5
    while time.time() < deadline:
        info = client.lookup_actor(a._actor_id)
        if info is not None and info["dead"]:
            break
        time.sleep(0.1)
    assert info is not None and info["dead"], "actor death not in directory"
    client.close()

    # daemon restart on the same port: the liveness machinery recovers
    port = int(rt.gcs_address.rsplit(":", 1)[1])
    rt._gcs_proc.kill()
    rt._gcs_proc.wait()
    assert tpu_air_torch.nodes() == []  # a dead daemon degrades, never raises
    deadline = time.time() + 10
    proc2 = None
    while proc2 is None:
        try:
            proc2, _ = start_gcs(port=port)
        except RuntimeError:
            if time.time() > deadline:
                raise
            time.sleep(0.2)
    rt._gcs_proc = proc2
    deadline = time.time() + 10
    alive = False
    while time.time() < deadline and not alive:
        nodes = {n["node_id"]: n for n in tpu_air_torch.nodes()}
        alive = nodes.get("host-0", {}).get("alive", False)
        time.sleep(0.2)
    assert alive, "heartbeat did not re-register after GCS restart"
    tpu_air_torch.shutdown()
    assert proc2.poll() is not None, "shutdown left the daemon running"
    print("DEFAULT_INIT_GCS_OK")
"""


def test_gcs_on_default_init_path(tmp_path):
    """A port ``init()`` with neither ``TPU_AIR_NO_GCS`` nor
    ``TPU_AIR_COORDINATOR`` runs the control plane: membership through
    ``tpu_air_torch.nodes()``, a leased actor in the directory with its card
    ids and its death marked, and the wiring survives a daemon restart (the
    heartbeat re-registers, the client reconnects).  In a subprocess: the
    session's runtimes stay untouched."""
    script = tmp_path / "default_init.py"
    script.write_text(_DEFAULT_INIT_SCRIPT)
    env = {k: v for k, v in os.environ.items()
           if k not in ("TPU_AIR_NO_GCS", "TPU_AIR_COORDINATOR", "TPU_AIR_GCS")}
    env["PYTHONPATH"] = os.pathsep.join([ROOT, env.get("PYTHONPATH", "")])
    proc = subprocess.run([sys.executable, str(script)], capture_output=True, text=True,
                          timeout=180, env=env, cwd=ROOT)
    assert proc.returncode == 0, f"stdout={proc.stdout}\nstderr={proc.stderr}"
    assert "DEFAULT_INIT_GCS_OK" in proc.stdout


def test_concurrent_clients(gcs):
    from tpu_air_torch.control import GcsClient

    _, addr = gcs
    errs = []

    def worker(i):
        try:
            c = GcsClient(addr)
            for j in range(50):
                c.kv_put(f"k{i}-{j}", bytes([i, j]))
                assert c.kv_get(f"k{i}-{j}") == bytes([i, j])
            c.close()
        except Exception as e:  # noqa: BLE001 — collected, asserted below
            errs.append(e)

    ts = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert not [t for t in ts if t.is_alive()]
    assert not errs, errs


# -- each package's client against the other's daemon ------------------------------


def _script(client) -> list:
    """The same calls, in order, to one daemon; every reply (or error) in a
    list.  Liveness is read well inside the daemon's dead-after window, and
    heartbeat stamps are not part of a reply."""
    out = []

    def call(method, *args, **kwargs):
        try:
            out.append((method, getattr(client, method)(*args, **kwargs)))
        except RuntimeError as e:  # the daemon's refusals ("gcs: unknown node")
            out.append((method, f"error: {e}"))

    call("register_node", "host-0", address="10.0.0.1:6379", num_chips=1)
    call("register_node", "host-1", address="10.0.0.2:6379", num_chips=4)
    call("heartbeat", "host-0")
    call("heartbeat", "host-9")
    call("list_nodes")
    call("register_actor", "a-1", node_id="host-0", name="scorer", chip_ids=[0])
    call("register_actor", "a-2", node_id="host-1", chip_ids=[1, 2, 3])
    call("lookup_actor", "scorer")
    call("lookup_actor", "a-2")
    call("lookup_actor", "missing")
    call("mark_actor_dead", "a-1")
    call("lookup_actor", "scorer")
    call("lookup_actor", "a-1")
    call("publish_object", "obj-1", "host-0", size_bytes=1 << 20)
    call("publish_object", "obj-1", "host-1", size_bytes=1 << 20)
    call("publish_object", "obj-1", "host-0", size_bytes=1 << 20)
    call("locate_object", "obj-1")
    call("locate_object", "obj-2")
    call("kv_put", "lease/0", b"\x00\x01binary\xff")
    call("kv_get", "lease/0")
    call("kv_del", "lease/0")
    call("kv_get", "lease/0")
    return out


def _replies(client_pkg, daemon_pkg) -> list:
    import tpu_air.control as jctl

    import tpu_air_torch.control as tctl

    pkgs = {"jax": jctl, "port": tctl}
    proc, port = pkgs[daemon_pkg].start_gcs(dead_after_ms=60_000)
    try:
        client = pkgs[client_pkg].GcsClient(f"127.0.0.1:{port}")
        try:
            return _script(client)
        finally:
            client.close()
    finally:
        proc.kill()
        proc.wait()


@pytest.mark.parametrize("client_pkg,daemon_pkg", [("jax", "port"), ("port", "jax")])
def test_clients_get_the_same_replies_from_either_daemon(client_pkg, daemon_pkg):
    """The JAX package's ``GcsClient`` against the port's daemon, and the
    port's against the JAX package's: the same calls give the same replies
    as each package's client against its own daemon."""
    crossed = _replies(client_pkg, daemon_pkg)
    assert crossed == _replies(client_pkg, client_pkg)
    assert crossed == _replies(daemon_pkg, daemon_pkg)
    nodes = dict(crossed)["list_nodes"]
    assert [n["node_id"] for n in nodes] == ["host-0", "host-1"]
    assert all(n["alive"] for n in nodes)
    assert ("heartbeat", "error: gcs: unknown node") in crossed
