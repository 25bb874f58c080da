"""The port's core runtime (``tpu_air_torch.core``) on the CPU: the patterns
of tests/test_core.py that the copied modules serve, and what the port
changed: the forkserver start method, the lease -> CUDA device mapping, the
chip count from CUDA, and ``init()`` joining the multi-host rendezvous
first.  The runtime comes from a fixture of the port's own
(``init(num_cpus=4, num_chips=2)``); the JAX package is not imported."""

import os
import time

import numpy as np
import pytest
import torch

import tpu_air_torch
from tpu_air_torch import ActorPool
from tpu_air_torch.core import runtime as rt
from tpu_air_torch.device import resolve_device


@pytest.fixture(scope="module")
def tair():
    tpu_air_torch.init(num_cpus=4, num_chips=2)
    yield tpu_air_torch
    tpu_air_torch.shutdown()


@pytest.mark.parametrize("value", [{"a": 1, "b": [1, 2, 3]}, "text", None])
def test_put_get_roundtrip(tair, value):
    assert tpu_air_torch.get(tpu_air_torch.put(value)) == value


def test_put_get_numpy_zero_copy(tair):
    arr = np.arange(100_000, dtype=np.float32).reshape(100, 1000)
    out = tpu_air_torch.get(tpu_air_torch.put(arr))
    np.testing.assert_array_equal(arr, out)
    assert not out.flags.writeable          # backed by the store's mapping


def test_get_type_error(tair):
    with pytest.raises(TypeError):
        tpu_air_torch.get(42)


def test_tasks_objectref_args_and_nesting(tair):
    @tpu_air_torch.remote
    def total(xs, offset):
        return sum(xs) + offset

    @tpu_air_torch.remote
    def outer(x):
        return tpu_air_torch.get(total.remote([x, x], offset=1)) + 1

    data_ref = tpu_air_torch.put([1, 2, 3])
    assert tpu_air_torch.get(total.remote(data_ref, offset=10)) == 16
    assert tpu_air_torch.get(outer.remote(5)) == 12
    with pytest.raises(TypeError, match="remote"):
        total([1], 0)


def test_task_error_propagates(tair):
    @tpu_air_torch.remote
    def boom():
        raise ValueError("kaboom")

    with pytest.raises(tpu_air_torch.RemoteError, match="kaboom"):
        tpu_air_torch.get(boom.remote())


def test_wait_returns_ready_and_pending(tair):
    @tpu_air_torch.remote
    def snooze(t):
        time.sleep(t)
        return t

    fast, slow = snooze.remote(0.05), snooze.remote(2.0)
    ready, pending = tpu_air_torch.wait([fast, slow], num_returns=1, timeout=1.5)
    assert ready == [fast] and pending == [slow]
    assert tpu_air_torch.wait([slow], num_returns=1, timeout=0.01)[0] == []
    tpu_air_torch.get(slow)


def test_crash_probe_raises_and_runtime_stays_usable(tair):
    """A task that calls os._exit(17) kills its worker: the caller gets
    WorkerCrashed and the runtime goes on serving tasks."""
    @tpu_air_torch.remote
    def crash():
        os._exit(17)

    @tpu_air_torch.remote
    def ok(x):
        return x + 1

    with pytest.raises(tpu_air_torch.RemoteError, match="WorkerCrashed"):
        tpu_air_torch.get(crash.remote(), timeout=60)
    assert tpu_air_torch.get([ok.remote(i) for i in range(4)]) == [1, 2, 3, 4]


def test_actor_state_ordering_and_kill(tair):
    @tpu_air_torch.remote
    class Counter:
        def __init__(self, start):
            self.n = start

        def add(self, k):
            self.n += k
            return self.n

    c = Counter.remote(10)
    assert tpu_air_torch.get([c.add.remote(1) for _ in range(5)]) == [11, 12, 13, 14, 15]
    tpu_air_torch.kill(c)
    with pytest.raises(tpu_air_torch.RemoteError, match="ActorDied"):
        tpu_air_torch.get(c.add.remote(1), timeout=30)


def test_actor_pool_over_two_actors(tair):
    @tpu_air_torch.remote
    class Doubler:
        def double(self, x):
            return (os.getpid(), 2 * x)

    actors = [Doubler.remote() for _ in range(2)]
    pool = ActorPool(actors)
    out = list(pool.map(lambda a, v: a.double.remote(v), range(8)))
    assert [v for _, v in out] == [2 * i for i in range(8)]
    assert len({pid for pid, _ in out}) == 2
    for a in actors:
        tpu_air_torch.kill(a)


def test_leased_actor_maps_its_lease_to_a_cuda_device(tair):
    """An actor with num_chips holds its lease on its worker context and in
    TPU_AIR_CHIP_IDS; resolve_device() there is cuda:<first leased id> (on
    as many cards as slots), and without CUDA it raises unless device='cpu'
    was given."""
    @tpu_air_torch.remote(num_chips=1)
    class Leased:
        def probe(self):
            from tpu_air_torch.core.runtime import current_worker

            lease = list(current_worker().chip_ids)
            try:
                resolve_device()
                refused = ""
            except RuntimeError as e:
                refused = str(e)
            cpu = str(resolve_device("cpu"))
            torch.cuda.is_available = lambda: True      # as on a machine with 2 cards
            torch.cuda.device_count = lambda: 2
            return lease, os.environ.get("TPU_AIR_CHIP_IDS"), refused, cpu, str(resolve_device())

    actors = [Leased.remote() for _ in range(2)]
    got = tpu_air_torch.get([a.probe.remote() for a in actors])
    assert sorted(lease[0] for lease, *_ in got) == [0, 1]
    for lease, env, refused, cpu, dev in got:
        assert env == str(lease[0])
        assert "leased devices" in refused and "device='cpu'" in refused
        assert cpu == "cpu"
        assert dev == f"cuda:{lease[0]}"
    for a in actors:
        tpu_air_torch.kill(a)
    # outside an actor: cuda:0 where CUDA exists, a refusal where it does not
    assert rt.current_worker() is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device()


def test_oversubscribed_actor_creation_queues(tair):
    """4 actors x 1 chip on a 2-chip runtime: the creations beyond capacity
    queue for a lease (FIFO) and are placed as earlier actors release
    theirs; no lease is handed out twice."""
    @tpu_air_torch.remote(num_chips=1)
    class Trial:
        def lease(self):
            return os.environ["TPU_AIR_CHIP_IDS"]

    handles = [Trial.remote() for _ in range(4)]
    held = []
    for h in handles:
        held.append(tpu_air_torch.get(h.lease.remote(), timeout=60))
        tpu_air_torch.kill(h)
    assert sorted(held[:2]) == ["0", "1"] and set(held) <= {"0", "1"}
    assert sorted(rt.get_runtime().free_chips) == [0, 1]


def test_unsatisfiable_lease_rejected(tair):
    @tpu_air_torch.remote(num_chips=3)
    def f():
        return 1

    with pytest.raises(tpu_air_torch.TpuAirError, match="exceeds"):
        f.remote()


def test_store_and_workers_are_the_ports_own(tair):
    r = rt.get_runtime()
    assert os.path.basename(r.store_root).startswith("tpu_air_torch-")
    assert r.store._spill_dir.rsplit(os.sep, 1)[1].startswith("tpu_air_torch-spill-")
    assert r.mp_ctx.get_start_method() == "forkserver"


def test_start_method_never_forks_after_cuda(monkeypatch):
    """The default start method is forkserver; a runtime asked to fork
    switches to the preloaded forkserver once CUDA is initialized."""
    import multiprocessing as mp

    probe = rt.Runtime.__new__(rt.Runtime)
    probe.mp_ctx, probe._fs_ctx = mp.get_context("fork"), None
    monkeypatch.setattr(rt, "_cuda_initialized", lambda: False)
    assert probe._pick_ctx().get_start_method() == "fork"
    monkeypatch.setattr(rt, "_cuda_initialized", lambda: True)
    assert probe._pick_ctx().get_start_method() == "forkserver"
    import inspect

    assert '"forkserver")' in inspect.getsource(rt.Runtime.__init__)


_JOIN = """
import json, tpu_air_torch
from tpu_air_torch.parallel import distributed as D
runtime = tpu_air_torch.init(num_cpus=1)
print(json.dumps([D.process_index(), D.process_count(), runtime.num_chips,
                  runtime.chips_per_host]))
tpu_air_torch.shutdown()
"""


def test_init_with_the_env_contract_joins_the_hosts_group():
    """``init()`` under the multi-host env contract joins the rendezvous
    first: two processes, one a host, each see the group and schedule the
    cluster's slot pool in hosts of ``TPU_AIR_CHIPS_PER_HOST``."""
    import json
    import subprocess
    import sys

    from tpu_air_torch.parallel.distributed import _free_port

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if not k.startswith("TPU_AIR_")}
    env.update(TPU_AIR_NUM_PROCESSES="2", TPU_AIR_NUM_CHIPS="8", TPU_AIR_CHIPS_PER_HOST="4",
               TPU_AIR_NO_GCS="1", TPU_AIR_RENDEZVOUS_TIMEOUT_S="60", PYTHONPATH=root)
    for _ in range(3):
        # the port was free when named; another process may bind it first
        env["TPU_AIR_COORDINATOR"] = f"127.0.0.1:{_free_port()}"
        procs = [subprocess.Popen([sys.executable, "-c", _JOIN], cwd=root, text=True,
                                  env=dict(env, TPU_AIR_PROCESS_ID=str(pid)),
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE)
                 for pid in (0, 1)]
        outs = [p.communicate(timeout=120) for p in procs]
        if "in use" not in outs[0][1].lower():
            break
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    assert [json.loads(out.strip().splitlines()[-1]) for out, _ in outs] == [
        [0, 2, 8, 4], [1, 2, 8, 4]]


def test_failed_rendezvous_raises(monkeypatch):
    """A rendezvous that cannot reach its coordinator raises out of
    ``init()``, which starts no runtime: the host does not run alone in a
    run shaped for several."""
    from tpu_air_torch.parallel import distributed as D
    from tpu_air_torch.parallel.distributed import _free_port

    monkeypatch.setattr(rt, "_runtime", None)
    monkeypatch.setenv("TPU_AIR_COORDINATOR", f"127.0.0.1:{_free_port()}")
    monkeypatch.setenv("TPU_AIR_NUM_PROCESSES", "2")
    monkeypatch.setenv("TPU_AIR_PROCESS_ID", "1")
    monkeypatch.setenv("TPU_AIR_RENDEZVOUS_TIMEOUT_S", "2")
    with pytest.raises(RuntimeError):
        tpu_air_torch.init(num_cpus=1, num_chips=1)
    assert rt._runtime is None and D.process_count() == 1


def test_gcs_env_joins_a_running_daemon(monkeypatch):
    """``TPU_AIR_GCS`` joins a daemon that is already running instead of
    being refused: the runtime starts none of its own, publishes its actors
    there, and leaves the daemon running at shutdown."""
    from tpu_air_torch import _native

    if _native.gcs_missing():
        pytest.skip(f"gcs unavailable: {_native.gcs_missing()}")
    from tpu_air_torch.control import GcsClient, start_gcs

    proc, port = start_gcs()
    client = GcsClient(f"127.0.0.1:{port}")
    monkeypatch.setenv("TPU_AIR_GCS", f"127.0.0.1:{port}")
    monkeypatch.setattr(rt, "_runtime", None)
    try:
        runtime = tpu_air_torch.init(num_cpus=1, num_chips=1)
        try:
            assert runtime.gcs_address == f"127.0.0.1:{port}" and runtime._gcs_proc is None

            @tpu_air_torch.remote(num_chips=1)
            class Probe:
                def ping(self):
                    return "pong"

            a = Probe.options(name="joined-probe").remote()
            assert tpu_air_torch.get(a.ping.remote(), timeout=60) == "pong"
            info = client.lookup_actor("joined-probe")
            assert info["chip_ids"] == [0] and info["node_id"] == "host-0", info
            tpu_air_torch.kill(a)
            assert client.lookup_actor(a._actor_id)["dead"] is True
        finally:
            tpu_air_torch.shutdown()
        assert proc.poll() is None, "shutdown killed a daemon it did not start"
    finally:
        client.close()
        proc.kill()
        proc.wait()


def test_arena_bytes_sets_capacity(monkeypatch):
    """``TPU_AIR_ARENA_BYTES`` sizes the runtime's shared-memory arena
    instead of being refused; what fits lives there, what does not goes to
    a file."""
    import numpy as np

    monkeypatch.setenv("TPU_AIR_ARENA_BYTES", str(1 << 20))
    monkeypatch.setenv("TPU_AIR_NO_GCS", "1")
    runtime = rt.Runtime(num_cpus=1, num_chips=0)
    try:
        arena = runtime.store._arena
        assert arena is not None and arena.stats()["capacity"] == 1 << 20
        small = runtime.put(np.arange(1000))
        big = runtime.put(np.zeros(2 << 20, dtype=np.uint8))
        assert arena.contains(small.id) and not arena.contains(big.id)
        assert os.path.exists(os.path.join(runtime.store_root, big.id))
        assert runtime.get(big).nbytes == 2 << 20
        assert int(runtime.get(small).sum()) == 499500
    finally:
        runtime.shutdown()


@pytest.mark.parametrize("how", ["argument", "env"])
def test_dashboard_starts(how, monkeypatch, capsys):
    """``init(include_dashboard=True)`` or ``TPU_AIR_DASHBOARD=1`` starts
    the dashboard and prints its URL; ``/api/cluster`` answers with the new
    runtime's state and its GCS node.  The test's runtime is its own: the
    module's stays in place for the tests after it."""
    import json
    import re
    import urllib.request

    from tpu_air_torch import _native

    gcs = _native.gcs_missing() is None
    if gcs:
        _native.build_gcs()     # built: init() launches the daemon synchronously
    monkeypatch.setattr(rt, "_runtime", None)
    kwargs = {"include_dashboard": True} if how == "argument" else {}
    if how == "env":
        monkeypatch.setenv("TPU_AIR_DASHBOARD", "1")
    runtime = tpu_air_torch.init(num_cpus=1, num_chips=0, dashboard_port=0, **kwargs)
    try:
        url = re.search(r"dashboard: (http://\S+)", capsys.readouterr().out).group(1)
        with urllib.request.urlopen(f"{url}/api/cluster", timeout=30) as resp:
            cluster = json.loads(resp.read())
    finally:
        tpu_air_torch.shutdown()
    assert cluster["initialized"] and cluster["session_id"] == runtime.session_id
    assert cluster["resources"]["cpu"] == 1 and cluster["resources"]["chip"] == 0
    if gcs:
        assert cluster["gcs"]["address"] == runtime.gcs_address is not None
        assert [(n["node_id"], n["alive"], n["num_chips"])
                for n in cluster["gcs"]["nodes"]] == [("host-0", True, 0)]
    else:
        assert cluster["gcs"] == {"address": None, "nodes": []}
    from tpu_air_torch.observability import dashboard

    assert dashboard._server is None           # shutdown stopped it


def test_runtime_accepts_postmortem_dir(monkeypatch, tmp_path):
    """``TPU_AIR_POSTMORTEM_DIR`` arms the flight recorder instead of being
    refused; with ``TPU_AIR_NO_GCS=1`` the runtime reports no GCS, as the
    JAX package does without one."""
    monkeypatch.setenv("TPU_AIR_POSTMORTEM_DIR", str(tmp_path))
    monkeypatch.setenv("TPU_AIR_NO_GCS", "1")
    runtime = rt.Runtime(num_cpus=1, num_chips=0)
    try:
        assert runtime.nodes() == [] and runtime.gcs_address is None
    finally:
        runtime.shutdown()


def test_chip_count_comes_from_cuda(monkeypatch):
    """num_chips defaults to torch.cuda.device_count(); with no CUDA device
    the runtime raises instead of leasing nothing in silence."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="num_chips="):
        rt.Runtime(num_cpus=1)


def test_trace_spans_cross_into_workers_and_back(tair):
    """With tracing on, a task submitted inside a span records its worker
    span under the same trace, and the span comes back to the driver's
    recorder on the task's done message."""
    from tpu_air_torch.observability import tracing

    @tpu_air_torch.remote
    def work(x):
        return x + 1

    tracing.enable()
    try:
        with tracing.span("driver.root") as root:
            assert tpu_air_torch.get(work.remote(1)) == 2
    finally:
        tracing.disable()
    # the result is sealed before the done message that carries the span
    # reaches the driver's listener thread
    deadline = time.monotonic() + 30
    while True:
        names = {s.name: s for s in tracing.recorder().for_trace(root.trace_id)}
        if "task.work" in names or time.monotonic() > deadline:
            break
        time.sleep(0.01)
    assert "task.work" in names and "driver.root" in names
    assert names["task.work"].parent_id == root.span_id
    assert names["task.work"].pid != os.getpid()


def test_fault_plan_reaches_the_object_store(tair):
    """An installed fault plan fires at its site: a "drop" at the second
    object-store get raises the TimeoutError a real store timeout would;
    cleared, the same get succeeds."""
    from tpu_air_torch.faults import plan as faults

    ref = tpu_air_torch.put("payload")
    faults.install(faults.FaultPlan(seed=0, specs=[
        faults.FaultSpec("object_store.get", "drop", at=2, match=ref.id)]))
    try:
        assert tpu_air_torch.get(ref) == "payload"
        with pytest.raises(TimeoutError, match="injected drop"):
            tpu_air_torch.get(ref)
    finally:
        faults.clear()
    assert tpu_air_torch.get(ref) == "payload"
    assert not faults.enabled()
