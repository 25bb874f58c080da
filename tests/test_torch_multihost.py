"""Multi-host in the port (``tpu_air_torch/parallel/distributed.py``, the
runtime's lease shapes, the trainers' multi-host path) on the CPU, against
the JAX package:

* the rendezvous, the agent plane and the object plane of a 2-host x
  4-slot cluster (``spawn_local_cluster``; this process is host 0, the
  other host an agent subprocess that never imports JAX);
* one data-parallel step over the hosts' gloo group against the same step
  jitted by JAX over 8 host devices in this process (within 1e-6), as
  ``tests/_multihost_driver.py`` runs it across two JAX processes;
* the lease shapes of ``tests/_multihost_lease_driver.py`` phase A on the
  port's runtime, and the pure scheduler cases of
  ``tests/test_lease_stress.py`` and ``tests/test_multihost.py`` on both
  packages' ``Runtime``;
* ``T5Trainer(ScalingConfig(num_workers=4, model_parallel=2))`` across the
  two hosts (dp 4 x tp 2: each host 2 data replicas of 2 shards) against
  the JAX ``t5_train_loop`` over 8 devices in this process, in f32: epoch
  and eval losses within 1e-5 relative, final parameters within 1e-5
  relative in norm (the bounds of ``tests/test_torch_tp_train.py``), and
  each host's final parameters bitwise equal;
* ``FailureConfig`` retries and the elastic shrink on the multi-host path,
  and a dead host agent that raises instead of hanging.

Each host runs torch on 2 threads: two hosts on 8 threads each fight over
the cores and a fit takes four times as long.
"""

import functools
import json
import os
import subprocess
import sys
import time

import numpy as np
import pandas as pd
import pytest
import torch

import tpu_air_torch
from tpu_air_torch import _native
from tpu_air_torch.core import runtime as rt
from tpu_air_torch.parallel import distributed as D

import _torch_multihost_workers as W

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(REPO, "tests")
SEQ = 16
VOCAB = 384
EPOCHS = 2


# -- no cluster (these run before the module's cluster starts) -------------------------


def test_ensure_initialized_is_false_without_the_env_contract(monkeypatch):
    for k in ("TPU_AIR_COORDINATOR", "TPU_AIR_NUM_PROCESSES", "TPU_AIR_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    assert D.ensure_initialized() is False
    assert (D.process_index(), D.process_count(), D.is_coordinator()) == (0, 1, True)
    assert D.world() == (0, 1)
    # one process is no cluster either
    monkeypatch.setenv("TPU_AIR_COORDINATOR", "127.0.0.1:1")
    monkeypatch.setenv("TPU_AIR_NUM_PROCESSES", "1")
    assert D.ensure_initialized() is False


def test_a_cluster_without_the_gcs_says_why(capsys):
    """``nodes()`` of a cluster whose daemon did not start prints the reason
    (``_native.gcs_missing()``) and returns no membership."""
    cluster = D.LocalCluster(D.HostAgentServer(1), [], gcs_missing="no protoc")
    try:
        assert cluster.nodes() == []
        assert "no gcs (no protoc)" in capsys.readouterr().err
    finally:
        cluster.server.shutdown()


def test_host_backend_rule(monkeypatch):
    """gloo on the CPU and where the hosts share this machine's cards (a
    loopback coordinator), nccl where each host has cards of its own."""
    assert D.host_backend(torch.device("cpu")) == "gloo"

    class Fake:
        coordinator = "127.0.0.1:5000"

    monkeypatch.setattr(D, "_RENDEZVOUS", Fake())
    assert D.hosts_share_cards()
    assert D.host_backend(torch.device("cuda", 0)) == "gloo"
    Fake.coordinator = "10.1.2.3:5000"
    assert not D.hosts_share_cards()
    assert D.host_backend(torch.device("cuda", 0)) == "nccl"
    assert D.host_backend(torch.device("cpu")) == "gloo"


def test_agent_death_mid_run_raises_not_hangs(tmp_path):
    """``HostAgentServer.run`` with an agent that dies mid-run raises (EOF)
    instead of blocking; ``shutdown`` ends the live agents (the twin of
    ``tests/test_lease_stress.py::test_host_agent_death_mid_run_raises_not_hangs``)."""
    key = "cafe" * 8
    old = os.environ.get("TPU_AIR_AUTHKEY")
    os.environ["TPU_AIR_AUTHKEY"] = key
    server = D.HostAgentServer(3)
    host, port = server.address
    code = ("import os\n"
            f"os.environ['TPU_AIR_AUTHKEY'] = {key!r}\n"
            "from tpu_air_torch.parallel.distributed import agent_loop\n"
            f"agent_loop(({host!r}, {port}), int(os.environ['PID']))\n")
    agents = []
    try:
        for pid in (1, 2):
            env = dict(os.environ, PID=str(pid), PYTHONPATH=os.pathsep.join([TESTS, REPO]))
            agents.append(subprocess.Popen([sys.executable, "-c", code], env=env, cwd=REPO))
        server.wait_for_agents(timeout=60)
        assert server.run(functools.partial(W.echo, 7)) == [7, 7, 7]
        t0 = time.monotonic()
        with pytest.raises((RuntimeError, EOFError, OSError)):
            server.run(functools.partial(W.exit_on_agent, 1))
        assert time.monotonic() - t0 < 60
        assert agents[0].wait(timeout=30) == 41
    finally:
        server.shutdown()
        if old is None:
            os.environ.pop("TPU_AIR_AUTHKEY", None)
        else:
            os.environ["TPU_AIR_AUTHKEY"] = old
        for p in agents:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
    assert agents[1].returncode == 0      # told to exit by shutdown()


# -- the scheduler's lease shapes, on both packages' Runtime ----------------------------


def _runtime_class(pkg):
    if pkg == "tpu_air":
        pytest.importorskip("jax")
        from tpu_air.core.runtime import Runtime
    else:
        from tpu_air_torch.core.runtime import Runtime
    return Runtime


def _bare_runtime(pkg, num_chips, chips_per_host, free=None):
    """Shape and queue logic only, no processes (test_lease_stress.py's)."""
    import threading

    runtime = _runtime_class(pkg).__new__(_runtime_class(pkg))
    runtime.num_cpus = 100
    runtime.num_chips = num_chips
    runtime.chips_per_host = chips_per_host
    runtime.free_chips = list(range(num_chips)) if free is None else list(free)
    runtime.avail = {"cpu": 100.0, "chip": float(len(runtime.free_chips))}
    runtime.lock = threading.RLock()
    runtime.actor_queue = []
    runtime._to_spawn = []
    runtime._placement_event = threading.Event()
    return runtime


def _rec(name, nchips):
    return {"actor_id": name, "ready_id": f"{name}-ready", "payload": None,
            "payload_ref": None, "resources": {"chip": float(nchips), "cpu": 0.0},
            "name": name}


PKGS = ["tpu_air", "tpu_air_torch"]


@pytest.mark.parametrize("pkg", PKGS)
def test_shape_blocked_head_does_not_stall_queue(pkg):
    runtime = _bare_runtime(pkg, 8, 2, free=[1, 3, 6, 7])
    runtime.actor_queue = [_rec("big", 4), _rec("small", 2), _rec("one", 1)]
    runtime._claim_queued_actors()
    assert [rec["name"] for rec, _ in runtime._to_spawn] == ["one"]
    assert [r["name"] for r in runtime.actor_queue] == ["big", "small"]
    one_ids = dict((rec["name"], ids) for rec, ids in runtime._to_spawn)["one"]
    assert one_ids == [3]
    runtime.free_chips.extend([0, 2] + one_ids)
    runtime.avail["chip"] += 2.0 + len(one_ids)
    runtime._to_spawn.clear()
    runtime._claim_queued_actors()
    assert [rec["name"] for rec, _ in runtime._to_spawn] == ["big", "small"]
    by_name = dict((rec["name"], ids) for rec, ids in runtime._to_spawn)
    assert sorted(by_name["big"]) == [0, 1, 2, 3] and sorted(by_name["small"]) == [6, 7]
    assert runtime.actor_queue == []


@pytest.mark.parametrize("pkg", PKGS)
def test_reserved_hosts_cannot_be_nibbled_by_small_leases(pkg):
    runtime = _bare_runtime(pkg, 8, 2, free=[0, 1, 3, 5])
    runtime.actor_queue = [_rec("span", 4), _rec("pair", 2), _rec("uno", 1)]
    runtime._claim_queued_actors()
    assert [rec["name"] for rec, _ in runtime._to_spawn] == ["uno"]
    assert runtime._to_spawn[0][1] == [5]
    assert [r["name"] for r in runtime.actor_queue] == ["span", "pair"]
    runtime.free_chips.append(2)
    runtime.avail["chip"] += 1.0
    runtime._to_spawn.clear()
    runtime._claim_queued_actors()
    assert [rec["name"] for rec, _ in runtime._to_spawn] == ["span"]
    assert sorted(runtime._to_spawn[0][1]) == [0, 1, 2, 3]
    assert [r["name"] for r in runtime.actor_queue] == ["pair"]


@pytest.mark.parametrize("pkg", PKGS)
def test_count_blocked_head_still_fifo_blocks(pkg):
    runtime = _bare_runtime(pkg, 8, 2, free=[0, 1, 2, 3])
    runtime.avail["chip"] = 4.0
    runtime.actor_queue = [_rec("big", 6), _rec("small", 1)]
    runtime._claim_queued_actors()
    assert runtime._to_spawn == []
    assert [r["name"] for r in runtime.actor_queue] == ["big", "small"]


@pytest.mark.parametrize("pkg", PKGS)
def test_driver_lease_honors_queue_reservations(pkg):
    runtime = _bare_runtime(pkg, 8, 2, free=[0, 1, 3, 5])
    runtime.actor_queue = [_rec("span", 4)]
    assert runtime._claim_chips(2, frozenset(runtime._queued_reservations())) is None
    one = runtime._claim_chips(1, frozenset(runtime._queued_reservations()))
    assert one is not None and one[0] in (3, 5)
    runtime.free_chips.extend(one)
    runtime.free_chips.append(2)
    runtime.avail["chip"] += 1.0
    reserved = runtime._queued_reservations()
    assert reserved == {0, 1}
    assert runtime._claim_chips(2, frozenset(reserved)) is None
    assert sorted(runtime.free_chips) == [0, 1, 2, 3, 5]


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("free,cph,nchips,already,want", [
    # 3 hosts x 4: host 0 whole, host 1 two free, host 2 three free: only
    # the whole host is reserved, partial hosts stay for smaller requests
    ([0, 1, 2, 3, 4, 5, 8, 9, 10], 4, 8, set(), {0}),
    # 4 hosts x 4, free [1, 3, 2, 0] a host, none whole: the two hosts with
    # the most free chips, so 1-chip leases cannot nibble them
    ([0, 4, 5, 6, 8, 9], 4, 8, set(), {1, 2}),
    # hosts already reserved are left out of the recount
    ([0, 4, 5, 6, 8, 9], 4, 8, {1}, {1, 2, 0}),
    # a single-host request reserves the freest host
    ([0, 4, 5, 6, 8, 9], 4, 2, set(), {1}),
], ids=["whole_hosts", "partial_hosts", "excludes_reserved", "single_host"])
def test_reserve_closest(pkg, free, cph, nchips, already, want):
    from types import SimpleNamespace

    reserved = set(already)
    _runtime_class(pkg)._reserve_closest(
        SimpleNamespace(chips_per_host=cph, free_chips=free), nchips, reserved)
    assert reserved == want


@pytest.mark.parametrize("pkg", PKGS)
def test_one_host_is_the_lowest_free_ids(pkg):
    """With one host every shape fits it: a claim is the lowest free ids."""
    runtime = _bare_runtime(pkg, 4, 4, free=[3, 1, 2])
    assert runtime._claim_chips(2) == [1, 2]
    assert runtime._claim_chips(2) is None
    runtime._check_satisfiable({"chip": 4.0})


# -- the module's cluster ----------------------------------------------------------------


@pytest.fixture(scope="module")
def cluster():
    """2 hosts x 4 slots: this process is host 0 with a port runtime over
    the 8 slots; the agent runs this directory's helpers."""
    saved_runtime = rt._runtime
    rt._runtime = None
    saved_pp = os.environ.get("PYTHONPATH")
    os.environ["PYTHONPATH"] = os.pathsep.join([TESTS, REPO] + ([saved_pp] if saved_pp else []))
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    c = D.spawn_local_cluster(2, 4)
    try:
        c.run(functools.partial(W.set_threads, 2))
        tpu_air_torch.init(num_cpus=1)
        yield c
    finally:
        tpu_air_torch.shutdown()
        c.shutdown()
        rt._runtime = saved_runtime
        torch.set_num_threads(threads)
        if saved_pp is None:
            os.environ.pop("PYTHONPATH", None)
        else:
            os.environ["PYTHONPATH"] = saved_pp


def test_rendezvous_and_the_agent_plane(cluster):
    """Both hosts joined one group; results come back by process id; a
    host's error comes back with its host id and traceback; the agent
    imported neither JAX nor the JAX package."""
    assert D.ensure_initialized() is True
    assert (D.process_index(), D.process_count(), D.is_coordinator()) == (0, 2, True)
    assert cluster.run(functools.partial(W.host_ids)) == [(0, 2), (1, 2)]
    with pytest.raises(RuntimeError, match=r"(?s)host 1 failed:.*Traceback.*boom on host 1"):
        cluster.run(functools.partial(W.raise_on, 1))
    assert cluster.run(functools.partial(W.raise_on, 5)) == [0, 1]   # still serving
    assert cluster.run(W.foreign_modules)[1] == []
    assert D.world() == (0, 1)          # the hosts' group is scoped to a fit


def test_psum_step_matches_the_jax_step(cluster):
    """One DDP step across the hosts: bitwise the same loss and update on
    both, within 1e-6 of JAX's step over the same rows on 8 devices."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    results = cluster.run(functools.partial(W.ddp_psum_step, "psum"))
    assert [r[2] for r in results] == [(0, 2), (1, 2)]
    assert {r[3] for r in results} == {"gloo"}
    assert results[0][:2] == results[1][:2]
    mesh = Mesh(np.array(jax.devices()[:8]), ("data",))
    x = jax.device_put(np.concatenate([W.psum_rows(h) for h in range(2)]),
                       NamedSharding(mesh, P("data")))
    w = jax.device_put(jnp.ones((W.FEAT, 1)) * 0.1, NamedSharding(mesh, P()))

    @jax.jit
    def step(w, x):
        y = jnp.sum(x[:, :3], axis=1, keepdims=True)
        loss, g = jax.value_and_grad(lambda v: jnp.mean((x @ v - y) ** 2))(w)
        return loss, w - 0.05 * g

    loss, w2 = step(w, x)
    assert abs(results[0][0] - float(loss)) <= 1e-6 * abs(float(loss))
    assert abs(results[0][1] - float(jnp.sum(w2))) <= 1e-6 * abs(float(jnp.sum(w2)))


def test_lease_shapes_across_hosts(cluster):
    """Phase A of ``tests/_multihost_lease_driver.py`` on the port: a lease
    up to a host's slots lives on one host (best fit), a larger one is
    whole hosts, a request the free shape cannot tile waits, and a span
    that is no multiple of a host raises."""
    runtime = rt.get_runtime()
    assert (runtime.num_chips, runtime.chips_per_host) == (8, 4)

    def host_of(c):
        return c // 4

    l3 = runtime.lease_chips(3)
    assert len(l3) == 3 and len({host_of(c) for c in l3}) == 1
    l4 = runtime.lease_chips(4)
    assert len({host_of(c) for c in l4}) == 1 and host_of(l4[0]) != host_of(l3[0])
    with pytest.raises(TimeoutError):
        runtime.lease_chips(2, timeout=0.5)      # 1 free slot on one host, 0 on the other
    runtime.release_chips(l3)
    runtime.release_chips(l4)
    l8 = runtime.lease_chips(8)
    assert sorted(l8) == list(range(8))
    runtime.release_chips(l8)
    with pytest.raises(rt.TpuAirError, match="multiple of chips_per_host=4"):
        runtime.lease_chips(5)
    assert runtime.avail["chip"] == 8.0 and sorted(runtime.free_chips) == list(range(8))


@pytest.mark.skipif(_native.gcs_missing() is not None,
                    reason=f"gcs unavailable: {_native.gcs_missing()}")
def test_object_plane_fetches_across_hosts(cluster, tmp_path):
    """An object put on host 1 is fetched on host 0 through the GCS object
    directory and cached there; a dead holder is passed over for the next
    one; with no live holder left the fetch is a KeyError."""
    from tpu_air_torch.core.object_store import ObjectStore

    gcs = cluster.gcs_address
    assert {n["node_id"] for n in cluster.nodes()} >= {"host-0", "host-1"}
    cluster.run(functools.partial(W.host_start_plane, 1, gcs, str(tmp_path / "h1")))
    value = {"rows": np.arange(1000, dtype=np.float32), "tag": "from host 1"}
    cluster.run(functools.partial(W.host_plane_put, 1, value, "obj-a"))
    plane = D.ObjectPlane(ObjectStore(str(tmp_path / "h0"), create=True), "host-0", gcs)
    dead = D.ObjectPlane(ObjectStore(str(tmp_path / "dead"), create=True), "host-dead", gcs)
    try:
        got = plane.fetch("obj-a")
        np.testing.assert_array_equal(got["rows"], value["rows"])
        assert got["tag"] == "from host 1"
        assert plane.store.contains("obj-a")                       # cached here
        assert set(plane.gcs.locate_object("obj-a")["node_ids"]) == {"host-1", "host-0"}
        # obj-b: the dead holder published first, then host 1
        dead.put("b-value", "obj-b")
        dead.close()
        cluster.run(functools.partial(W.host_plane_put, 1, "b-value", "obj-b"))
        assert plane.gcs.locate_object("obj-b")["node_ids"][0] == "host-dead"
        assert plane.fetch("obj-b") == "b-value"
        cluster.run(functools.partial(W.host_plane_put, 1, "c-value", "obj-c"))
    finally:
        cluster.run(functools.partial(W.host_stop_plane, 1))
    try:
        with pytest.raises(KeyError, match="unreachable"):
            plane.fetch("obj-c")                 # its only holder is gone
        with pytest.raises(KeyError, match="not in the cluster directory"):
            plane.fetch("obj-none")
    finally:
        plane.close()


# -- the trainers across hosts ------------------------------------------------------------


def _t5_rows(n, seed):
    """Pre-tokenized rows: ragged source lengths and mostly-pad labels."""
    rng = np.random.default_rng(seed)
    ids, masks, labels = [], [], []
    for _ in range(n):
        s, t = int(rng.integers(3, SEQ + 1)), int(rng.integers(2, SEQ // 2))
        src = np.zeros(SEQ, np.int32)
        src[:s] = rng.integers(3, VOCAB, s)
        lab = np.zeros(SEQ, np.int32)
        lab[:t] = rng.integers(3, VOCAB, t)
        ids.append(src)
        masks.append((src != 0).astype(np.int32))
        labels.append(lab)
    return pd.DataFrame({"input_ids": ids, "attention_mask": masks, "labels": labels})


def _rel(got, want) -> float:
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def test_t5_trainer_spans_two_hosts_like_the_jax_loop(cluster, tmp_path, monkeypatch):
    """dp 4 x tp 2 over 2 hosts x 4 slots against the JAX loop's (4, 2)
    mesh over 8 devices, from the same weights and rows."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from tpu_air.models.t5 import T5Config as JT5Config
    from tpu_air.models.t5 import T5ForConditionalGeneration as JT5
    from tpu_air.train import session as jsession
    from tpu_air.train import t5_trainer as jt5_trainer
    from tpu_air.train.checkpoint import Checkpoint as JCheckpoint
    from tpu_air.train.config import CheckpointConfig as JCheckpointConfig
    from tpu_air.train.config import ScalingConfig as JScalingConfig
    from tpu_air.train.trainer import _BroadcastDataset as JDataset
    from tpu_air_torch.models.t5.config import T5Config
    from tpu_air_torch.models.t5.convert import params_from_jax
    from tpu_air_torch.train import RunConfig, ScalingConfig, T5Trainer, TrainingArguments

    class DigestT5Trainer(T5Trainer):
        def _training_fn(self):
            return W.digest_t5_loop

    cfg = T5Config.tiny()
    enc = jnp.ones((2, 8), jnp.int32)
    jparams = jax.tree_util.tree_map(np.asarray, JT5(JT5Config.from_dict(cfg.to_dict())).init(
        jax.random.PRNGKey(0), enc, jnp.ones_like(enc), jnp.ones((2, 6), jnp.int32))["params"])
    args = TrainingArguments(learning_rate=1e-3, per_device_train_batch_size=2,
                             num_train_epochs=EPOCHS, seed=3)
    data = {"train": _t5_rows(16, 1), "evaluation": _t5_rows(3, 2)}
    (tmp_path / "digests").mkdir()
    result = DigestT5Trainer(
        model_config=cfg, training_args=args,
        scaling_config=ScalingConfig(num_workers=4, model_parallel=2),
        pretrained_params=params_from_jax(jparams, cfg), datasets=data,
        trainer_init_config={"digest_dir": str(tmp_path / "digests")},
        run_config=RunConfig(storage_path=str(tmp_path / "port")), device="cpu").fit()
    assert result.error is None, result.error

    monkeypatch.setenv("TPU_AIR_CHIP_IDS", "0,1,2,3,4,5,6,7")
    sess = jsession.Session(run_dir=str(tmp_path / "jax"),
                            checkpoint_config=JCheckpointConfig(num_to_keep=1),
                            datasets={k: JDataset(v) for k, v in data.items()})
    jsession._set_active(sess)
    try:
        jt5_trainer.t5_train_loop({
            "model_config": JT5Config.from_dict(cfg.to_dict()),
            "training_args": jt5_trainer.TrainingArguments(**vars(args)),
            "_scaling_config": JScalingConfig(model_parallel=2),
            "pretrained_params": jax.tree_util.tree_map(jnp.asarray, jparams)})
    finally:
        jsession._set_active(None)
    jhist = sess.history
    assert len(result.metrics_history) == len(jhist) == EPOCHS
    for got, want in zip(result.metrics_history, jhist):
        assert got["mesh_num_hosts"] == 2 and want["mesh_num_hosts"] == 1
        for key in ("epoch", "steps", "mesh_data", "mesh_model", "params_bytes_total",
                    "params_bytes_per_device"):
            assert got[key] == want[key], (key, got[key], want[key])
        for key in ("loss", "eval_loss"):
            np.testing.assert_allclose(got[key], want[key], rtol=1e-5, err_msg=key)
    assert (result.metrics["mesh_data"], result.metrics["mesh_model"]) == (4, 2)
    jfinal = params_from_jax(jax.tree_util.tree_map(
        np.asarray, JCheckpoint.from_directory(sess.latest_checkpoint()[0]).get_params()), cfg)
    got = result.checkpoint.get_params()
    assert set(got) == set(jfinal)
    for name, want in jfinal.items():
        assert _rel(got[name].numpy(), want.numpy()) <= 1e-5, name
    digests = [(tmp_path / "digests" / f"host-{h}").read_text() for h in (0, 1)]
    assert digests[0] == digests[1]                       # bitwise across hosts
    assert digests[0] == W.params_digest(got)             # and the checkpoint's
    runtime = rt.get_runtime()
    assert runtime.avail["chip"] == 8.0 and D.world() == (0, 1)


def test_failure_config_retries_on_the_multihost_path(cluster, tmp_path):
    """A training error on every host of the first attempt retries from its
    checkpoint across both hosts again (the twin of the lease driver's
    phase E)."""
    from tpu_air_torch.train import FailureConfig, RunConfig, ScalingConfig, TorchTrainer

    r = TorchTrainer(W.retry_loop, scaling_config=ScalingConfig(num_workers=8),
                     run_config=RunConfig(storage_path=str(tmp_path),
                                          failure_config=FailureConfig(max_failures=1)),
                     device="cpu").fit()
    assert r.error is None, r.error
    assert r.metrics["i"] == 3 and r.metrics["hosts"] == 2
    assert [m["i"] for m in r.metrics_history] == [2, 3]      # resumed from i = 1
    assert rt.get_runtime().avail["chip"] == 8.0


def test_elastic_preemption_shrinks_and_resumes(cluster, tmp_path):
    """A notice revokes the 8-slot lease mid-run: both hosts stop at the
    same report, the run halves its data-parallel width onto one host and
    resumes there, in this process, from the retained checkpoint, without
    spending ``max_failures`` (the twin of
    ``tests/test_preemption.py::test_elastic_preemption_shrinks_and_resumes``)."""
    from tpu_air_torch.faults import plan as faults
    from tpu_air_torch.faults.plan import FaultPlan, FaultSpec
    from tpu_air_torch.train import FailureConfig, RunConfig, ScalingConfig, TorchTrainer

    trace = tmp_path / "trace"
    trace.mkdir()
    faults.install(FaultPlan(seed=15, specs=[
        FaultSpec("runtime.lease", "notice", at=1, delay_s=0.8, notice_s=10.0)]))
    try:
        r = TorchTrainer(W.elastic_loop, train_loop_config={"trace_dir": str(trace)},
                         scaling_config=ScalingConfig(num_workers=2, num_chips_per_worker=4),
                         run_config=RunConfig(storage_path=str(tmp_path / "runs"),
                                              failure_config=FailureConfig(max_failures=0)),
                         device="cpu").fit()
    finally:
        faults.clear()
    assert r.error is None, r.error
    assert r.metrics["i"] == 6
    # the last attempt ran on one host, in this process, outside any host group
    assert r.metrics["hosts"] == 1 and r.metrics["world"] == [0, 1]
    first = r.metrics_history[0]["i"]
    assert first >= 2 and [m["i"] for m in r.metrics_history] == list(range(first, 7))
    assert r.checkpoint is not None
    lines = {h: (trace / f"host-{h}").read_text().split("\n")[:-1] for h in (0, 1)}
    spanned = {h: [int(x.split()[0]) for x in v if x.split()[1] == "2"] for h, v in lines.items()}
    # one stop point: the report both hosts stopped at retained its
    # checkpoint (retention comes before the decision), which the resumed
    # attempt continues from
    assert spanned[0] == spanned[1] and spanned[0][-1] == first - 2
    assert rt.get_runtime().avail["chip"] == 8.0


def test_spmd_lease_released_when_cluster_run_fails(cluster, monkeypatch):
    """``_run_spmd_multihost`` releases its lease when the leased run raises
    (a dead host agent), and a waiter's lease then succeeds (the twin of
    ``tests/test_lease_stress.py::test_spmd_lease_released_when_cluster_run_fails``)."""
    from tpu_air_torch.train.config import RunConfig, ScalingConfig
    from tpu_air_torch.train.trainer import BaseTrainer

    runtime = rt.get_runtime()
    tr = BaseTrainer.__new__(BaseTrainer)
    tr.scaling_config = ScalingConfig(num_workers=8)
    tr.run_config = RunConfig()

    def boom(*a, **k):
        raise EOFError("host agent died")

    monkeypatch.setattr(tr, "_run_spmd_leased", boom)
    with pytest.raises(EOFError, match="host agent died"):
        tr._run_spmd_multihost({}, "/tmp/unused", {}, cluster, runtime, None)
    assert runtime.avail["chip"] == 8.0
    assert sorted(runtime.free_chips) == list(range(8))
    runtime.release_chips(runtime.lease_chips(8, timeout=5))


def test_example_runs_on_the_cpu():
    """``examples/torch_multihost_training.py --device cpu``: 2 hosts x 4
    CPU slots, ``T5Trainer(num_workers=4, model_parallel=2)``."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("TPU_AIR_")}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "examples", "torch_multihost_training.py"),
         "--device", "cpu"], cwd=REPO, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "MULTIHOST-EXAMPLE-OK" in proc.stdout
    result = json.loads(proc.stdout.strip().splitlines()[-2])
    assert result["mesh_num_hosts"] == 2 and result["mesh_data"] == 4
