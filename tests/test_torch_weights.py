"""The port's live weights and multi-tenant LoRA adapters on the CPU
(``tpu_air_torch.serve.weights``, ``InferenceEngine.swap_params`` /
``rollback_params`` / ``load_adapter``), the cases of tests/test_weights.py
on the port plus checks against the JAX package on the same weights.

* The store: round trip, versions and retention, adapter versions exempt
  from it, a torn publish (``weights.publish`` kill) that never goes live,
  corrupt and missing objects refused, a ``corrupt`` fault that passes its
  checksums.
* Across packages: a store the port publishes loads through
  ``tpu_air.serve.weights.WeightStore`` into the same tree; ``compute_probe``
  gives the JAX package's fingerprint; a mixed-tenant batch gives the JAX
  ``InferenceEngine``'s tokens.
* Swaps: a same-weights swap mid-stream changes no token, a real swap under
  threaded load drops no stream, rollback restores once, a wrong key or
  shape changes nothing, and the step functions' cached head follows a swap
  in f32 and in bf16.
* Adapters: mixed tenants equal per-tenant ``offline_greedy``; the guards.
* ``CheckpointConfig.publish_weights_to``.
* ``EngineDeployment`` on ``PORT`` (8357, no other test file uses it) with
  the port's runtime from a module fixture: the canary controller promotes,
  rolls a corrupt publish back with no non-200 after admission, promotes
  and evicts an adapter through its gate; an unknown adapter is a 400 and a
  tenant over its quota a 429.

Weights: a Flax init of ``LMConfig.tiny()`` scaled by 4 (greedy decoding
then does not repeat one token), carried into the port; f32 unless a case
says bf16; the decode kernel's plain version.  Tokens are compared exactly.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import tpu_air_torch  # noqa: E402
from tpu_air.engine import EngineConfig as JEngineConfig  # noqa: E402
from tpu_air.engine import InferenceEngine as JInferenceEngine  # noqa: E402
from tpu_air.models import lm as jlm  # noqa: E402
from tpu_air.serve import weights as jweights  # noqa: E402
from tpu_air_torch import serve  # noqa: E402
from tpu_air_torch.engine import EngineConfig, InferenceEngine, RequestValidationError  # noqa: E402
from tpu_air_torch.faults import plan as faults  # noqa: E402
from tpu_air_torch.models import lm as tlm  # noqa: E402
from tpu_air_torch.models.lm.modeling import torch_dtype  # noqa: E402
from tpu_air_torch.serve import EngineDeployment, attach_weights  # noqa: E402
from tpu_air_torch.serve.proxy import serve_control_stats  # noqa: E402
from tpu_air_torch.serve.weights import (  # noqa: E402
    TornPublishError,
    WeightsIntegrityError,
    WeightStore,
    _flatten,
    compute_probe,
    offline_greedy,
    uninstall_controller,
)
from tpu_air_torch.train import Checkpoint  # noqa: E402

PORT = 8357
CFG = jlm.LMConfig.tiny()
V = CFG.vocab_size


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def lm():
    """(jax model, jax params) of the scaled Flax init."""
    jmodel = jlm.CausalLM(CFG)
    init = jmodel.init(jax.random.PRNGKey(0), jnp.ones((1, 8), jnp.int32))["params"]
    return jmodel, jax.tree_util.tree_map(lambda x: np.asarray(x) * np.float32(4), init)


def _port(params, dtype="float32"):
    """A fresh port model on ``params`` (engines that swap own their model's
    tensors, so each test makes its own)."""
    m = tlm.CausalLM(tlm.LMConfig.from_dict({**CFG.to_dict(), "dtype": dtype}), device="cpu")
    m.load_state_dict(tlm.params_from_jax(params))
    return m.to(torch_dtype(dtype))


@pytest.fixture
def _clean_faults():
    faults.clear()
    yield
    faults.clear()


def _prompts(seed, n, lo=3, hi=12):
    rng = np.random.RandomState(seed)
    return [list(map(int, rng.randint(1, V, size=rng.randint(lo, hi)))) for _ in range(n)]


def _adapter(seed, r):
    rng = np.random.RandomState(seed)
    return ((rng.randn(CFG.d_model, r) * 0.5).astype(np.float32),
            (rng.randn(r, V) * 0.5).astype(np.float32))


def _trees_equal(a, b):
    fa, fb = _flatten(a), _flatten(b)
    return [p for p, _ in fa] == [p for p, _ in fb] and all(
        np.array_equal(np.asarray(x), np.asarray(y)) for (_, x), (_, y) in zip(fa, fb))


def _drain(engine, limit=2000):
    steps = 0
    while not engine.idle():
        engine.step()
        steps += 1
        assert steps < limit, "engine failed to drain"


def _engine(model, **kw):
    cfg = dict(num_slots=2, slot_len=64, max_new_tokens=8, eos_token_id=None)
    cfg.update(kw)
    return InferenceEngine(model, EngineConfig(**cfg), auto_start=False)


# -- the store ---------------------------------------------------------------------------


def test_store_roundtrip_versions_and_gc(lm, tmp_path):
    _, params = lm
    model = _port(params)
    ws = WeightStore(str(tmp_path))
    assert ws.latest_version() is None
    v1 = ws.publish(model.state_dict(), metadata={"iteration": 1})
    assert ws.versions() == [v1] == [1]
    assert _trees_equal(ws.load(), params)          # the JAX package's layout
    loaded = tlm.params_from_jax(ws.load())
    assert all(torch.equal(loaded[k], v) for k, v in model.state_dict().items())
    man = ws.manifest(v1)
    assert man["kind"] == "full" and man["metadata"]["iteration"] == 1
    v2, v3 = ws.publish(params), ws.publish(params)
    assert ws.gc(keep=2) == [v1] and ws.versions() == [v2, v3]
    with pytest.raises(KeyError):
        ws.manifest(v1)
    with pytest.raises(KeyError):
        ws.load(v1)


def test_store_adapter_roundtrip_and_gc_exemption(lm, tmp_path):
    _, params = lm
    ws = WeightStore(str(tmp_path))
    ws.publish(params)
    a, b = _adapter(0, 4)
    va = ws.publish_adapter("tenant-a", a, b)
    name, la, lb = ws.load_adapter(va)
    assert name == "tenant-a" and np.array_equal(la, a) and np.array_equal(lb, b)
    with pytest.raises(ValueError):
        ws.load_adapter(1)                          # version 1 is a full one
    ws.publish(params), ws.publish(params)
    ws.gc(keep=1)
    assert va in ws.versions()


def test_torn_publish_never_goes_live_and_the_retry_reclaims_it(tmp_path, _clean_faults):
    params = {"a": np.arange(6, dtype=np.float32), "b": np.ones((2, 3), np.float32)}
    ws = WeightStore(str(tmp_path))
    v1 = ws.publish(params)
    faults.install(faults.FaultPlan(specs=[faults.FaultSpec("weights.publish", "kill", at=2)]))
    with pytest.raises(TornPublishError):
        ws.publish(params)
    faults.clear()
    assert ws.latest_version() == v1 and _trees_equal(ws.load(), params)
    v2 = ws.publish({"a": params["a"] * 2, "b": params["b"] * 2})
    assert v2 == v1 + 1 and np.array_equal(ws.load(v2)["a"], params["a"] * 2)


def test_load_rejects_corrupt_and_missing_shards(tmp_path):
    params = {"a": np.arange(6, dtype=np.float32), "b": np.ones((2, 3), np.float32)}
    ws = WeightStore(str(tmp_path / "one"))
    v = ws.publish(params)
    oid = ws.manifest(v)["tensors"][0]["object_id"]
    ws._store.delete(oid)
    ws._store.put(np.arange(6, dtype=np.float32) + 99.0, oid)
    with pytest.raises(WeightsIntegrityError, match="crc32"):
        ws.load(v)
    ws2 = WeightStore(str(tmp_path / "two"))
    v2 = ws2.publish(params)
    ws2._store.delete(ws2.manifest(v2)["tensors"][1]["object_id"])
    with pytest.raises(WeightsIntegrityError, match="missing"):
        ws2.load(v2)


def test_corrupt_publish_fault_passes_checksums(tmp_path, _clean_faults):
    params = {"a": np.arange(6, dtype=np.float32), "b": np.ones((2, 3), np.float32)}
    ws = WeightStore(str(tmp_path))
    faults.install(faults.FaultPlan(specs=[faults.FaultSpec("weights.publish", "corrupt", at=1)]))
    v = ws.publish(params)
    faults.clear()
    bad = ws.load(v)                                # no WeightsIntegrityError
    assert not np.array_equal(bad["a"], params["a"]) and np.array_equal(bad["b"], params["b"])


# -- across the two packages ---------------------------------------------------------------


def test_jax_store_reads_what_the_port_publishes(lm, tmp_path):
    _, params = lm
    model = _port(params)
    v = WeightStore(str(tmp_path)).publish(model.state_dict(), metadata={"iteration": 3})
    jstore = jweights.WeightStore(str(tmp_path))
    assert jstore.versions() == [v] and jstore.manifest(v)["metadata"]["iteration"] == 3
    assert _trees_equal(jstore.load(v), params)


def test_probe_fingerprint_equals_the_jax_packages(lm):
    jmodel, params = lm
    prompts = _prompts(11, 3)
    want = jweights.compute_probe(jmodel, params, prompts, max_new=6)
    got = compute_probe(_port(params), prompts, max_new=6)
    assert got["tokens"] == want["tokens"] and got["fingerprint"] == want["fingerprint"]


def test_mixed_tenants_equal_the_jax_engine(lm):
    jmodel, params = lm
    a1, b1 = _adapter(5, 4)
    a2, b2 = _adapter(6, 2)
    prompts = _prompts(51, 6)
    tenants = [None, "tenant-a", "tenant-b"] * 2
    jengine = JInferenceEngine(jmodel, params, JEngineConfig(
        num_slots=3, slot_len=64, max_new_tokens=8, adapter_slots=2, adapter_rank=4),
        auto_start=False)
    engine = _engine(_port(params), num_slots=3, adapter_slots=2, adapter_rank=4)
    out = []
    for e in (jengine, engine):
        e.load_adapter("tenant-a", a1, b1)
        e.load_adapter("tenant-b", a2, b2)
        streams = [e.submit(p, adapter_id=t) for p, t in zip(prompts, tenants)]
        _drain(e)
        out.append([s.result(1) for s in streams])
        e.close()
    assert out[0] == out[1]


# -- swaps -------------------------------------------------------------------------------


def test_same_weights_swap_midstream_is_token_invisible(lm):
    _, params = lm
    model = _port(params)
    prompts = _prompts(21, 4)
    engine = _engine(model, max_new_tokens=10)
    streams = [engine.submit(p) for p in prompts]
    engine.step()
    engine.step()                                   # slots mid-decode, queue not empty
    stall_ms = engine.swap_params(tlm.params_from_jax(params), version=2)
    assert stall_ms >= 0.0 and engine.weights_version() == 2
    _drain(engine)
    for p, s in zip(prompts, streams):
        assert s.result(1) == offline_greedy(_port(params), p, 10)
    snap = engine.metrics.snapshot()
    assert snap["requests_completed"] == 4 and snap["weights"]["swaps"] == 1
    assert snap["weights"]["last_stall_ms"] == pytest.approx(stall_ms)


def test_swap_under_threaded_load_drops_no_stream(lm):
    _, params = lm
    half = jax.tree_util.tree_map(lambda x: x * np.float32(0.5), params)
    prompts = _prompts(31, 6)
    with InferenceEngine(_port(params), EngineConfig(num_slots=2, slot_len=64, max_new_tokens=12,
                                                     eos_token_id=None)) as engine:
        results, errors = [None] * len(prompts), []

        def consume(i, p):
            try:
                results[i] = list(engine.submit(p))
            except Exception as e:  # noqa: BLE001 — recorded, asserted empty
                errors.append((i, repr(e)))

        threads = [threading.Thread(target=consume, args=(i, p), daemon=True)
                   for i, p in enumerate(prompts)]
        for t in threads:
            t.start()
        time.sleep(0.05)
        engine.swap_params(tlm.params_from_jax(half), version=2)
        for t in threads:
            t.join(timeout=120.0)
            assert not t.is_alive()
        assert errors == [] and all(r is not None and len(r) == 12 for r in results)
        fresh = _prompts(32, 1)[0]
        assert list(engine.submit(fresh)) == offline_greedy(_port(half), fresh, 12)


def test_rollback_restores_once(lm):
    _, params = lm
    model = _port(params)
    bad = tlm.params_from_jax(jax.tree_util.tree_map(lambda x: x * -1 + 1, params))
    prompt = _prompts(41, 1)[0]
    engine = _engine(model)
    engine.swap_params(bad, version=2)
    engine.rollback_params()
    assert engine.weights_version() is None
    s = engine.submit(prompt)
    _drain(engine)
    assert s.result(1) == offline_greedy(_port(params), prompt, 8)
    snap = engine.metrics.snapshot()["weights"]
    assert snap["swaps"] == 2 and snap["rollbacks"] == 1
    with pytest.raises(RuntimeError):
        engine.rollback_params()                    # one prior set is kept


@pytest.mark.parametrize("wrong", ["key", "shape"])
def test_swap_with_a_wrong_key_or_shape_changes_nothing(lm, wrong):
    _, params = lm
    model = _port(params)
    engine = _engine(model)
    state = tlm.params_from_jax(params)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    step = engine._decode_step
    if wrong == "key":
        state["nope"] = state.pop("final_norm.weight")
    else:
        state["final_norm.weight"] = torch.ones(CFG.d_model + 1)
    with pytest.raises(ValueError, match="weight swap rejected"):
        engine.swap_params(state, version=9)
    assert engine.weights_version() is None and engine._decode_step is step
    assert all(torch.equal(model.state_dict()[k], v) for k, v in before.items())
    with pytest.raises(RuntimeError):
        engine.rollback_params()                    # nothing was swapped


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_swap_renews_the_step_functions_cached_head(lm, dtype):
    """The step functions hold the f32 head (a view of an f32 embedding, a
    copy of a bf16 one): after a swap to weights with another head the
    next tokens are those of an engine built on the new weights."""
    _, params = lm
    new = jax.tree_util.tree_map(np.copy, params)
    new["embedding"] = np.random.RandomState(7).randn(*params["embedding"].shape).astype(
        np.float32)
    prompts = _prompts(61, 2)

    def run(engine):
        streams = [engine.submit(p) for p in prompts]
        _drain(engine)
        return [s.result(1) for s in streams]

    old_tokens = run(_engine(_port(params, dtype)))
    engine = _engine(_port(params, dtype))
    engine.swap_params(tlm.params_from_jax(new))
    got = run(engine)
    assert got == run(_engine(_port(new, dtype))) and got != old_tokens


# -- adapters ----------------------------------------------------------------------------


def test_adapter_parity_mixed_tenants_vs_offline(lm):
    _, params = lm
    model = _port(params)
    a1, b1 = _adapter(5, 4)
    a2, b2 = _adapter(6, 2)
    prompts = _prompts(51, 3)
    engine = _engine(model, num_slots=3, adapter_slots=2, adapter_rank=4)
    assert engine.load_adapter("tenant-a", a1, b1) == 1
    assert engine.load_adapter("tenant-b", a2, b2) == 2    # rank 2 zero-pads into 4
    assert engine.adapters() == {"tenant-a": 1, "tenant-b": 2}
    streams = [engine.submit(prompts[0]), engine.submit(prompts[1], adapter_id="tenant-a"),
               engine.submit(prompts[2], adapter_id="tenant-b")]
    _drain(engine)
    assert streams[0].result(1) == offline_greedy(model, prompts[0], 8)
    assert streams[1].result(1) == offline_greedy(model, prompts[1], 8, a1, b1)
    assert streams[2].result(1) == offline_greedy(model, prompts[2], 8, a2, b2)
    assert streams[1].result(1) != offline_greedy(model, prompts[1], 8)


def test_adapter_lifecycle_guards(lm):
    _, params = lm
    engine = _engine(_port(params), max_new_tokens=4, adapter_slots=1, adapter_rank=4)
    a, b = np.zeros((CFG.d_model, 4), np.float32), np.zeros((4, V), np.float32)
    with pytest.raises(RequestValidationError, match="unknown adapter"):
        engine.submit([1, 2, 3], adapter_id="ghost")
    with pytest.raises(ValueError, match="rank 8 exceeds"):
        engine.load_adapter("fat", np.zeros((CFG.d_model, 8), np.float32),
                            np.zeros((8, V), np.float32))
    engine.load_adapter("a", a, b)
    with pytest.raises(ValueError, match="bank full"):
        engine.load_adapter("b", a, b)
    assert engine.load_adapter("a", a, b) == 1      # reloaded in place
    s = engine.submit([1, 2, 3], adapter_id="a")
    engine.step()
    with pytest.raises(RuntimeError, match="active slots"):
        engine.unload_adapter("a")
    _drain(engine)
    assert len(s.result(1)) == 4
    assert engine.unload_adapter("a") is True and engine.unload_adapter("a") is False
    assert engine.adapters() == {}


def test_adapters_are_refused_on_a_slab_engine(lm):
    _, params = lm
    with pytest.raises(ValueError, match="paged"):
        _engine(_port(params), kv_mode="slab", adapter_slots=1)
    with pytest.raises(RequestValidationError, match="adapter_slots"):
        _engine(_port(params), kv_mode="slab").submit([1, 2], adapter_id="t")


# -- the trainer's handoff -----------------------------------------------------------------


def test_session_publishes_every_retained_checkpoint(lm, tmp_path):
    from tpu_air_torch.train.config import CheckpointConfig
    from tpu_air_torch.train.session import Session

    _, params = lm
    model = _port(params)
    root = str(tmp_path / "w")
    sess = Session(str(tmp_path / "run"), CheckpointConfig(num_to_keep=2, publish_weights_to=root))
    for it in range(3):
        sess.report({"loss": 1.0 / (it + 1)}, Checkpoint.from_model(
            model_config=model.config, params=model.state_dict()))
    ws = WeightStore(root)
    assert len(ws.versions()) == 2                  # kept to num_to_keep
    man = ws.manifest(ws.latest_version())
    assert man["metadata"]["iteration"] == 3
    assert man["metadata"]["metrics"]["loss"] == pytest.approx(1.0 / 3)
    assert _trees_equal(ws.load(), params)
    # a torn publish does not stop training and leaves the store as it was
    faults.install(faults.FaultPlan(specs=[faults.FaultSpec("weights.publish", "kill", at=1)]))
    try:
        sess.report({"loss": 0.1}, Checkpoint.from_model(
            model_config=model.config, params=model.state_dict()))
    finally:
        faults.clear()
    assert len(ws.versions()) == 2 and len(sess.history) == 4


# -- the canary controller through EngineDeployment ---------------------------------------


@pytest.fixture(scope="module")
def tair():
    tpu_air_torch.init(num_cpus=4, num_chips=1)
    yield tpu_air_torch
    serve.shutdown()
    tpu_air_torch.shutdown()


@pytest.fixture
def served(tair):
    yield
    serve.shutdown()


@pytest.fixture(scope="module")
def lm_ckpt(lm, tmp_path_factory):
    model = _port(lm[1])
    return Checkpoint.from_model(model_config=model.config, params=model.state_dict(),
                                 path=str(tmp_path_factory.mktemp("weights_ckpt")))


def _post(path, payload, headers=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{PORT}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", **(headers or {})}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.loads(resp.read()), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


class _StreamClient(threading.Thread):
    """Submit one stream, then poll it (pinned) to the end, recording any
    non-200 after admission."""

    def __init__(self, path, prompt, max_new):
        super().__init__(daemon=True)
        self.path, self.prompt, self.max_new = path, prompt, max_new
        self.admitted = threading.Event()
        self.tokens = None
        self.bad_status = []

    def run(self):
        status, out, hdrs = _post(self.path, {"action": "submit", "prompt": self.prompt,
                                              "max_new_tokens": self.max_new})
        if status != 200:
            self.bad_status.append(("submit", status, out))
            return
        self.admitted.set()
        pin = {"x-tpu-air-replica": hdrs.get("x-tpu-air-replica", "")}
        toks = []
        deadline = time.monotonic() + 120.0
        while time.monotonic() < deadline:
            status, res, _ = _post(self.path, {"action": "poll", "request_id": out["request_id"],
                                               "cursor": len(toks)}, headers=pin)
            if status != 200:
                self.bad_status.append(("poll", status, res))
                return
            toks += res.get("tokens") or []
            if res.get("done"):
                self.tokens = toks
                return
            time.sleep(0.01)


def _deploy(ckpt, route, replicas=2, **engine_kw):
    cfg = dict(num_slots=4, slot_len=64, max_new_tokens=16, eos_token_id=None)
    cfg.update(engine_kw)
    return serve.run(EngineDeployment.options(name=route.strip("/"), route_prefix=route,
                                              num_replicas=replicas)
                     .bind(ckpt, EngineConfig(**cfg), device="cpu"), port=PORT)


def test_controller_promotes_the_fleet_under_inflight_streams(lm, lm_ckpt, served, tmp_path):
    _, params = lm
    model = _port(params)
    prompts, probe_prompts = _prompts(61, 3), _prompts(62, 2)
    h = _deploy(lm_ckpt, "/weights")
    root = str(tmp_path / "w")
    v = WeightStore(root).publish(model.state_dict(), metadata={"iteration": 1},
                                  probe=compute_probe(model, probe_prompts, max_new=4))
    ctl = attach_weights("/weights", root, probe_prompts=probe_prompts, probe_max_new=4,
                         soak_s=0.2)
    try:
        clients = [_StreamClient("/weights", p, 16) for p in prompts]
        for c in clients:
            c.start()
        for c in clients:
            assert c.admitted.wait(timeout=120.0), c.bad_status
        out = ctl.promote()
        assert out["promoted"] and out["version"] == v and out["max_stall_ms"] >= 0.0
        for c, p in zip(clients, prompts):
            c.join(timeout=180.0)
            assert not c.is_alive() and c.bad_status == []
            assert c.tokens == offline_greedy(model, p, 16)
        st = serve_control_stats()["weights"]["/weights"]
        assert st["state"] == "serving" and st["current_version"] == v
        assert st["promotions"] == 1
        versions = [tpu_air_torch.get(r.handle.remote("weights_version", (), {}))
                    for r in h._replicas]
        assert versions == [v, v]
    finally:
        uninstall_controller("/weights")


def test_corrupt_publish_rolls_back_with_no_non200(lm, lm_ckpt, served, tmp_path, _clean_faults):
    _, params = lm
    model = _port(params)
    prompts, probe_prompts = _prompts(71, 4), _prompts(72, 2)
    h = _deploy(lm_ckpt, "/badw")
    root = str(tmp_path / "w")
    store = WeightStore(root)
    probe = compute_probe(model, probe_prompts, max_new=4)
    faults.install(faults.FaultPlan(specs=[faults.FaultSpec("weights.publish", "corrupt", at=1)]))
    v_bad = store.publish(model.state_dict(), probe=probe)
    faults.clear()
    assert not _trees_equal(store.load(v_bad), params)     # valid checksums, bad values
    ctl = attach_weights("/badw", root, probe_prompts=probe_prompts, probe_max_new=4,
                         soak_s=0.2)
    try:
        clients = [_StreamClient("/badw", p, 16) for p in prompts]
        for c in clients:
            c.start()
        for c in clients:
            assert c.admitted.wait(timeout=120.0), c.bad_status
        out = ctl.promote()
        assert not out["promoted"] and "fingerprint" in out["reason"]
        for c in clients:
            c.join(timeout=180.0)
            assert not c.is_alive() and c.bad_status == []
            assert c.tokens is not None and len(c.tokens) == 16
        status, stats, _ = _post("/-/stats", {})
        st = stats["weights"]["/badw"]
        assert st["rollbacks"] == 1 and st["gate_failures"] == {"probe": 1}
        assert st["current_version"] is None
        swaps = [tpu_air_torch.get(r.handle.remote("stats", (), {})).get("weights", {})
                 for r in h._replicas]
        assert sorted(w.get("swaps", 0) for w in swaps) == [0, 2]   # the canary only
        p = probe_prompts[0]
        status, body, _ = _post("/badw", {"prompts": [p], "max_new_tokens": 4})
        assert status == 200 and body["results"][0]["tokens"] == offline_greedy(model, p, 4)
    finally:
        uninstall_controller("/badw")


def test_adapter_promotion_and_eviction_go_through_the_gate(lm, lm_ckpt, served, tmp_path):
    from tpu_air_torch.serve import WeightsController

    _, params = lm
    model = _port(params)
    a, b = _adapter(9, 4)
    probe_prompts = _prompts(81, 2)
    h = _deploy(lm_ckpt, "/adpt", num_slots=2, max_new_tokens=8, adapter_slots=2)
    root = str(tmp_path / "w")
    va = WeightStore(root).publish_adapter(
        "tenant-a", a, b, probe=compute_probe(model, probe_prompts, max_new=4,
                                              adapter_a=a, adapter_b=b))
    ctl = WeightsController(h, root, probe_prompts=probe_prompts, probe_max_new=4, soak_s=0.1)
    out = ctl.promote(va)
    assert out["promoted"] and out["adapter"] == "tenant-a"
    p = probe_prompts[0]
    want = offline_greedy(model, p, 4, adapter_a=a, adapter_b=b)
    for _ in range(4):                               # whichever replica takes it
        status, body, _ = _post("/adpt", {"prompts": [p], "max_new_tokens": 4,
                                          "adapter_id": "tenant-a"})
        assert status == 200 and body["results"][0]["tokens"] == want
    status, body, _ = _post("/adpt", {"prompts": [p], "adapter_id": "ghost"})
    assert status == 400 and "RequestValidationError" in body["error"]
    assert ctl.evict_adapter("tenant-a") == 2
    status, _, _ = _post("/adpt", {"prompts": [p], "adapter_id": "tenant-a"})
    assert status == 400


def test_tenant_over_its_quota_gets_429(lm, lm_ckpt, served):
    from tpu_air_torch.serve.admission import AdmissionPolicy

    a, b = _adapter(9, 4)
    prompt = _prompts(31, 1)[0]
    h = serve.run(EngineDeployment.options(name="quota", route_prefix="/quota", num_replicas=1)
                  .bind(lm_ckpt, EngineConfig(num_slots=2, slot_len=64, max_new_tokens=24,
                                              adapter_slots=2), device="cpu"),
                  port=PORT, admission_policy=AdmissionPolicy(
                      queue_hard=1.0, tenant_queue_shares={"tenant-a": 0.2},
                      retry_after_s=2.0))
    for r in h._replicas:
        tpu_air_torch.get(r.handle.remote("weights_load_adapter", ("tenant-a", a, b), {}))
    status, out1, hdrs1 = _post("/quota", {"action": "submit", "prompt": prompt,
                                           "max_new_tokens": 24, "adapter_id": "tenant-a"})
    assert status == 200, out1
    status, out, hdrs = _post("/quota", {"action": "submit", "prompt": prompt,
                                         "max_new_tokens": 4, "adapter_id": "tenant-a"})
    assert status == 429 and "QuotaExceededError" in out["error"]
    assert float(hdrs["Retry-After"]) == 2.0
    status, out2, _ = _post("/quota", {"action": "submit", "prompt": prompt,
                                       "max_new_tokens": 4})
    assert status == 200, out2                      # the base tenant rides through
