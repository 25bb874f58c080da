"""The port's serve plane (``tpu_air_torch.serve``) on the CPU: the cases of
tests/test_serve.py on the port's runtime, W8 (``PredictorDeployment`` over
``GBDTPredictor``) against the JAX package's in-process predictions, the
tiny T5 through ``PredictorDeployment`` and through ``EngineDeployment``
against their in-process counterparts, every branch the port refuses, and the
causal-LM branches that it once refused (the LM engine's own serving tests
are in tests/test_torch_lm_engine.py, on a port of their own).

Isolation from the JAX package's tests, which run beside these in other
processes: this file binds one port of its own (``PORT``, no other test file
uses it), runs the port's runtime from a module fixture, shuts the serve
plane down after every test, crashes only replicas it started (through an
exit inside the replica or the port runtime's ``crash_actor``), starts at
most 2 replicas at a time, and loads only tiny models.
"""

import json
import os
import time
import urllib.error
import urllib.request

import numpy as np
import pandas as pd
import pytest

import tpu_air_torch
from tpu_air_torch import serve
from tpu_air_torch.core import runtime as rt
from tpu_air_torch.engine import EngineConfig, InferenceEngine, T5Engine, T5EngineConfig
from tpu_air_torch.models.t5.config import T5Config
from tpu_air_torch.models.t5.modeling import T5ForConditionalGeneration
from tpu_air_torch.models.tokenizer import ByteTokenizer
from tpu_air_torch.predict import GBDTPredictor, Predictor, T5GenerativePredictor
from tpu_air_torch.serve import EngineDeployment, PredictorDeployment, pandas_read_json
from tpu_air_torch.train import Checkpoint

PORT = 8351
FEATURES = ["trip_distance", "pickup_hour", "passenger_count", "fare_amount"]


@pytest.fixture(scope="module")
def tair():
    tpu_air_torch.init(num_cpus=4, num_chips=1)
    yield tpu_air_torch
    serve.shutdown()
    tpu_air_torch.shutdown()


@pytest.fixture(autouse=True)
def _teardown(tair):
    yield
    serve.shutdown()


def _post(path, payload, port=PORT, headers=None):
    """(status, body) of a JSON POST; HTTP errors come back as their code."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", **(headers or {})}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.loads(resp.read()), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def _who(num_replicas, name, **opts):
    @serve.deployment
    class WhoAmI:
        def __init__(self):
            self.pid = os.getpid()

        def __call__(self, payload):
            return {"pid": self.pid}

        def crash(self):
            os._exit(17)

    return serve.run(WhoAmI.options(name=name, num_replicas=num_replicas,
                                    route_prefix=f"/{name}", **opts).bind(), port=PORT)


# -- the serve plane (tests/test_serve.py's cases) ---------------------------------


def test_deployment_options_and_bind():
    @serve.deployment
    class Echo:
        def __call__(self, payload):
            return payload

    d = Echo.options(name="echo", num_replicas=3, route_prefix="/echo",
                     ray_actor_options={"num_chips": 1})
    assert (d.name, d.num_replicas, d.num_chips) == ("echo", 3, 1.0)
    app = d.bind(1, k=2)
    assert app.deployment.route_prefix == "/echo"
    assert (app.init_args, app.init_kwargs) == ((1,), {"k": 2})
    with pytest.raises(TypeError, match="bound Application"):
        serve.run(d)


def test_http_round_trip_json_and_status():
    @serve.deployment
    class Doubler:
        def __call__(self, payload):
            return {"doubled": [2 * x for x in payload["values"]]}

    serve.run(Doubler.options(name="doubler", num_replicas=2,
                              route_prefix="/double").bind(), port=PORT)
    status, out, headers = _post("/double", {"values": [1, 2, 3]})
    assert status == 200 and out == {"doubled": [2, 4, 6]}
    assert headers.get("x-tpu-air-replica")
    st = serve.status()
    assert st["proxy"] == {"port": PORT, "running": True}
    assert st["deployments"]["/double"] == {"name": "doubler", "num_replicas": 2}
    with pytest.raises(RuntimeError, match="already running"):
        serve.run(Doubler.options(name="other", route_prefix="/x").bind(), port=PORT + 1)


def test_routes_healthz_and_404():
    @serve.deployment
    class Ok:
        def __call__(self, payload):
            return "ok"

    serve.run(Ok.options(name="ok", route_prefix="/ok").bind(), port=PORT)
    status, routes, _ = _post("/-/routes", {})
    assert status == 200 and routes == {"/ok": "ok"}
    status, health, _ = _post("/-/healthz", {})
    assert status == 200 and health["deployments"]["/ok"]["live_replicas"] == 1
    status, stats, _ = _post("/-/stats", {})
    assert status == 200 and "/ok" in stats and stats["recovery"]["replays"] == 0
    assert _post("/nope", {})[0] == 404


def test_replica_load_balancing():
    h = _who(2, "who")
    assert h.num_replicas() == 2
    pids = {_post("/who", {})[1]["pid"] for _ in range(6)}
    assert len(pids) == 2 and os.getpid() not in pids


def test_replica_crash_failover_and_restart():
    """One replica exits mid-traffic: every request still succeeds, and the
    controller brings the group back to two replicas."""
    h = _who(2, "who2")
    assert _post("/who2", {})[0] == 200
    victim = h._replicas[0]
    with pytest.raises(tpu_air_torch.RemoteError, match="WorkerCrashed|ActorDiedError"):
        tpu_air_torch.get(victim.handle.remote("crash", (), {}), timeout=30)
    for _ in range(6):
        status, out, _ = _post("/who2", {})
        assert status == 200 and "pid" in out
    deadline = time.time() + 30
    while time.time() < deadline and h.live_replicas() < 2:
        time.sleep(0.2)
    assert h.live_replicas() == 2, "dead replica was not respawned"
    assert victim not in h._replicas
    pids = {_post("/who2", {})[1]["pid"] for _ in range(8)}
    assert len(pids) == 2


def test_all_replicas_dead_gives_503():
    """With restarts off, a dead deployment is 503 (not a hang, not 500) and
    /-/healthz reports degraded before any request is routed."""
    h = _who(1, "solo", max_restarts=0)
    assert _post("/solo", {})[0] == 200
    assert rt.get_runtime().crash_actor(h._replicas[0]._actor_id)
    deadline = time.time() + 10
    while time.time() < deadline and h.live_replicas():
        time.sleep(0.05)
    status, health, _ = _post("/-/healthz", {})
    assert status == 503 and health["status"] == "degraded"
    assert health["deployments"]["/solo"]["live_replicas"] == 0
    status, out, _ = _post("/solo", {})
    assert status == 503, out


def test_application_errors_are_500_not_failover():
    @serve.deployment
    class Flaky:
        def __call__(self, payload):
            raise ValueError("bad payload")

    h = serve.run(Flaky.options(name="flaky", route_prefix="/flaky").bind(), port=PORT)
    for _ in range(3):
        status, out, _ = _post("/flaky", {})
        assert status == 500 and "ValueError" in out["error"]
    assert h.num_replicas() == 1


def test_predictor_deployment_over_checkpoint():
    """The cc-71 call shape over a Predictor of the test's own."""

    class LinearPredictor(Predictor):
        def __init__(self, w, b, preprocessor=None):
            super().__init__(preprocessor)
            self.w, self.b = w, b

        @classmethod
        def from_checkpoint(cls, checkpoint, **kw):
            d = checkpoint.to_dict()
            return cls(d["w"], d["b"])

        def _predict_pandas(self, df, **kw):
            x = df[["x"]].to_numpy(dtype=float)
            return pd.DataFrame({"predictions": (x * self.w + self.b).ravel()})

    serve.run(PredictorDeployment.options(name="LinearService", num_replicas=2,
                                          route_prefix="/linear")
              .bind(LinearPredictor, Checkpoint.from_dict({"w": 2.0, "b": 1.0}),
                    http_adapter=pandas_read_json), port=PORT)
    status, out, _ = _post("/linear", [{"x": 1.0}, {"x": 3.0}])
    assert status == 200 and [r["predictions"] for r in out] == [3.0, 7.0]


# -- W8: GBDT through PredictorDeployment ----------------------------------------------


def _taxi_like(n, seed):
    rng = np.random.default_rng(seed)
    dist = rng.gamma(2.0, 2.0, n)
    hour = rng.integers(0, 24, n)
    df = pd.DataFrame({"trip_distance": dist, "pickup_hour": hour,
                       "passenger_count": rng.integers(1, 5, n),
                       "fare_amount": 3.0 + 2.5 * dist + rng.normal(0, 1, n)})
    p = 1 / (1 + np.exp(-(0.25 * dist - 0.05 * np.abs(12 - hour))))
    df["is_big_tip"] = (rng.uniform(size=n) < p).astype(int)
    return df


def test_w8_gbdt_predictor_deployment_matches_jax(air, tmp_path):
    """W8's serve step: two replicas of PredictorDeployment over the best
    GBDT checkpoint with a MinMaxScaler; the HTTP answers equal the JAX
    package's GBDTPredictor in process, trained on the same seeded rows."""
    from tpu_air import data as jdata
    from tpu_air.data import MinMaxScaler as JMinMaxScaler
    from tpu_air.predict import GBDTPredictor as JGBDTPredictor
    from tpu_air.train import GBDTTrainer as JGBDTTrainer
    from tpu_air.train import RunConfig as JRunConfig
    from tpu_air_torch.data import MinMaxScaler, from_pandas
    from tpu_air_torch.train import GBDTTrainer, RunConfig

    train, valid, rows = _taxi_like(160, 1), _taxi_like(48, 2), _taxi_like(12, 3)
    params = {"objective": "binary:logistic", "max_depth": 3, "eta": 0.3}
    got = GBDTTrainer(label_column="is_big_tip", params=params, num_boost_round=5,
                      datasets={"train": from_pandas(train), "valid": from_pandas(valid)},
                      preprocessor=MinMaxScaler(columns=FEATURES),
                      run_config=RunConfig(storage_path=str(tmp_path / "port"))).fit()
    want = JGBDTTrainer(label_column="is_big_tip", params=params, num_boost_round=5,
                        datasets={"train": jdata.from_pandas(train),
                                  "valid": jdata.from_pandas(valid)},
                        preprocessor=JMinMaxScaler(columns=FEATURES),
                        run_config=JRunConfig(storage_path=str(tmp_path / "jax"))).fit()
    assert got.error is None and want.error is None
    serve.run(PredictorDeployment.options(name="XGBoostService", num_replicas=2,
                                          route_prefix="/rayair")
              .bind(GBDTPredictor, got.checkpoint, http_adapter=pandas_read_json), port=PORT)
    feats = rows[FEATURES]
    status, out, _ = _post("/rayair", feats.to_dict(orient="records"))
    assert status == 200, out
    ref = JGBDTPredictor.from_checkpoint(want.checkpoint).predict(feats)["predictions"]
    np.testing.assert_array_equal([r["predictions"] for r in out], ref.to_numpy())
    single = [_post("/rayair", [r])[1][0]["predictions"] for r in feats.to_dict("records")[:4]]
    np.testing.assert_array_equal(single, ref.to_numpy()[:4])


# -- the tiny T5 through both deployments ------------------------------------------------


@pytest.fixture(scope="module")
def t5_ckpt():
    cfg = T5Config.tiny()
    model = T5ForConditionalGeneration(cfg, device="cpu").init_weights(0)
    return Checkpoint.from_model(model_config=cfg, params=model.state_dict())


def _prompts(seed, n, lo=3, hi=8, vocab=384):
    rng = np.random.RandomState(seed)
    return [list(map(int, rng.randint(2, vocab, size=rng.randint(lo, hi))))
            for _ in range(n)]


def test_t5_predictor_deployment_matches_in_process(t5_ckpt):
    prompts = _prompts(3, 4)
    L = max(map(len, prompts))
    ids = np.zeros((4, L), np.int64)
    for r, p in enumerate(prompts):
        ids[r, :len(p)] = p
    df = pd.DataFrame({"input_ids": list(ids), "attention_mask": list((ids != 0).astype(np.int64))})
    kw = dict(dtype=None, device="cpu", tokenizer=ByteTokenizer())
    serve.run(PredictorDeployment.options(name="T5Service", route_prefix="/t5")
              .bind(T5GenerativePredictor, t5_ckpt, http_adapter=pandas_read_json,
                    predict_kwargs={"max_new_tokens": 6}, **kw), port=PORT)
    status, out, _ = _post("/t5", [{"input_ids": r.tolist(), "attention_mask": m.tolist()}
                                   for r, m in zip(df["input_ids"], df["attention_mask"])])
    assert status == 200, out
    want = T5GenerativePredictor.from_checkpoint(t5_ckpt, **kw).predict(df, max_new_tokens=6)
    assert [r["generated_output"] for r in out] == want["generated_output"].tolist()


ENGINE = dict(max_batch=2, max_input_len=8, max_new_tokens=6)


def test_engine_deployment_blocking_and_streams_match_in_process(t5_ckpt):
    prompts = _prompts(71, 5)
    with T5Engine(t5_ckpt.get_model(device="cpu"), T5EngineConfig(**ENGINE),
                  name="in-process") as engine:
        want = engine.generate(prompts, timeout=60.0)
    h = serve.run(EngineDeployment.options(name="t5-engine", route_prefix="/engine")
                  .bind(t5_ckpt, T5EngineConfig(**ENGINE), device="cpu"), port=PORT)
    assert tpu_air_torch.get(h.method("stats")()) == {}   # built at the first request
    status, out, _ = _post("/engine", {"prompts": prompts})
    assert status == 200, out
    assert [r["tokens"] for r in out["results"]] == want

    # submit/poll over HTTP, polls pinned by the replica header
    streams = []
    for p in prompts:
        status, sub, headers = _post("/engine", {"action": "submit", "prompt": p,
                                                 "max_new_tokens": 6})
        assert status == 200, sub
        streams.append((sub["request_id"], headers["x-tpu-air-replica"]))
    got = []
    for rid, tag in streams:
        toks, deadline = [], time.time() + 60
        while time.time() < deadline:
            status, res, _ = _post("/engine", {"action": "poll", "request_id": rid,
                                               "cursor": len(toks)},
                                   headers={"x-tpu-air-replica": tag})
            assert status == 200, res
            toks += res["tokens"]
            if res["done"]:
                break
            time.sleep(0.01)
        got.append(toks)
    assert got == want
    snap = tpu_air_torch.get(h.method("stats")())
    assert snap["device"] == "cpu" and snap["requests_completed"] == 10
    assert snap["kernel_launches"] == {"flash_attention": 0, "decode_attention": 0}
    status, stats, _ = _post("/-/stats", {})
    assert stats["recovery"]["journal_size"] == 5


def test_engine_deployment_overload_gives_503(t5_ckpt):
    serve.run(EngineDeployment.options(name="t5-full", route_prefix="/full")
              .bind(t5_ckpt, T5EngineConfig(max_queue=0, **ENGINE), device="cpu"), port=PORT)
    status, out, _ = _post("/full", {"prompts": [[5, 6, 7]]})
    assert status == 503 and "EngineOverloadedError" in out["error"]


# -- what the port refuses ----------------------------------------------------------------


def _server(t5_ckpt, **kw):
    return EngineDeployment.func_or_class(t5_ckpt, T5EngineConfig(**ENGINE), device="cpu", **kw)


def _t5_distributed(c, **kw):
    """``mesh=`` and ``disagg=`` are accepted and the replica stays lazy;
    at the first request a T5 engine config is refused with the JAX
    package's text (distributed serving is the causal LM's)."""
    srv = _server(c, **kw)
    assert srv.stats() == {}
    with pytest.raises(ValueError, match="supports the causal-LM paged engine only"):
        srv({"prompts": [[5, 6, 7]]})
    return srv._engine is None


def _engine_class(name):
    import tpu_air_torch.engine as engine
    from tpu_air_torch.engine import dist

    cls = getattr(engine, name)
    return cls is getattr(dist, name) and callable(cls.submit)


# what the port refused until sharded and disaggregated serving were
# ported: each case now answers
REFUSALS = {
    "mesh": lambda c: _t5_distributed(c, mesh=(1, 2)),
    "disagg": lambda c: _t5_distributed(c, disagg={"prefill_replicas": 1}),
    "mesh_engine": lambda c: _engine_class("MeshEngine"),
    "disagg_router": lambda c: _engine_class("DisaggRouter"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_unported_branches_refuse_naming_their_item(t5_ckpt, case):
    assert REFUSALS[case](t5_ckpt)


def _t5_call(method, *args, **kw):
    """Call ``method`` on a fresh T5 window-engine replica, closing its
    engine after; a ``"<root>"`` argument is the test's empty weight store."""
    def call(c, root):
        srv = _server(c)
        args_ = [root if a == "<root>" else a for a in args]
        try:
            return getattr(srv, method)(*args_, **kw) if method else srv(*args_, **kw)
        finally:
            srv.close()
    return call


# The LM replica's adapter, live-weight and migration branches on a T5
# replica, answered as tpu_air/serve/engine_deployment.py's replica answers
# them over its T5Engine: the window engine's submit takes no adapter_id
# (TypeError), it has no weights to swap or roll back (an empty store has no
# version to load: KeyError; rollback_params is missing: AttributeError),
# the probe decodes through it, and migration needs the paged LM engine
# (ValueError).  The weight plane's names import from the serve package.
T5_ANSWERS = {
    "adapter_submit": (_t5_call("submit", [5, 6], adapter_id="t"), TypeError),
    "adapter_http": (_t5_call(None, {"prompts": [[5, 6]], "adapter_id": "t"}), TypeError),
    "weights_swap": (_t5_call("weights_swap", "<root>"), KeyError),
    "weights_rollback": (_t5_call("weights_rollback"), AttributeError),
    "weights_probe": (_t5_call("weights_probe", [[5, 6, 7]], 4), None),
    "migrate_out": (_t5_call("migrate_out"), ValueError),
    "submit_migrated": (_t5_call("submit_migrated", {}), ValueError),
    "weight_store": (lambda c, root: serve.WeightStore.__module__, None),
    "attach_weights": (lambda c, root: serve.attach_weights("/no-such-route", root), KeyError),
}


@pytest.mark.parametrize("case", sorted(T5_ANSWERS))
def test_t5_replica_answers_lm_branches_as_the_jax_replica(t5_ckpt, tmp_path, case):
    fn, error = T5_ANSWERS[case]
    root = str(tmp_path / "weights")
    if error is not None:
        with pytest.raises(error):
            fn(t5_ckpt, root)
        return
    out = fn(t5_ckpt, root)
    if case == "weights_probe":
        assert len(out) == 1 and len(out[0]) == 4
    else:
        assert out == "tpu_air_torch.serve.weights"


@pytest.fixture(scope="module")
def lm_ckpt():
    from tpu_air_torch.models.lm import CausalLM, LMConfig

    cfg = LMConfig.tiny()
    model = CausalLM(cfg, device="cpu").init_weights(0)
    return Checkpoint.from_model(model_config=cfg, params=model.state_dict())


def _lm_engine_of(server):
    try:
        return server._ensure_engine()
    finally:
        server.close()


NOW_SERVED = {
    # an EngineConfig, or none, now builds the causal-LM slot engine
    "engine_config": lambda c: isinstance(_lm_engine_of(EngineDeployment.func_or_class(
        c, EngineConfig(num_slots=2, slot_len=64), device="cpu")), InferenceEngine),
    "no_engine_config": lambda c: _lm_engine_of(EngineDeployment.func_or_class(
        c, device="cpu")).config == EngineConfig(),
    # the engine package's LM names now import
    "inference_engine": lambda c: __import__("tpu_air_torch.engine").engine.InferenceEngine
    is InferenceEngine,
    "paged_kv_pool": lambda c: __import__("tpu_air_torch.engine").engine.PagedKVPool
    .__module__ == "tpu_air_torch.engine.kvpool.pool",
}


@pytest.mark.parametrize("case", sorted(NOW_SERVED))
def test_lm_branches_once_refused_now_work(lm_ckpt, case):
    """What this file once listed as refused for the causal LM (ROADMAP item
    6b (i)) builds or imports."""
    assert NOW_SERVED[case](lm_ckpt)


def test_publish_weights_to_names_item_6b(tmp_path):
    """``publish_weights_to``, once refused naming item 6b, publishes each
    retained checkpoint's weights to the store."""
    from tpu_air_torch.models.lm import CausalLM, LMConfig
    from tpu_air_torch.train.config import CheckpointConfig
    from tpu_air_torch.train.session import Session

    model = CausalLM(LMConfig.tiny(), device="cpu").init_weights(0)
    sess = Session(str(tmp_path / "run"),
                   CheckpointConfig(publish_weights_to=str(tmp_path / "w")))
    sess.report({"loss": 1.5}, checkpoint=Checkpoint.from_model(
        model_config=model.config, params=model.state_dict()))
    store = serve.WeightStore(str(tmp_path / "w"))
    assert store.versions() == [1]
    assert store.manifest(1)["metadata"]["metrics"]["loss"] == 1.5


def test_borrow_return_on_a_never_built_replica_returns_false(t5_ckpt):
    """As the JAX replica: no engine, so no lease to revoke and nothing to
    hand back; the call builds nothing and leaves no notice."""
    srv = _server(t5_ckpt)
    assert srv.borrow_return(5.0) is False
    assert srv._engine is None and srv._lease is None
    assert srv.preempt_status() == {"preempting": False}


def test_borrow_return_delivers_a_notice_to_the_replicas_lease(t5_ckpt):
    """On a built replica ``borrow_return`` revokes the replica's own lease:
    ``preempt_status`` turns to preempting with the notice it carried, and
    what is left of the window never exceeds it."""
    srv = _server(t5_ckpt)
    try:
        srv({"prompts": _prompts(4, 1)})
        assert srv.preempt_status() == {"preempting": False}
        assert srv.borrow_return(notice_s=5.0) is True
        st = srv.preempt_status()
        assert st["preempting"] is True and st["notice_s"] == 5.0
        assert 0.0 <= st["notice_left_s"] <= 5.0
        assert srv._lease.revoking and not srv._lease.expired
        assert srv.borrow_return(notice_s=1.0) is True   # idempotent notice
        assert srv.preempt_status()["notice_s"] == 5.0
    finally:
        srv.close()


def test_replica_reports_no_preemption_notice_and_drains(t5_ckpt):
    srv = _server(t5_ckpt)
    assert srv.preempt_status() == {"preempting": False}
    assert srv.stats() == {}
    srv.drain()                                   # never forces the build
    assert srv._engine is None and srv.drain_status()["drained"] is True
    srv = _server(t5_ckpt)
    try:
        out = srv({"prompts": _prompts(4, 2)})
        assert len(out["results"]) == 2 and srv.stats()["device"] == "cpu"
        rid = srv.submit(_prompts(5, 1)[0])
        srv.drain()
        with pytest.raises(Exception, match="draining"):
            srv.submit([5, 6])
        deadline = time.time() + 30
        while time.time() < deadline and not srv.poll(rid)["done"]:
            time.sleep(0.01)
        assert srv.drain_status() == {"draining": True, "pending_streams": 0, "drained": True}
        assert srv.poll(rid)["done"]              # a poll after the end still answers
    finally:
        srv.close()
    assert not srv._engine._thread
