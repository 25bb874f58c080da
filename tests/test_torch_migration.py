"""The port's preemption migration of paged KV on the CPU
(``tpu_air_torch.engine.dist.kv_transfer``, ``InferenceEngine.preempt`` /
``migrate_out`` / ``submit_migrated``, ``EngineDeployment``'s RPCs and the
``PreemptionWatcher``), the cases of tests/test_preemption.py on the port
plus the JAX package's payload landing in the port.

* The payload: a round trip into other page ids; each
  :class:`KVTransferError` (a missing layer, a missing k or v, a truncated
  page count, another page shape, a lossy type, bf16 -> f16 included); an
  f32 numpy payload and an ``ml_dtypes`` bf16 one are taken.
* The engine: ``preempt`` sheds submits and keeps the queue; a port -> port
  migration is token-identical to the unmigrated stream and runs no prefill
  chunk; the JAX engine's ``migrate_out`` payload lands in the port's
  ``submit_migrated`` and continues the JAX engine's unmigrated stream;
  inconsistent payloads are refused before anything is queued.
* Two CPU replicas on ``PORT`` (8359, no other test file uses it): the
  watcher's ``_migrate`` moves one replica's live streams to the other, the
  journal re-pins them, and every poller reads the whole token list.

Weights: a Flax init of ``LMConfig.tiny()`` scaled by 4, carried into the
port; f32; the decode kernel's plain version.  Tokens are compared exactly.
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
import ml_dtypes  # noqa: E402
import torch  # noqa: E402

import tpu_air_torch  # noqa: E402
from tpu_air.engine import EngineConfig as JEngineConfig  # noqa: E402
from tpu_air.engine import InferenceEngine as JInferenceEngine  # noqa: E402
from tpu_air.models import lm as jlm  # noqa: E402
from tpu_air_torch import serve  # noqa: E402
from tpu_air_torch.engine import (  # noqa: E402
    EngineConfig,
    EngineDrainingError,
    InferenceEngine,
    RequestValidationError,
)
from tpu_air_torch.engine.dist import (  # noqa: E402
    KVTransferError,
    extract_kv_pages,
    insert_kv_pages,
    payload_nbytes,
    payload_pages,
    validate_kv_payload,
)
from tpu_air_torch.models import lm as tlm  # noqa: E402
from tpu_air_torch.models.lm.modeling import AttnCache  # noqa: E402
from tpu_air_torch.serve import EngineDeployment  # noqa: E402
from tpu_air_torch.serve import proxy  # noqa: E402
from tpu_air_torch.serve.weights import offline_greedy  # noqa: E402
from tpu_air_torch.train import Checkpoint  # noqa: E402

PORT = 8359
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
    """(jax model, jax params, port model) on one set of weights."""
    jmodel = jlm.CausalLM(CFG)
    init = jmodel.init(jax.random.PRNGKey(0), jnp.ones((1, 8), jnp.int32))["params"]
    params = jax.tree_util.tree_map(lambda x: np.asarray(x) * np.float32(4), init)
    model = tlm.CausalLM(tlm.LMConfig.from_dict(CFG.to_dict()), device="cpu")
    model.load_state_dict(tlm.params_from_jax(params))
    return jmodel, params, model


def _prompts(seed, n, lo=3, hi=12):
    rng = np.random.RandomState(seed)
    return [list(map(int, rng.randint(1, V, size=rng.randint(lo, hi)))) for _ in range(n)]


def _pools(pages=6, page_len=4, d=8, dtype=torch.float32, seed=0, layers=2):
    g = torch.Generator().manual_seed(seed)
    return [AttnCache(torch.randn(pages, page_len, d, generator=g).to(dtype),
                      torch.randn(pages, page_len, d, generator=g).to(dtype),
                      torch.zeros(1, dtype=torch.long), torch.zeros(1, 2, dtype=torch.long))
            for _ in range(layers)]


def _drain(engine, limit=2000):
    steps = 0
    while not engine.idle():
        engine.step()
        steps += 1
        assert steps < limit, "engine failed to drain"


# -- the payload -------------------------------------------------------------------------


def test_payload_round_trip_into_other_page_ids():
    src, dst = _pools(seed=1), _pools(seed=2)
    payload = extract_kv_pages(src, [1, 3, 4])
    assert sorted(payload) == ["layer_0/attn", "layer_1/attn"]
    assert payload_pages(payload) == 3 and payload_nbytes(payload) == 2 * 2 * 3 * 4 * 8 * 4
    assert payload["layer_0/attn"]["k"].device.type == "cpu"
    out = insert_kv_pages(dst, [0, 2, 5], payload)
    assert out is dst                               # written in place
    for i in range(2):
        assert torch.equal(dst[i].cached_key[[0, 2, 5]], src[i].cached_key[[1, 3, 4]])
        assert torch.equal(dst[i].cached_value[[0, 2, 5]], src[i].cached_value[[1, 3, 4]])
        assert torch.equal(dst[i].cached_key[1], _pools(seed=2)[i].cached_key[1])


def _broken(case, payload):
    if case == "missing_layer":
        return {k: v for k, v in payload.items() if k != "layer_1/attn"}, "missing layer"
    if case == "missing_v":
        return {**payload, "layer_1/attn": {"k": payload["layer_1/attn"]["k"]}}, "missing 'v'"
    if case == "truncated":
        return {k: {n: t[:2] for n, t in v.items()} for k, v in payload.items()}, "truncated"
    if case == "page_shape":
        return {k: {n: t[:, :2] for n, t in v.items()} for k, v in payload.items()}, \
            "page shape mismatch"
    src_dtype = {"f32_to_bf16": torch.float32, "f16_to_bf16": torch.float16,
                 "bf16_to_f16": torch.bfloat16}[case]
    return ({k: {n: t.to(src_dtype) for n, t in v.items()} for k, v in payload.items()},
            "dtype mismatch")


@pytest.mark.parametrize("case", ["missing_layer", "missing_v", "truncated", "page_shape",
                                  "f32_to_bf16", "f16_to_bf16", "bf16_to_f16"])
def test_payload_that_does_not_fit_raises_before_any_write(case):
    payload = extract_kv_pages(_pools(seed=1), [1, 3, 4])
    bad, match = _broken(case, payload)
    dst_dtype = torch.float16 if case == "bf16_to_f16" else (
        torch.bfloat16 if case.endswith("bf16") else torch.float32)
    dst = _pools(seed=2, dtype=dst_dtype)
    before = [(c.cached_key.clone(), c.cached_value.clone()) for c in dst]
    with pytest.raises(KVTransferError, match=match):
        insert_kv_pages(dst, [0, 2, 5], bad)
    for c, (k, v) in zip(dst, before):
        assert torch.equal(c.cached_key, k) and torch.equal(c.cached_value, v)


def test_numpy_payloads_f32_and_ml_dtypes_bf16_are_taken():
    src = _pools(seed=1)
    payload = {k: {n: t.numpy() for n, t in v.items()}
               for k, v in extract_kv_pages(src, [1, 3]).items()}
    dst = _pools(seed=2)
    validate_kv_payload(dst, [4, 5], payload)
    insert_kv_pages(dst, [4, 5], payload)
    assert torch.equal(dst[1].cached_value[[4, 5]], src[1].cached_value[[1, 3]])
    # bf16 widens into f32 losslessly; the JAX package's bf16 numpy into bf16
    half = _pools(seed=3, dtype=torch.bfloat16)
    jax_bf16 = {k: {n: t.float().numpy().astype(ml_dtypes.bfloat16) for n, t in v.items()}
                for k, v in extract_kv_pages(half, [0, 2]).items()}
    for dt in (torch.bfloat16, torch.float32):
        dst = _pools(seed=4, dtype=dt)
        insert_kv_pages(dst, [1, 3], jax_bf16)
        assert torch.equal(dst[0].cached_key[[1, 3]], half[0].cached_key[[0, 2]].to(dt))


# -- the engine ----------------------------------------------------------------------------


def _engine(model, **kw):
    cfg = dict(num_slots=2, slot_len=64, max_new_tokens=16, page_len=8, eos_token_id=None)
    cfg.update(kw)
    return InferenceEngine(model, EngineConfig(**cfg), auto_start=False)


def test_preempt_sheds_submits_and_keeps_the_backlog(lm):
    engine = _engine(lm[2], num_slots=1, max_new_tokens=8)
    for p in _prompts(5, 3):
        engine.submit(p)
    engine.step()                                   # one admitted, two queued
    engine.preempt()
    assert engine.preempting
    with pytest.raises(EngineDrainingError):
        engine.submit([1, 2, 3])
    engine.step()
    assert engine.scheduler.depth() == 2            # the backlog stays queued
    engine.close()


def _migrate_mid_stream(src, prompts, at_least=4):
    streams = [src.submit(p) for p in prompts]
    for _ in range(200):
        src.step()
        if all(len(s.tokens_so_far()) >= at_least for s in streams):
            break
    assert all(at_least <= len(s.tokens_so_far()) < 16 for s in streams)
    return streams, src.migrate_out()


def test_port_to_port_migration_is_token_identical_with_no_reprefill(lm):
    model = lm[2]
    src, dst = _engine(model), _engine(model)
    prompts = _prompts(21, 2)
    streams, payloads = _migrate_mid_stream(src, prompts)
    assert src.preempting and len(payloads) == 2
    for pl in payloads:
        assert pl["pos"] == len(pl["prompt"]) + len(pl["streamed"]) - 1
    assert src.metrics.snapshot()["migrations"]["out"] == 2
    assert not any(s.done for s in streams)         # abandoned, not finished
    landed = [dst.submit_migrated(pl) for pl in payloads]
    _drain(dst)
    for p, s in zip(prompts, landed):
        assert s.result(1) == offline_greedy(model, p, 16)
    mg = dst.metrics.snapshot()["migrations"]
    assert mg["in"] == 2 and mg["in_pages"] >= 2 and mg["in_reprefill_chunks"] == 0
    assert dst._chunks_run == 0 and dst.pool.stats()["prefix_hits"] == 0


def test_jax_engine_payload_continues_in_the_port(lm):
    jmodel, params, model = lm
    prompts = _prompts(23, 2)
    ecfg = dict(num_slots=2, slot_len=64, max_new_tokens=16, page_len=8, eos_token_id=None)
    whole = JInferenceEngine(jmodel, params, JEngineConfig(**ecfg), auto_start=False)
    want = whole.generate(prompts)
    whole.close()
    jsrc = JInferenceEngine(jmodel, params, JEngineConfig(**ecfg), auto_start=False)
    _, payloads = _migrate_mid_stream(jsrc, prompts)
    jsrc.close()
    assert isinstance(payloads[0]["pages"]["layer_0/attn"]["k"], np.ndarray)
    dst = _engine(model)
    landed = [dst.submit_migrated(pl) for pl in payloads]
    _drain(dst)
    assert [s.result(1) for s in landed] == want
    assert dst.metrics.snapshot()["migrations"]["in_reprefill_chunks"] == 0


@pytest.mark.parametrize("case", ["cursor", "no_streamed", "no_budget", "pages"])
def test_inconsistent_payloads_are_refused_before_queueing(lm, case):
    model = lm[2]
    _, payloads = _migrate_mid_stream(_engine(model), _prompts(25, 1))
    pl = dict(payloads[0])
    if case == "cursor":
        pl["pos"] += 1
    elif case == "no_streamed":
        pl["streamed"] = []
    elif case == "no_budget":
        pl["budget_left"] = 0
    else:
        pl["pages"] = {k: {n: t[:-1] for n, t in v.items()} for k, v in pl["pages"].items()}
    dst = _engine(model)
    with pytest.raises(KVTransferError if case == "pages" else RequestValidationError):
        dst.submit_migrated(pl)
    assert dst.scheduler.depth() == 0


# -- two replicas: the watcher's migration ------------------------------------------------


@pytest.fixture(scope="module")
def tair():
    tpu_air_torch.init(num_cpus=4, num_chips=1)
    yield tpu_air_torch
    serve.shutdown()
    tpu_air_torch.shutdown()


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
    """Submit one journaled stream, then poll it under its pin to the end."""

    def __init__(self, prompt, max_new):
        super().__init__(daemon=True)
        self.prompt, self.max_new = prompt, max_new
        self.pin = None
        self.tokens = []
        self.done = False
        self.bad_status = []

    def run(self):
        # the batch class: the proxy trims an interactive ask to 256 tokens
        status, out, hdrs = _post("/mig", {"action": "submit", "prompt": self.prompt,
                                           "max_new_tokens": self.max_new,
                                           "priority": "batch"})
        if status != 200:
            self.bad_status.append(("submit", status, out))
            return
        self.pin = hdrs.get("x-tpu-air-replica", "")
        deadline = time.monotonic() + 120.0
        while time.monotonic() < deadline:
            status, res, _ = _post("/mig", {"action": "poll", "request_id": out["request_id"],
                                            "cursor": len(self.tokens)},
                                   headers={"x-tpu-air-replica": self.pin})
            if status != 200:
                self.bad_status.append(("poll", status, res))
                return
            self.tokens += res.get("tokens") or []
            if res.get("done"):
                self.done = True
                return
            time.sleep(0.005)


def test_watcher_migrates_one_replicas_streams_to_the_other(lm, tair):
    _, _, model = lm
    ckpt = Checkpoint.from_model(model_config=model.config, params=model.state_dict())
    max_new = 440
    prompts = _prompts(31, 4)
    try:
        h = serve.run(EngineDeployment.options(name="mig", route_prefix="/mig", num_replicas=2)
                      .bind(ckpt, EngineConfig(num_slots=4, slot_len=512, page_len=16,
                                               max_new_tokens=max_new, eos_token_id=None),
                            device="cpu"), port=PORT)
        # warm both replicas' engines, so that the streams below decode at
        # once and are mid-stream when the watcher moves them
        for r in h._replicas:
            tpu_air_torch.get(r.handle.remote("weights_probe", ([[1, 2, 3]], 2), {}))
        clients = [_StreamClient(p, max_new) for p in prompts]
        for c in clients:
            c.start()
        deadline = time.monotonic() + 60.0
        while not all(c.pin and len(c.tokens) >= 2 for c in clients):
            assert time.monotonic() < deadline and not any(c.bad_status for c in clients)
            time.sleep(0.005)
        source = next(r for r in h._replicas if r._actor_id == clients[0].pin)
        watcher = proxy._state.watchers["/mig"]
        assert watcher._migrate(source) is True
        moved = sum(c.pin == source._actor_id for c in clients)
        for c in clients:
            c.join(timeout=120.0)
            assert not c.is_alive() and c.bad_status == [] and c.done
        for c, p in zip(clients, prompts):
            assert c.tokens == offline_greedy(model, p, max_new)
        assert watcher.migrations == moved >= 1 and watcher.migrated_pages >= moved
        dest = next(r for r in h._replicas if r._actor_id != source._actor_id)
        mg = tpu_air_torch.get(dest.handle.remote("stats", (), {}))["migrations"]
        assert mg["in"] == moved and mg["in_reprefill_chunks"] == 0
    finally:
        serve.shutdown()
