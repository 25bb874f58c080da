"""The port's engine (``tpu_air_torch.engine``) on the CPU against the JAX
package's, on the same weights and inputs.

The copied host-side pieces must decide as the JAX package does: the
scheduler's FIFO order and class-aware backpressure, the serve plane's
admission decisions and the engine metrics' exposition text.  The T5 entry
points (``make_t5_prefill_fn`` / ``make_t5_decode_step_fn``) must give the
JAX pair's tokens exactly and its encoder output and first logits within
``ATOL``; ``T5Engine`` must stream the JAX ``T5Engine``'s tokens and those of
greedy decoding over the same window batch.  Weights come from a JAX init of
``T5Config.tiny()`` carried across with ``params_from_jax``; everything is
float32 and runs the kernels' plain versions.  No runtime is started here.
"""

import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from tpu_air.engine import T5Engine as JT5Engine  # noqa: E402
from tpu_air.engine import T5EngineConfig as JT5EngineConfig  # noqa: E402
from tpu_air.engine.metrics import EngineMetrics as JEngineMetrics  # noqa: E402
from tpu_air.engine.metrics import prometheus_lines as jprometheus_lines  # noqa: E402
from tpu_air.engine.scheduler import Scheduler as JScheduler  # noqa: E402
from tpu_air.engine.types import EngineOverloadedError as JOverloaded  # noqa: E402
from tpu_air.engine.types import Request as JRequest  # noqa: E402
from tpu_air.engine.types import ResponseStream as JStream  # noqa: E402
from tpu_air.models.t5 import T5Config as JConfig  # noqa: E402
from tpu_air.models.t5 import T5ForConditionalGeneration as JT5  # noqa: E402
from tpu_air.models.t5 import make_t5_decode_step_fn as jmake_step  # noqa: E402
from tpu_air.models.t5 import make_t5_prefill_fn as jmake_prefill  # noqa: E402
from tpu_air.models.t5.generate import init_cache as jinit_cache  # noqa: E402
from tpu_air.serve.admission import AdmissionController as JAdmission  # noqa: E402
from tpu_air.serve.admission import AdmissionPolicy as JPolicy  # noqa: E402
from tpu_air_torch.engine import (  # noqa: E402
    EngineClosedError,
    EngineDrainingError,
    EngineMetrics,
    EngineOverloadedError,
    Request,
    ResponseStream,
    Scheduler,
    T5Engine,
    T5EngineConfig,
)
from tpu_air_torch.engine.metrics import prometheus_lines  # noqa: E402
from tpu_air_torch.models.t5.config import T5Config  # noqa: E402
from tpu_air_torch.models.t5.convert import params_from_jax  # noqa: E402
from tpu_air_torch.models.t5.generate import (  # noqa: E402
    generate,
    init_cache,
    make_t5_decode_step_fn,
    make_t5_prefill_fn,
)
from tpu_air_torch.models.t5.modeling import T5ForConditionalGeneration  # noqa: E402
from tpu_air_torch.observability import perf  # noqa: E402
from tpu_air_torch.serve.admission import AdmissionController, AdmissionPolicy  # noqa: E402

ATOL = 1e-4
PRIORITIES = ("interactive", "batch", "best_effort")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: one torch thread, so these tests add little CPU load
    beside the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    """(jax model, jax params, port model) on one set of weights."""
    jcfg = JConfig.tiny()
    jmodel = JT5(jcfg)
    enc = jnp.ones((2, 8), jnp.int32)
    params = jmodel.init(jax.random.PRNGKey(0), enc, jnp.ones_like(enc),
                         jnp.ones((2, 6), jnp.int32))["params"]
    cfg = T5Config.from_dict(jcfg.to_dict())
    model = T5ForConditionalGeneration(cfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.device_get(params), cfg), strict=True)
    return jmodel, params, model


def _prompts(seed, n=5, lo=3, hi=8, vocab=384):
    rng = np.random.RandomState(seed)
    return [list(map(int, rng.randint(2, vocab, size=rng.randint(lo, hi))))
            for _ in range(n)]


def _window_batch(prompts, b, L, pad):
    ids = np.full((b, L), pad, np.int64)
    mask = np.zeros((b, L), np.int64)
    for r, p in enumerate(prompts):
        ids[r, :len(p)] = p
        mask[r, :len(p)] = 1
    return ids, mask


def _eos_inclusive(row, eos):
    return row[: row.index(eos) + 1] if eos in row else row


# -- scheduler ------------------------------------------------------------------


def _fill(sched_cls, req_cls, stream_cls, arrivals):
    """Submit ``arrivals`` [(rid, priority)]; the rids accepted and, per
    rejected rid, its class."""
    accepted, rejected = [], []
    for rid, prio in arrivals:
        try:
            sched_cls.submit(req_cls(request_id=rid, prompt=[5], max_new_tokens=1,
                                     stream=stream_cls(rid), priority=prio))
            accepted.append(rid)
        except (EngineOverloadedError, JOverloaded):
            rejected.append((rid, prio))
    return accepted, rejected


def test_scheduler_fifo_and_class_backpressure_match_jax():
    """max_queue 8: best_effort sheds at 4 queued, batch at 6, interactive
    at 8; pops are class-ordered, FIFO within a class — as in the JAX
    scheduler on the same arrivals."""
    kinds = ["best_effort", "batch", "interactive", "best_effort", "batch", "best_effort",
             "batch", "batch", "interactive", "best_effort", "interactive", "interactive",
             "batch"]
    arrivals = list(enumerate(kinds))
    out = []
    for sched, req, stream, cfg in (
            (Scheduler, Request, ResponseStream, T5EngineConfig(max_queue=8)),
            (JScheduler, JRequest, JStream, JT5EngineConfig(max_queue=8))):
        s = sched(cfg)
        accepted, rejected = _fill(s, req, stream, arrivals)
        depth = (s.depth(), s.depth_by_class(), dict(s.rejected_by_class))
        pops = [[r.request_id for r in s.pop_admissible(3)] for _ in range(4)]
        out.append((accepted, rejected, depth, pops))
    assert out[0] == out[1]
    accepted, rejected, (depth, _, shed), pops = out[0]
    assert depth == 8
    assert rejected == [(5, "best_effort"), (7, "batch"), (9, "best_effort"),
                        (11, "interactive"), (12, "batch")]
    assert shed == {"interactive": 1, "batch": 2, "best_effort": 2}
    assert pops == [[2, 8, 10], [1, 4, 6], [0, 3], []]


# -- admission and metrics --------------------------------------------------------


def test_admission_decisions_match_jax():
    policy = dict(queue_soft=4.0, queue_high=12.0, queue_hard=32.0,
                  token_budgets={"interactive": 256, "batch": 1024, "best_effort": 512})
    ours = AdmissionController(object(), AdmissionPolicy(**policy))
    theirs = JAdmission(object(), JPolicy(**policy))
    for prio in PRIORITIES:
        for depth in (0, 3, 4, 11, 12, 31, 32, 100):
            g = {"depth_per_replica": depth}
            assert ours.decide(prio, g) == theirs.decide(prio, g), (prio, depth)
        for ask in (None, 64, 600, 4096):
            assert ours.policy.clamp_budget(prio, ask) == theirs.policy.clamp_budget(prio, ask)
    with pytest.raises(ValueError):
        ours.decide("platinum", {"depth_per_replica": 0})


def _drive_metrics(m):
    for prio in PRIORITIES:
        m.record_submit(prio)
    m.record_reject("best_effort")
    for s in (0.004, 0.011, 0.2):
        m.record_ttft(s)
    m.record_step(0.003, 2)
    m.record_step(0.009, 1)
    m.record_tokens(5)
    m.record_complete()
    m.observe_gauges(3, 2, queue_by_class={"interactive": 1, "batch": 2,
                                           "best_effort": 0}, draining=False)


def test_metrics_exposition_text_matches_jax():
    ours, theirs = EngineMetrics("expo-port", num_slots=4), JEngineMetrics("expo-jax", 4)
    _drive_metrics(ours)
    _drive_metrics(theirs)
    snap, jsnap = ours.snapshot(), theirs.snapshot()
    for key in ("queue_depth", "slot_occupancy", "requests_submitted", "requests_rejected",
                "requests_completed", "tokens_emitted", "ttft_s", "step_latency_s",
                "priority", "draining"):
        assert snap[key] == jsnap[key], key
    # the same snapshot renders to the same text in both packages
    snap["tokens_per_s"] = jsnap["tokens_per_s"] = 7.5
    snap["perf"] = jsnap["perf"]
    text = "\n".join(prometheus_lines({"e": snap}))
    assert text == "\n".join(jprometheus_lines({"e": jsnap}))
    assert 'tpu_air_engine_ttft_s_p50{engine="e"}' in text
    assert 'tpu_air_engine_priority_shed{engine="e",priority="best_effort"} 1' in text


def test_detect_peak_reads_the_card_and_keeps_env_overrides(monkeypatch):
    monkeypatch.delenv("TPU_AIR_PEAK_FLOPS", raising=False)
    monkeypatch.delenv("TPU_AIR_PEAK_BYTES", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert perf.detect_peak().source == "cpu-fallback"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "NVIDIA H100 80GB HBM3")
    peak = perf.detect_peak()
    assert (peak.flops_per_s, peak.bytes_per_s, peak.source) == (989e12, 3.35e12, "NVIDIA H100")
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "NVIDIA A100-SXM4-80GB")
    assert perf.detect_peak().source == "cpu-fallback"
    monkeypatch.setenv("TPU_AIR_PEAK_FLOPS", "1e15")
    peak = perf.detect_peak()
    assert (peak.flops_per_s, peak.source) == (1e15, "env")
    assert not [k for k in perf._PEAK_FLOPS if "TPU" in k]


# -- the T5 entry points -----------------------------------------------------------


def test_prefill_and_decode_step_match_the_jax_pair(pair):
    jmodel, params, model = pair
    cfg = model.config
    ids, mask = _window_batch(_prompts(11, n=3), 4, 8, cfg.pad_token_id)
    new = 6
    jprefill, jstep = jmake_prefill(jmodel, new + 1), jmake_step(jmodel)
    jtok, jcache, jenc = jprefill(params, jnp.asarray(ids, jnp.int32),
                                  jnp.asarray(mask, jnp.int32))
    want = [np.asarray(jtok)]
    for _ in range(new - 1):
        jcache, jtok = jstep(params, jcache, jtok, jenc, jnp.asarray(mask, jnp.int32))
        want.append(np.asarray(jtok))

    prefill, step = make_t5_prefill_fn(model, new + 1), make_t5_decode_step_fn(model)
    tok, cache, enc = prefill(torch.from_numpy(ids), torch.from_numpy(mask))
    assert tok.dtype == torch.long and not enc.requires_grad
    got = [tok.numpy()]
    for _ in range(new - 1):
        cache2, tok = step(cache, tok)
        assert cache2 is cache          # written in place, not rebuilt
        got.append(tok.numpy())
    np.testing.assert_array_equal(np.stack(got, 1), np.stack(want, 1))
    np.testing.assert_allclose(enc.numpy(), np.asarray(jenc), atol=ATOL)

    # the first step's logits, from the decoder start token over a fresh cache
    tok0 = np.full((4, 1), cfg.decoder_start_token_id, np.int32)
    jc = jinit_cache(jmodel, params, 4, new + 1, jenc, jnp.asarray(mask, jnp.int32))
    jlogits, _ = jmodel.apply({"params": params, "cache": jc}, tok0, jenc,
                              jnp.asarray(mask, jnp.int32), decode=True,
                              mutable=["cache"], method=jmodel.decode)
    with torch.no_grad():
        c = init_cache(model, 4, new + 1, enc, torch.from_numpy(mask))
        logits = model.decode(torch.from_numpy(tok0).long(), cache=c)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=ATOL)


def test_entry_points_record_no_autograd_graph_in_another_thread(pair):
    """Grad mode is per thread: the engine's thread runs with grad on, and
    the entry points must not record a graph there."""
    import threading

    _, _, model = pair
    ids, mask = _window_batch(_prompts(2, n=2), 2, 8, model.config.pad_token_id)
    out = {}

    def run():
        assert torch.is_grad_enabled()
        tok, cache, enc = make_t5_prefill_fn(model, 4)(torch.from_numpy(ids),
                                                      torch.from_numpy(mask))
        cache, tok = make_t5_decode_step_fn(model)(cache, tok)
        out["grad"] = [t.requires_grad for t in (tok, enc, cache.self_attn[0].k,
                                                 cache.cross_attn[0].k)]

    t = threading.Thread(target=run)
    t.start()
    t.join()
    assert out["grad"] == [False] * 4


# -- T5Engine -------------------------------------------------------------------------


def _offline(model, prompts, cfg_engine):
    """Greedy decoding with the two entry points over each window batch the
    engine forms (max_batch rows of max_input_len), EOS inclusive."""
    cfg = model.config
    want = []
    b = cfg_engine.max_batch
    for w in range(0, len(prompts), b):
        ids, mask = _window_batch(prompts[w:w + b], b, cfg_engine.max_input_len,
                                  cfg.pad_token_id)
        toks = generate(model, ids, mask, max_new_tokens=cfg_engine.max_new_tokens,
                        early_stop=False).numpy().tolist()
        want += [_eos_inclusive(r, cfg.eos_token_id) for r in toks[:len(prompts[w:w + b])]]
    return want


def _drive(engine):
    steps = 0
    while not engine.idle():
        engine.step()
        steps += 1
        assert steps < 200, "engine failed to drain"
    return steps


def test_t5_engine_streams_match_jax_engine_and_offline(pair):
    """5 prompts through max_batch=2 windows (3 windows, the last with a
    filler row), manual stepping, per-row EOS retirement."""
    jmodel, params, model = pair
    prompts = _prompts(71)
    ecfg = dict(max_batch=2, max_input_len=8, max_new_tokens=6)
    jengine = JT5Engine(jmodel, params, JT5EngineConfig(**ecfg), auto_start=False,
                        name="t5-jax-parity")
    jstreams = [jengine.submit(p) for p in prompts]
    _drive(jengine)
    want = [s.result(5.0) for s in jstreams]
    jengine.close()

    engine = T5Engine(model, T5EngineConfig(**ecfg), auto_start=False, name="t5-port-parity")
    assert engine.device == torch.device("cpu")
    streams = [engine.submit(p) for p in prompts]
    _drive(engine)
    got = [s.result(5.0) for s in streams]
    assert got == want
    assert got == _offline(model, prompts, T5EngineConfig(**ecfg))
    snap = engine.metrics.snapshot()
    assert snap["requests_completed"] == 5 and snap["tokens_emitted"] == sum(map(len, got))
    assert snap["ttft_s"]["count"] == 5
    engine.close()

    # per-row retirement: with a stop id that one row emits at its third
    # step, that row (and any other that emits it) ends there, EOS
    # inclusive, while the rows sharing its window decode on
    stop = got[1][2]
    cut = [_eos_inclusive(r, stop) for r in got]
    assert len(cut[1]) == 3 and any(len(r) == 6 for r in cut)
    for eng in (JT5Engine(jmodel, params, JT5EngineConfig(**ecfg), auto_start=False,
                          name="t5-jax-stop"),
                T5Engine(model, T5EngineConfig(**ecfg), auto_start=False, name="t5-port-stop")):
        eng.eos_token_id = stop
        streams = [eng.submit(p) for p in prompts]
        _drive(eng)
        assert [s.result(5.0) for s in streams] == cut
        eng.close()


def test_t5_engine_budget_one_and_per_request_budgets(pair):
    _, _, model = pair
    prompts = _prompts(5, n=3)
    engine = T5Engine(model, T5EngineConfig(max_batch=4, max_input_len=8, max_new_tokens=5),
                      auto_start=False, name="t5-budget")
    streams = [engine.submit(p, n) for p, n in zip(prompts, (1, 3, 5))]
    _drive(engine)
    full = _offline(model, prompts, T5EngineConfig(max_batch=4, max_input_len=8,
                                                   max_new_tokens=5))
    for s, n, w in zip(streams, (1, 3, 5), full):
        assert s.result(5.0) == w[:n]
    engine.close()


def test_t5_engine_background_thread_matches_manual(pair):
    _, _, model = pair
    prompts = _prompts(23, n=5)
    ecfg = T5EngineConfig(max_batch=2, max_input_len=8, max_new_tokens=6)
    with T5Engine(model, ecfg, name="t5-thread") as engine:
        got = engine.generate(prompts, timeout=60.0)
        assert engine._thread is not None and engine._thread.is_alive()
    assert engine._thread is None
    assert got == _offline(model, prompts, ecfg)


def test_t5_engine_submit_validation_and_overload_per_priority(pair):
    _, _, model = pair
    engine = T5Engine(model, T5EngineConfig(max_batch=2, max_input_len=8, max_new_tokens=4,
                                            max_queue=4),
                      auto_start=False, name="t5-validate")
    for bad, kw in (([], {}), (list(range(2, 11)), {}), ([5, 6], {"max_new_tokens": 0}),
                    ([5, 6], {"max_new_tokens": 5}), ([5, 6], {"priority": "platinum"})):
        with pytest.raises(ValueError):
            engine.submit(bad, **kw)
    # max_queue 4: best_effort sheds at 2 queued, batch at 3, interactive at 4
    engine.submit([5, 6], priority="interactive")
    engine.submit([5, 6], priority="interactive")
    with pytest.raises(EngineOverloadedError):
        engine.submit([5, 6], priority="best_effort")
    engine.submit([5, 6], priority="batch")
    with pytest.raises(EngineOverloadedError):
        engine.submit([5, 6], priority="batch")
    engine.submit([5, 6], priority="interactive")
    with pytest.raises(EngineOverloadedError):
        engine.submit([5, 6], priority="interactive")
    pri = engine.metrics.snapshot()["priority"]
    assert {p: pri[p]["shed"] for p in PRIORITIES} == {
        "interactive": 1, "batch": 1, "best_effort": 1}
    engine.drain()
    with pytest.raises(EngineDrainingError):
        engine.submit([5, 6])
    _drive(engine)
    assert engine.drained()
    engine.close()
    with pytest.raises(EngineClosedError):
        engine.submit([5, 6])


def test_t5_engine_close_fails_queued_requests_loudly(pair):
    _, _, model = pair
    engine = T5Engine(model, T5EngineConfig(max_batch=2, max_input_len=8, max_new_tokens=4),
                      auto_start=False, name="t5-close")
    streams = [engine.submit(p) for p in _prompts(9, n=3)]
    engine.step()                     # one window open, one request queued
    t0 = time.monotonic()
    engine.close()
    for s in streams:
        with pytest.raises(EngineClosedError):
            s.result(1.0)
    assert time.monotonic() - t0 < 5.0
