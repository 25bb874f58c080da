"""The port's observability plane on the CPU, held against the JAX package
(``tpu_air.observability``) on the same inputs, made from a numpy seed:

* the SLO monitor's burn state and exposition under an injected clock, the
  airwatch anomaly detector and ``Watch`` (seed 0), the time-series
  store's downsampling, the Chrome-trace export of the same spans and the
  ``step_timer`` summaries, each equal to the JAX package's;
* ``profile_trace`` on the CPU writes a Chrome trace that holds the
  region's matmul, and refuses to run without CUDA unless asked for the
  CPU;
* the dashboard on a runtime of this file's own (``init(num_cpus=2,
  num_chips=1, include_dashboard=True, dashboard_port=0)``) serves every
  route of the JAX dashboard, a failing route answers 500, and ``/metrics``
  holds the JAX dashboard's metric families for an equivalent state;
* a crashed worker under ``TPU_AIR_POSTMORTEM_DIR`` leaves a dump with the
  JAX dump's keys, which either package's ``load`` reads;
* the train session's ``train.iteration`` spans.

Ports: the dashboard binds port 0 (never 8265), so the file shares nothing
with another test file.
"""

import copy
import glob
import json
import os
import re
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

pytest.importorskip("jax")
import torch  # noqa: E402

import tpu_air_torch  # noqa: E402
from tpu_air.observability import dashboard as jdash  # noqa: E402
from tpu_air.observability import perf as jperf  # noqa: E402
from tpu_air.observability import postmortem as jpostmortem  # noqa: E402
from tpu_air.observability import profiler as jprofiler  # noqa: E402
from tpu_air.observability import slo as jslo  # noqa: E402
from tpu_air.observability import timeseries as jts  # noqa: E402
from tpu_air.observability import trace_export as jexport  # noqa: E402
from tpu_air.observability import tracing as jtracing  # noqa: E402
from tpu_air.observability import watch as jwatch  # noqa: E402
from tpu_air_torch.core import runtime as rt  # noqa: E402
from tpu_air_torch.observability import dashboard as tdash  # noqa: E402
from tpu_air_torch.observability import postmortem as tpostmortem  # noqa: E402
from tpu_air_torch.observability import profiler as tprofiler  # noqa: E402
from tpu_air_torch.observability import slo as tslo  # noqa: E402
from tpu_air_torch.observability import timeseries as tts  # noqa: E402
from tpu_air_torch.observability import trace_export as texport  # noqa: E402
from tpu_air_torch.observability import tracing as ttracing  # noqa: E402
from tpu_air_torch.observability import watch as twatch  # noqa: E402

SEED = 0


class Clock:
    """An injected monotonic clock both packages' objects read."""

    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


def _ttft_snapshot(perf, samples) -> dict:
    """A histogram summary, as an engine snapshot carries it, of ``samples``
    through ``perf``'s Histogram."""
    h = perf.Histogram()
    for v in samples:
        h.observe(float(v))
    return h.summary()


def _snapshots(rng, steps: int, bad_from: int):
    """Cumulative engine snapshots, one per step: TTFT samples drawn from a
    seeded lognormal, every sample 10 x slower from ``bad_from`` on, so the
    TTFT objectives start to burn partway."""
    seen, out = [], []
    for i in range(steps):
        scale = 0.05 if i < bad_from else 2.0
        seen += list(rng.lognormal(np.log(scale), 0.3, 16))
        summary = _ttft_snapshot(jperf, seen)
        out.append({"engine-a": {"ttft_s": summary,
                                 "priority": {"interactive": {"ttft_s": summary}}}})
    return out


@pytest.mark.parametrize("bad_from", [4, 1000])
def test_slo_monitor_matches_jax(bad_from):
    """Both monitors, fed one snapshot sequence on one injected clock, give
    equal burn states, burning lists and exposition lines at every step."""
    rng = np.random.default_rng(SEED)
    snaps = _snapshots(rng, 24, bad_from)
    windows = ((30.0, 2.0), (120.0, 1.5))

    def slos(pkg):
        return [pkg.SLO(name="ttft", metric="ttft_s", threshold_s=0.5,
                        objective=0.99, windows=windows),
                pkg.SLO(name="interactive-ttft", metric="priority.interactive.ttft_s",
                        threshold_s=1.0, objective=0.999, windows=windows)]

    clock = Clock()
    jmon = jslo.SLOMonitor(slos(jslo), now=clock)
    tmon = tslo.SLOMonitor(slos(tslo), now=clock)
    burned = False
    for snap in snaps:
        clock.t += 10.0
        jmon.observe(copy.deepcopy(snap))
        tmon.observe(copy.deepcopy(snap))
        assert tmon.state() == jmon.state()
        assert tmon.burning() == jmon.burning()
        assert tmon.prometheus_lines() == jmon.prometheus_lines()
        burned |= bool(tmon.burning())
    assert burned == (bad_from < len(snaps))
    assert [s.name for s in tslo.default_slos()] == [s.name for s in jslo.default_slos()]
    assert ([(s.metric, s.threshold_s, s.objective, s.windows, s.kind)
             for s in tslo.default_slos()]
            == [(s.metric, s.threshold_s, s.objective, s.windows, s.kind)
                for s in jslo.default_slos()])


def test_anomaly_detector_matches_jax():
    """Seed 0: the same stream (noise, then a step change) fires at the
    same points with the same events, and the seeded thresholds agree."""
    rng = np.random.default_rng(SEED)
    series = list(rng.normal(10.0, 0.3, 40)) + list(rng.normal(30.0, 0.3, 10))
    cfg_j, cfg_t = jwatch.WatchConfig(seed=0), twatch.WatchConfig(seed=0)
    clock = Clock()
    jdet = jwatch.AnomalyDetector(cfg_j, now=clock)
    tdet = twatch.AnomalyDetector(cfg_t, now=clock)
    fired = []
    for i, v in enumerate(series):
        clock.t += 1.0
        je, te = jdet.observe("fleet.queue_depth", v), tdet.observe("fleet.queue_depth", v)
        assert te == je
        if te is not None:
            fired.append(i)
    assert fired and fired[0] == 40
    assert tdet.stats() == jdet.stats()
    for m in ("fleet.ttft_p99_s", "recovery.replays"):
        assert tdet.threshold_for(m) == jdet.threshold_for(m)


def _fleet_snapshot(i: int, rng) -> dict:
    """One replica's cumulative engine snapshot at scrape ``i`` (seeded):
    a queue that jumps at scrape 30, tokens billed to two tenants."""
    depth = int(rng.integers(0, 3)) if i < 30 else 40
    done = 4 * i
    return {
        "name": "lm", "num_slots": 8, "queue_depth": depth,
        "slot_occupancy": int(rng.integers(2, 8)),
        "requests_submitted": done + depth, "requests_rejected": 0,
        "requests_completed": done, "tokens_emitted": 64 * done,
        "tokens_per_s": float(rng.normal(500.0, 5.0)),
        "ttft_s": _ttft_snapshot(jperf, rng.lognormal(np.log(0.05), 0.2, 4 * i + 1)),
        "tenants": {"default": {"tokens_prefilled": 100.0 * i, "tokens_decoded": 48.0 * i,
                                "requests_completed": 3.0 * i, "kv_page_seconds": 0.5 * i,
                                "migrated_pages": 0.0},
                    "t1": {"tokens_prefilled": 30.0 * i, "tokens_decoded": 16.0 * i,
                           "requests_completed": 1.0 * i, "kv_page_seconds": 0.1 * i,
                           "migrated_pages": 0.0}},
    }


def test_watch_matches_jax():
    """Two ``Watch`` planes (seed 0) over the same synthetic fleet on one
    injected clock: equal payloads (events, detector, store), tenant
    ledgers and anomaly lists at every scrape."""
    rng = np.random.default_rng(SEED)
    snaps = [_fleet_snapshot(i, rng) for i in range(40)]
    serve = {"/lm": {"admission": {"tenants": {"t1": {"admitted": 3, "shed": 1,
                                                     "quota_shed": 0}}}},
             "recovery": {"replays": 0, "preemptions": 0}}
    clock = Clock()
    cur = {"i": 0}
    flagged = set()
    planes = [pkg.Watch(pkg.WatchConfig(seed=0, interval_s=1.0),
                        engine_source=lambda: {"lm/0/lm": copy.deepcopy(snaps[cur["i"]])},
                        serve_source=lambda: copy.deepcopy(serve), now=clock)
              for pkg in (jwatch, twatch)]
    for i in range(len(snaps)):
        cur["i"] = i
        clock.t += 1.0
        merged = [w.scrape_once() for w in planes]
        assert merged[1] == merged[0]
        assert planes[1].payload() == planes[0].payload()
        assert planes[1].ledger.snapshot() == planes[0].ledger.snapshot()
        assert planes[1].anomalous() == planes[0].anomalous()
        flagged |= set(planes[1].anomalous())
    assert "fleet.queue_depth" in flagged
    assert planes[1].ledger.snapshot()["headline"]["chip_seconds_per_1k_tokens"] > 0
    for w in planes:
        w.note("preemption.recovered", route="/lm", replica="a1", recovery_ms=1.5,
               migrated_all=True, borrowed=False)
    assert planes[1].events(kind="preemption.recovered") == \
        planes[0].events(kind="preemption.recovered")


def test_timeseries_downsamples_like_jax():
    """The same seeded samples on one clock give the same series in every
    tier (1 s, 10 s, 60 s), the same windows and stats."""
    rng = np.random.default_rng(SEED)
    clock = Clock()
    stores = [pkg.TimeSeriesStore(now=clock) for pkg in (jts, tts)]
    for v in rng.normal(5.0, 2.0, 500):
        clock.t += float(rng.uniform(0.1, 0.9))
        for s in stores:
            s.record("m", float(v))
            s.record("n", float(-v))
    for step in (None, 1.0, 10.0, 60.0):
        assert stores[1].series("m", step=step) == stores[0].series("m", step=step)
    assert stores[1].window("m", 30.0) == stores[0].window("m", 30.0)
    assert stores[1].latest("n") == stores[0].latest("n")
    assert stores[1].stats() == stores[0].stats()
    assert tts.DEFAULT_TIERS == jts.DEFAULT_TIERS


def test_trace_export_matches_jax():
    """The same spans, built in each package, export as equal JSON, whole
    and for one trace; ``to_dict`` and ``trace_summaries`` agree too."""

    def spans(pkg, rng):
        out, t = [], 1_000_000_000
        for k in range(6):
            trace = f"{k % 2:032x}"
            start = t + int(rng.integers(0, 10_000))
            out.append(pkg.Span(name=f"serve.request.{k}", trace_id=trace,
                                span_id=f"{k:016x}", parent_id=None if k < 2 else f"{k % 2:016x}",
                                start_ns=start, end_ns=start + int(rng.integers(1, 10**6)),
                                pid=100 + k % 2, tid=7, status="ok" if k != 3 else "error",
                                attrs={"k": k}))
        return out

    jspans = spans(jtracing, np.random.default_rng(SEED))
    tspans = spans(ttracing, np.random.default_rng(SEED))
    assert texport.export_json(tspans) == jexport.export_json(jspans)
    assert [s.to_dict() for s in tspans] == [s.to_dict() for s in jspans]
    for rec, sp in ((jtracing.recorder(), jspans), (ttracing.recorder(), tspans)):
        rec.clear()
        rec.record_many(sp)
    try:
        assert ttracing.trace_summaries() == jtracing.trace_summaries()
        trace = f"{1:032x}"
        assert (texport.export_json(trace_id=trace) == jexport.export_json(trace_id=trace))
        assert ttracing.recorder().stats() == jtracing.recorder().stats()
    finally:
        jtracing.recorder().clear()
        ttracing.recorder().clear()


def test_step_timer_matches_jax(monkeypatch):
    """Both timers over the same step durations (a fake perf_counter) give
    equal summaries, and with tracing on each step lands as a span."""
    rng = np.random.default_rng(SEED)
    durations = list(rng.lognormal(np.log(0.1), 0.5, 25))
    timers = [jprofiler.step_timer(span_name="lm.step"),
              tprofiler.step_timer(span_name="lm.step")]
    ttracing.enable()
    ttracing.recorder().clear()
    try:
        for timer in timers:
            ticks = iter(np.cumsum([0.0] + [x for d in durations for x in (d, 1.0)]))
            monkeypatch.setattr(time, "perf_counter", lambda: float(next(ticks)))
            for _ in durations:
                with timer.step():
                    pass
            monkeypatch.undo()
        assert timers[1].summary() == timers[0].summary()
        assert timers[1].durations == timers[0].durations
        assert timers[1].summary()["steps"] == len(durations)
        spans = [s for s in ttracing.recorder().recent(0) if s.name == "lm.step"]
        assert [s.attrs["step"] for s in spans] == list(range(1, len(durations) + 1))
    finally:
        ttracing.disable()
        ttracing.recorder().clear()
    assert tprofiler.step_timer().summary() == jprofiler.step_timer().summary() == {"steps": 0}


def test_profile_trace_on_the_cpu_writes_a_chrome_trace(tmp_path):
    """``profile_trace(device="cpu")`` writes a Chrome trace under the
    directory that parses as JSON and holds the region's matmul, and
    records the ``profiler.xplane_trace`` span with that directory."""
    ttracing.enable()
    ttracing.recorder().clear()
    a = torch.from_numpy(np.random.default_rng(SEED).standard_normal((64, 64)).astype(np.float32))
    try:
        with tprofiler.profile_trace(str(tmp_path), device="cpu"):
            (a @ a).sum()
        spans = [s for s in ttracing.recorder().recent(0) if s.name == "profiler.xplane_trace"]
    finally:
        ttracing.disable()
        ttracing.recorder().clear()
    files = glob.glob(str(tmp_path / "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") in ("aten::mm", "aten::matmul") for e in events)
    assert [s.attrs for s in spans] == [{"log_dir": str(tmp_path)}]


@pytest.mark.parametrize("device", [None, "cuda:0"])
def test_profile_trace_without_cuda_raises(device, monkeypatch, tmp_path):
    """No CUDA: a trace of the card, named or by default, raises before
    anything is recorded; it never falls back to a host-only trace."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cpu"):
        with tprofiler.profile_trace(str(tmp_path), device=device):
            pass
    assert os.listdir(tmp_path) == []


def test_observability_exports_match_jax():
    import tpu_air.observability as jobs
    import tpu_air_torch.observability as tobs

    assert tobs.__all__ == jobs.__all__
    assert all(hasattr(tobs, name) for name in tobs.__all__)


# -- the dashboard on the port's runtime ---------------------------------------

ROUTES = ("/", "/api/cluster", "/api/objects", "/api/engines", "/api/serve", "/api/traces",
          "/api/traces/export", "/api/slo", "/api/tenants", "/api/watch", "/api/batch",
          "/api/version", "/metrics")


@pytest.fixture(scope="module")
def dash():
    """A port runtime of this file's own, with its dashboard on a free port:
    the runtime another file left in place (if any) is set aside and put
    back, so no file's state leaks into this one or out of it."""
    from tpu_air_torch import _native

    if _native.gcs_missing() is None:
        _native.build_gcs()                      # built: init() starts the GCS at once
    saved = rt._runtime
    rt._runtime = None
    runtime = tpu_air_torch.init(num_cpus=2, num_chips=1, include_dashboard=True,
                                 dashboard_port=0)
    url = tdash.start_dashboard(port=0)          # the running server's URL
    try:
        yield url, runtime
    finally:
        tpu_air_torch.shutdown()
        rt._runtime = saved
        tslo.install(None)
        twatch.clear()


def _get(url: str):
    try:
        with urllib.request.urlopen(url, timeout=60) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _engine_metrics(pkg_metrics, name: str):
    m = pkg_metrics.EngineMetrics(name, num_slots=4)
    for v in np.random.default_rng(SEED).lognormal(np.log(0.05), 0.3, 12):
        m.record_submit()
        m.record_ttft(float(v))
        m.record_step(float(v) / 4, 1)
        m.record_complete()
    return m


def test_dashboard_serves_every_route(dash, monkeypatch):
    from tpu_air_torch.batch import job as tbatch

    # jobs that earlier tests left registered in this process would show
    # on /api/batch
    monkeypatch.setattr(tbatch, "_registry", {})
    url, runtime = dash
    held = tpu_air_torch.put(np.arange(1000))    # an object in the store's arena
    tslo.install(None)
    twatch.install(twatch.WatchConfig(seed=0)).scrape_once()
    ttracing.enable()
    try:
        with ttracing.span("obs.test") as sp:
            pass
        bodies = {}
        for route in ROUTES:
            status, body = _get(f"{url}{route}")
            assert status == 200, (route, body[:200])
            bodies[route] = body
    finally:
        ttracing.disable()
    assert b"tpu_air dashboard" in bodies["/"]
    data = {r: json.loads(b) for r, b in bodies.items() if r.startswith("/api/")}
    assert data["/api/cluster"]["initialized"]
    assert data["/api/cluster"]["session_id"] == runtime.session_id
    assert data["/api/cluster"]["resources"] == {"cpu": 2, "chip": 1, "chips_per_host": 1}
    gcs = data["/api/cluster"]["gcs"]
    if runtime.gcs_address is None:             # no protobuf toolchain here
        from tpu_air_torch import _native

        assert _native.gcs_missing() and gcs == {"address": None, "nodes": []}
    else:
        assert gcs["address"] == runtime.gcs_address
        assert [(n["node_id"], n["alive"], n["num_chips"]) for n in gcs["nodes"]] == [
            ("host-0", True, 1)]
    arena = data["/api/objects"]["arena"]
    assert arena == {**arena, "capacity": 256 << 20, "leaked_bytes": 0}
    assert runtime.store._arena.contains(held.id) and arena["live_objects"] >= 1
    assert "spill" in data["/api/objects"]
    assert data["/api/objects"]["store_root"] == runtime.store_root
    assert data["/api/batch"] == {"jobs": {}}
    assert data["/api/version"] == {"version": tpu_air_torch.__version__}
    assert sp.trace_id in [t["trace_id"] for t in data["/api/traces"]["traces"]]
    status, one = _get(f"{url}/api/traces?trace_id={sp.trace_id}")
    assert [s["name"] for s in json.loads(one)["spans"]] == ["obs.test"]
    status, exp = _get(f"{url}/api/traces/export?trace_id={sp.trace_id}")
    events = [e for e in json.loads(exp)["traceEvents"] if e["ph"] == "X"]
    assert [e["name"] for e in events] == ["obs.test"]
    assert [s["name"] for s in data["/api/slo"]["slos"]] == \
        [s.name for s in tslo.default_slos()]
    assert data["/api/watch"]["enabled"] and data["/api/watch"]["scrapes"] == 1
    assert data["/api/tenants"]["enabled"]
    assert "tpu_air_cpus_total 2" in bodies["/metrics"].decode()
    assert _get(f"{url}/api/nothing")[0] == 404


def test_cluster_snapshot_reports_the_runtimes_chips_per_host(monkeypatch):
    """``/api/cluster``'s ``chips_per_host`` is the runtime's host shape
    (``TPU_AIR_CHIPS_PER_HOST``), as the JAX package's snapshot reports it,
    not the runtime's whole slot count."""
    monkeypatch.setenv("TPU_AIR_CHIPS_PER_HOST", "2")
    monkeypatch.setenv("TPU_AIR_NO_GCS", "1")
    runtime = rt.Runtime(num_cpus=1, num_chips=4)
    try:
        monkeypatch.setattr(rt, "_runtime", runtime)
        assert tdash.snapshot()["resources"] == {"cpu": 1, "chip": 4, "chips_per_host": 2}
    finally:
        runtime.shutdown()


def test_dashboard_route_failure_is_a_500(dash, monkeypatch):
    """A route whose payload raises answers 500 with the error, never an
    empty 200."""
    url, _ = dash

    def broken():
        raise RuntimeError("engine scrape failed")

    monkeypatch.setattr(tdash, "engine_stats", broken)
    status, body = _get(f"{url}/api/engines")
    assert status == 500 and json.loads(body) == {"error": "engine scrape failed"}


def _families(text: str) -> set:
    names = set()
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            names.add(line.split()[2])
        elif line and not line.startswith("#"):
            names.add(re.split(r"[{ ]", line, maxsplit=1)[0])
    return names


def test_metrics_families_match_jax(dash, monkeypatch):
    """``/metrics`` of the port's dashboard and the JAX dashboard's
    exposition for an equivalent state — the same cluster snapshot, one
    engine with the same observations in each package's registry, the
    default SLO monitor and an airwatch plane after one scrape — hold the
    same metric families.  Each package's process-wide state that
    ``/metrics`` reads (the engine registry, the serve proxy's routes,
    admission controllers, watchers and journal, the batch-job registry)
    is swapped for an empty one for the test's duration, so engines,
    tenants and jobs that earlier tests left behind in this process do not
    enter either side."""
    from tpu_air.batch import job as jbatch
    from tpu_air.engine import metrics as jmetrics
    from tpu_air.serve import proxy as jproxy
    from tpu_air_torch.batch import job as tbatch
    from tpu_air_torch.engine import metrics as tmetrics
    from tpu_air_torch.serve import proxy as tproxy

    for metrics_mod in (jmetrics, tmetrics):
        monkeypatch.setattr(metrics_mod, "_registry", {})
    for proxy_mod in (jproxy, tproxy):
        monkeypatch.setattr(proxy_mod, "_state", proxy_mod._ServeState())
    for job_mod in (jbatch, tbatch):
        monkeypatch.setattr(job_mod, "_registry", {})
    url, _ = dash
    engines = [_engine_metrics(jmetrics, "obs-engine"), _engine_metrics(tmetrics, "obs-engine")]
    jmetrics.register(engines[0])
    tmetrics.register(engines[1])
    tslo.install(None)
    jslo.install(None)
    planes = [pkg.install(pkg.WatchConfig(seed=0)) for pkg in (jwatch, twatch)]
    try:
        for w in planes:
            w.scrape_once()
        status, body = _get(f"{url}/metrics")
        assert status == 200
        monkeypatch.setattr(jdash, "snapshot", tdash.snapshot)
        monkeypatch.setattr(jdash, "object_stats", tdash.object_stats)
        jtext = jdash._prometheus_text()
        tfam, jfam = _families(body.decode()), _families(jtext)
        assert tfam == jfam
        assert any(f.startswith("tpu_air_engine_") for f in tfam)
        assert any(f.startswith("tpu_air_slo_") for f in tfam)
        assert "tpu_air_watch_scrapes" in tfam and "tpu_air_cpus_total" in tfam
        assert {"tpu_air_arena_live_objects", "tpu_air_arena_leaked_bytes"} <= tfam
    finally:
        jmetrics.unregister("obs-engine")
        tmetrics.unregister("obs-engine")
        jwatch.clear()
        twatch.clear()
        jslo.install(None)
        tslo.install(None)


# -- postmortems -----------------------------------------------------------------


def test_crashed_worker_leaves_a_postmortem_with_the_jax_keys(dash, monkeypatch, tmp_path):
    """An actor on a leased card exits with status 17: the runtime dumps a
    flight record naming the crash, the actor and its card, with the JAX
    dump's sections; each package's ``load`` reads the other's dump."""
    from tpu_air_torch import RemoteError

    @tpu_air_torch.remote(num_chips=1)
    class Doomed:
        def where(self):
            return os.environ.get("TPU_AIR_CHIP_IDS")

        def die(self):
            os._exit(17)

    out = tmp_path / "pm"
    monkeypatch.setenv("TPU_AIR_POSTMORTEM_DIR", str(out))
    actor = Doomed.remote()
    assert tpu_air_torch.get(actor.where.remote(), timeout=120) == "0"
    with pytest.raises(RemoteError, match="WorkerCrashed"):
        tpu_air_torch.get(actor.die.remote(), timeout=120)
    deadline = time.time() + 30
    while not glob.glob(str(out / "postmortem-*.json")) and time.time() < deadline:
        time.sleep(0.05)
    files = glob.glob(str(out / "postmortem-*.json"))
    assert len(files) == 1
    dump = tpostmortem.load(files[0])
    assert dump == jpostmortem.load(files[0])
    assert re.fullmatch(r"WorkerCrashed\(worker=\d+\)", dump["reason"])
    assert dump["context"]["actor_id"] == actor._actor_id
    assert dump["context"]["chip_ids"] == [0]
    jfile = jpostmortem.dump("WorkerCrashed(worker=0)", {
        "worker_id": 0, "pid": 1, "actor_id": "a", "busy_task": None,
        "outstanding_tasks": [], "trace_ids": []}, directory=str(tmp_path / "jax"))
    jdump = tpostmortem.load(jfile)
    assert set(dump) == set(jdump)
    assert set(dump["traces"]) == set(jdump["traces"])
    assert set(dump["context"]) == set(jdump["context"]) | {"chip_ids"}
    assert tpostmortem.SCHEMA == jpostmortem.SCHEMA
    monkeypatch.delenv("TPU_AIR_POSTMORTEM_DIR")
    assert tpostmortem.dump("nothing") is None     # off: no directory, no file, no raise


# -- the train session's spans ---------------------------------------------------


def test_session_records_train_iteration_spans(tmp_path):
    """With tracing on, every report records a ``train.iteration`` span
    under the trace the session was made in, as the JAX session does."""
    from tpu_air_torch.train.session import Session

    ttracing.enable()
    ttracing.recorder().clear()
    try:
        with ttracing.span("trial") as root:
            s = Session(str(tmp_path / "run"))
        for i in range(3):
            s.report({"loss": float(i)})
        spans = [x for x in ttracing.recorder().recent(0) if x.name == "train.iteration"]
    finally:
        ttracing.disable()
        ttracing.recorder().clear()
    assert [x.attrs["iteration"] for x in spans] == [1, 2, 3]
    assert {x.trace_id for x in spans} == {root.trace_id}
    assert {x.parent_id for x in spans} == {root.span_id}
    assert all(a.end_ns <= b.start_ns + 1 for a, b in zip(spans, spans[1:]))
