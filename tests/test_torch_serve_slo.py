"""The port's serve-plane controls read the observability plane, as the JAX
package's do, on the CPU:

* the autoscaler's default ``slo_source`` and ``anomaly_source`` read the
  installed SLO monitor and airwatch detector: the same ticks on the same
  seeded inputs give the same decisions, burning lists and anomaly lists
  in both packages;
* the canary's soak gate fails on an installed burning SLO with the JAX
  gate's message, and is time-only with none installed;
* ``EngineDeployment`` over a tiny LM on a runtime of this file's own with
  the dashboard, the default SLO monitor and airwatch on: ``serve.run``
  starts the fleet scraper and ``serve.shutdown`` stops it, and
  ``replica_engine_stats``, ``/api/engines``, ``/api/tenants`` and
  ``/metrics`` read the replica's engine.

Ports: the serve proxy and the dashboard bind port 0.
"""

import json
import time
import urllib.request

import numpy as np
import pytest

pytest.importorskip("jax")
import torch  # noqa: E402

import tpu_air_torch  # noqa: E402
from tpu_air.observability import slo as jslo  # noqa: E402
from tpu_air.observability import watch as jwatch  # noqa: E402
from tpu_air.serve import autoscaler as jautoscaler  # noqa: E402
from tpu_air.serve import weights as jweights  # noqa: E402
from tpu_air_torch.core import runtime as rt  # noqa: E402
from tpu_air_torch.observability import dashboard as tdash  # noqa: E402
from tpu_air_torch.observability import slo as tslo  # noqa: E402
from tpu_air_torch.observability import watch as twatch  # noqa: E402
from tpu_air_torch.serve import autoscaler as tautoscaler  # noqa: E402
from tpu_air_torch.serve import weights as tweights  # noqa: E402

SEED = 0
PACKAGES = {"jax": (jslo, jwatch, jautoscaler, jweights),
            "torch": (tslo, twatch, tautoscaler, tweights)}


class FakeHandle:
    deployment_name = "fake"

    def __init__(self, replicas=1):
        self.replicas = replicas

    def num_replicas(self):
        return self.replicas

    def engine_stats(self):
        return {}

    def scale_up(self, timeout=120.0):
        self.replicas += 1
        return True

    def scale_down(self, timeout=120.0):
        self.replicas -= 1
        return True


class BurningSource:
    """Cumulative snapshots whose every new TTFT sample (seeded) is over
    any sane threshold, on an injected clock that moves 10 s a call."""

    def __init__(self, slo_mod, clock):
        self._rng = np.random.default_rng(SEED)
        self._seen = []
        self._slo = slo_mod
        self._clock = clock

    def __call__(self):
        from tpu_air.observability import perf

        self._clock[0] += 10.0
        self._seen += list(self._rng.lognormal(np.log(3.0), 0.2, 8))
        h = perf.Histogram()
        for v in self._seen:
            h.observe(float(v))
        return {"engine": {"ttft_s": h.summary()}}


def _install(which: str, pkg: str, clock):
    slo_mod, watch_mod, _, _ = PACKAGES[pkg]
    slo_mod.install(None)
    watch_mod.clear()
    if which == "burning":
        slo_mod.install(slo_mod.SLOMonitor(
            [slo_mod.SLO(name="ttft", metric="ttft_s", threshold_s=0.5,
                         windows=((30.0, 2.0), (60.0, 1.5)))],
            source=BurningSource(slo_mod, clock), now=lambda: clock[0]))
    elif which == "anomaly":
        rng = np.random.default_rng(SEED)
        series = list(rng.normal(2.0, 0.1, 12)) + [40.0]
        fleet = {"i": 0}

        def engines():
            v = series[min(fleet["i"], len(series) - 1)]
            fleet["i"] += 1
            return {"r/0/e": {"name": "e", "num_slots": 4, "queue_depth": v,
                              "slot_occupancy": 1}}

        w = watch_mod.install(watch_mod.WatchConfig(seed=0), engine_source=engines,
                              serve_source=dict, now=lambda: clock[0])
        for _ in series:
            clock[0] += 1.0
            w.scrape_once()


@pytest.fixture
def clean_plane():
    yield
    for slo_mod, watch_mod, _, _ in PACKAGES.values():
        slo_mod.install(None)
        watch_mod.clear()


@pytest.mark.parametrize("which", ["none", "burning", "anomaly"])
def test_autoscaler_default_sources_read_the_installed_plane(which, clean_plane):
    """Default sources: both packages' autoscalers, ticking over the same
    gauges with the same plane installed, take the same actions and record
    the same burning and anomaly lists; a burning SLO or a flagged metric
    scales up, nothing installed holds."""
    record = {}
    for pkg in ("jax", "torch"):
        clock = [1000.0]
        _install(which, pkg, clock)
        auto = PACKAGES[pkg][2]
        handle = FakeHandle()
        a = auto.Autoscaler(handle, auto.AutoscalerConfig(min_replicas=1, max_replicas=4,
                                                          scale_up_queue_depth=8.0,
                                                          cooldown_s=0.0),
                            gauge_source=lambda: {"r0": {"queue_depth": 0,
                                                         "slot_occupancy": 1}})
        ticks = [a.tick() for _ in range(4)]
        record[pkg] = (ticks, a.last_burning, a.last_anomalies, handle.replicas,
                       a.stats()["scale_ups"])
    assert record["torch"] == record["jax"]
    ticks, burning, anomalies, replicas, _ = record["torch"]
    if which == "none":
        assert ticks == ["hold"] * 4 and burning == anomalies == ()
    elif which == "burning":
        assert "up" in ticks and burning == ("ttft",)
    else:
        assert ticks[0] == "up" and anomalies == ("fleet.queue_depth",)
    assert tautoscaler._installed_monitor_burning() == jautoscaler._installed_monitor_burning()


def test_autoscaler_decide_reacts_as_jax_does():
    """The pure policy: burn and anomaly signals rank with queue depth,
    equal in both packages."""
    cases = [({"r0": {"queue_depth": 0, "slot_occupancy": 1}}, 1, (), ()),
             ({"r0": {"queue_depth": 0, "slot_occupancy": 1}}, 1, ("ttft",), ()),
             ({"r0": {"queue_depth": 0, "slot_occupancy": 1}}, 1, (), ("fleet.ttft_p99_s",)),
             ({"r0": {"queue_depth": 0, "slot_occupancy": 0}}, 2, ("ttft",), ()),
             ({"r0": {"queue_depth": 0, "slot_occupancy": 0}}, 2, (), ()),
             ({"r0": {"queue_depth": 9, "slot_occupancy": 4}}, 4, ("ttft",), ())]
    out = {}
    for pkg in ("jax", "torch"):
        auto = PACKAGES[pkg][2]
        a = auto.Autoscaler(FakeHandle(), auto.AutoscalerConfig(min_replicas=1, max_replicas=4,
                                                                scale_up_queue_depth=8.0))
        out[pkg] = [a.decide(s, n, b, an) for s, n, b, an in cases]
    assert out["torch"] == out["jax"] == ["hold", "up", "up", "up", "down", "hold"]


@pytest.mark.parametrize("which", ["none", "burning"])
def test_soak_gate_reads_the_installed_monitor(which, clean_plane):
    """The canary's soak: a burning installed SLO fails it with the JAX
    gate's message; with no monitor it waits out ``soak_s`` and passes."""
    results = {}
    for pkg in ("jax", "torch"):
        clock = [1000.0]
        _install(which, pkg, clock)
        slo_mod, _, _, weights = PACKAGES[pkg]
        if which == "burning":
            for _ in range(3):
                slo_mod.monitor().observe()
        ctl = weights.WeightsController.__new__(weights.WeightsController)
        ctl.soak_s, ctl.soak_poll_s = 0.05, 0.01
        t0 = time.monotonic()
        try:
            ctl._soak_gate()
            results[pkg] = ("passed", time.monotonic() - t0 >= 0.05)
        except weights.GateFailedError as e:
            results[pkg] = ("failed", str(e))
    assert results["torch"] == results["jax"]
    if which == "burning":
        assert results["torch"] == ("failed", "SLO burning during soak: ['ttft']")
    else:
        assert results["torch"] == ("passed", True)


# -- the serve plane end to end on the CPU -----------------------------------------


@pytest.fixture(scope="module")
def plane(tmp_path_factory):
    """A port runtime of this file's own with the dashboard on a free port
    and tracing on; the runtime another file left in place (if any) is set
    aside and put back."""
    from tpu_air_torch.observability import tracing

    saved = rt._runtime
    rt._runtime = None
    tracing.enable()
    tpu_air_torch.init(num_cpus=2, num_chips=1, include_dashboard=True, dashboard_port=0)
    url = tdash.start_dashboard(port=0)
    try:
        yield url
    finally:
        from tpu_air_torch import serve

        serve.shutdown()
        tpu_air_torch.shutdown()
        rt._runtime = saved
        tracing.disable()
        tracing.recorder().clear()
        tslo.install(None)
        twatch.clear()


def _lm_checkpoint(path):
    from tpu_air_torch.models.lm import CausalLM, LMConfig
    from tpu_air_torch.train import Checkpoint

    model = CausalLM(LMConfig.tiny(), device="cpu").init_weights(SEED)
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(4)      # the tiny init repeats one greedy token; scaled, it does not
    return Checkpoint.from_model(model_config=model.config, params=model.state_dict(),
                                 path=str(path))


def _get_json(url):
    with urllib.request.urlopen(url, timeout=60) as resp:
        return json.loads(resp.read())


def test_engine_deployment_feeds_the_plane(plane, tmp_path):
    from tpu_air_torch import serve
    from tpu_air_torch.engine import EngineConfig
    from tpu_air_torch.serve import EngineDeployment, proxy

    url = plane
    tslo.install(None)
    tslo.ensure_default(tdash.slo_source)
    # a long TTL: on a loaded host a late scrape must not age the replica
    # out of the dashboard's view (which reads the scraper's cache)
    w = twatch.install(twatch.WatchConfig(seed=0, interval_s=0.2, stale_after_s=60.0))
    assert w._scraper is None                   # installing starts no thread
    h = serve.run(EngineDeployment.options(name="lm-obs", route_prefix="/lmobs")
                  .bind(_lm_checkpoint(tmp_path / "ckpt"),
                        EngineConfig(num_slots=2, slot_len=64, max_new_tokens=6, page_len=8),
                        device="cpu"), port=0)
    assert w._scraper is not None and w._scraper.running
    port = proxy._state.server.server_address[1]
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(1, 200, int(n)).tolist() for n in rng.integers(3, 12, 6)]
    req = urllib.request.Request(f"http://127.0.0.1:{port}/lmobs",
                                 data=json.dumps({"prompts": prompts}).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        out = json.loads(resp.read())
    assert [len(r["tokens"]) for r in out["results"]] == [6] * 6
    stats = tpu_air_torch.get(h.method("stats")())
    replicas = proxy.replica_engine_stats()
    assert list(replicas) == [f"lm-obs/0/{stats['name']}"]
    (snap,) = replicas.values()
    assert snap["requests_completed"] == stats["requests_completed"] == 6
    assert snap["tokens_emitted"] == stats["tokens_emitted"]
    deadline = time.time() + 30
    while w.ledger.snapshot()["headline"]["tokens_total"] < stats["tokens_emitted"]:
        assert time.time() < deadline, w.ledger.snapshot()
        time.sleep(0.1)
    engines = _get_json(f"{url}/api/engines")
    assert engines[f"lm-obs/0/{stats['name']}"]["requests_completed"] == 6
    tenants = _get_json(f"{url}/api/tenants")
    assert tenants["enabled"] and "default" in tenants["tenants"]
    assert _get_json(f"{url}/api/watch")["scrapes"] > 0
    slo = _get_json(f"{url}/api/slo")
    assert [s["name"] for s in slo["slos"]] == [s.name for s in tslo.default_slos()]
    assert tautoscaler._installed_monitor_burning() == tuple(tslo.monitor().burning())
    with urllib.request.urlopen(f"{url}/metrics", timeout=60) as resp:
        text = resp.read().decode()
    assert "tpu_air_engine_requests_completed" in text and "tpu_air_slo_burn_rate" in text
    traces = _get_json(f"{url}/api/traces")["traces"]
    assert traces and traces[0]["spans"] > 0
    serve.shutdown()
    assert w._scraper is None                   # shutdown stopped the scraper
