"""The port's revocable leases and what they start, on the CPU, held against
the JAX package on the same inputs (the cases of tests/test_preemption.py):

* ``ChipLease``'s plumbing (callbacks, late registration, idempotent notice,
  expiry, a broken callback, pickling down to its ids), each case run on
  both packages' class;
* the ``runtime.lease`` fault site: ``FaultSpec.notice_s`` validation,
  ``FaultPlan.generate`` (the same seed gives the JAX package's
  ``to_json()``), ``perturb`` raising ``LeaseRevokedError`` on ``revoke``,
  a cold revoke that leaks no device slot, a ``notice`` that grants and
  then revokes with its warning, and ``attach_chip_lease`` in both forms;
* ``lease_chips`` does not outrace a queued actor request that fits (the
  one-host reading of the JAX ``_queued_reservations``);
* ``InferenceEngine.migrate_out`` freezes the engine's own busy loop
  between two steps and ships every live slot;
* two CPU replicas (``num_chips=1`` each of ``init(num_chips=2)``): a lease
  notice on one migrates its live streams into the other replica's process
  token-identically with no prefill re-run; a zero-notice revocation falls
  back to the journal's replay; ``borrow_return`` after ``shrink_target``
  and ``mark_borrowed`` migrates without an autoscaler backfill.

Weights: a Flax init of ``LMConfig.tiny()`` scaled by 4, carried into the
port; f32; every finished stream's tokens compared exactly with the JAX
package's ``lm_generate`` on the Flax weights, and with the port's offline
greedy decode.
Ports: ``PORT`` (8363, no other test file uses it).  The port's runtime is
this file's own; one another file left in place is set aside and put back.
"""

import json
import pickle
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
from tpu_air import faults as jfaults  # noqa: E402
from tpu_air.core import runtime as jrt  # noqa: E402
from tpu_air.models import lm as jlm  # noqa: E402
from tpu_air.models.lm.generate import generate as lm_generate  # noqa: E402
from tpu_air_torch import serve  # noqa: E402
from tpu_air_torch.core import runtime as rt  # noqa: E402
from tpu_air_torch.engine import EngineConfig  # noqa: E402
from tpu_air_torch.faults import plan as tfaults  # noqa: E402
from tpu_air_torch.models import lm as tlm  # noqa: E402
from tpu_air_torch.serve import EngineDeployment  # noqa: E402
from tpu_air_torch.serve import proxy  # noqa: E402
from tpu_air_torch.serve.weights import offline_greedy  # noqa: E402
from tpu_air_torch.train import Checkpoint  # noqa: E402

PORT = 8363
CFG = jlm.LMConfig.tiny()
V = CFG.vocab_size
LEASES = {"jax": jrt.ChipLease, "torch": rt.ChipLease}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def lm():
    """(jax model, jax params, port model) on one set of weights: a JAX
    init, scaled by 4."""
    jmodel = jlm.CausalLM(CFG)
    init = jmodel.init(jax.random.PRNGKey(0), jnp.ones((1, 8), jnp.int32))["params"]
    params = jax.tree_util.tree_map(lambda x: np.asarray(x) * np.float32(4), init)
    m = tlm.CausalLM(tlm.LMConfig.from_dict(CFG.to_dict()), device="cpu")
    m.load_state_dict(tlm.params_from_jax(params))
    return jmodel, params, m


@pytest.fixture(scope="module")
def model(lm):
    """The port's tiny LM of ``lm``."""
    return lm[2]


_JAX_TOKENS = {}


def _expected(lm, prompt, max_new):
    """The JAX package's greedy tokens for ``prompt`` (cached per prompt),
    checked equal to the port's offline greedy decode of the same weights."""
    key = (tuple(prompt), max_new)
    if key not in _JAX_TOKENS:
        jmodel, params, model = lm
        toks = np.asarray(lm_generate(jmodel, params, [list(prompt)], max_new_tokens=max_new,
                                      eos_token_id=None))[0].tolist()
        assert toks == offline_greedy(model, list(prompt), max_new)
        _JAX_TOKENS[key] = toks
    return _JAX_TOKENS[key]


@pytest.fixture(scope="module")
def tair():
    """A port runtime of this file's own with two device slots."""
    saved = rt._runtime
    rt._runtime = None
    runtime = tpu_air_torch.init(num_cpus=4, num_chips=2)
    try:
        yield runtime
    finally:
        serve.shutdown()
        tpu_air_torch.shutdown()
        rt._runtime = saved


@pytest.fixture
def _clean_faults():
    jfaults.clear()
    tfaults.clear()
    yield
    jfaults.clear()
    tfaults.clear()


def _prompts(seed, n, lo=3, hi=12):
    rng = np.random.RandomState(seed)
    return [list(map(int, rng.randint(1, V, size=rng.randint(lo, hi)))) for _ in range(n)]


# -- ChipLease: revocation plumbing -------------------------------------------------------


def _callbacks_fire(lease_cls):
    lease = lease_cls([0, 1])
    assert lease == [0, 1] and lease.chip_ids == [0, 1]
    assert not lease.revoking and lease.notice_s is None
    got = []
    lease.on_revoke(got.append)
    lease.deliver_notice(4.5)
    assert got == [4.5]
    assert lease.revoking and lease.notice_s == 4.5
    late = []                    # registered AFTER the notice: fires at once
    lease.on_revoke(late.append)
    assert late == [4.5]


def _idempotent_and_expires(lease_cls):
    lease = lease_cls([3])
    lease.deliver_notice(0.05)
    lease.deliver_notice(9.0)    # a second delivery does not extend the window
    assert lease.notice_s == 0.05
    assert lease.wait_expired(5.0) and lease.expired


def _zero_notice_expires_at_once(lease_cls):
    lease = lease_cls([3])
    assert not lease.expired
    lease.deliver_notice(0.0)
    assert lease.expired and lease.notice_s == 0.0


def _broken_callback_does_not_mask(lease_cls):
    lease = lease_cls([1])
    lease.on_revoke(lambda n: (_ for _ in ()).throw(RuntimeError("boom")))
    got = []
    lease.on_revoke(got.append)
    lease.deliver_notice(1.0)
    assert got == [1.0]


def _pickles_down_to_ids(lease_cls):
    out = pickle.loads(pickle.dumps(lease_cls([2, 5])))
    assert type(out) is list and out == [2, 5]


LEASE_CASES = {f.__name__.lstrip("_"): f for f in (
    _callbacks_fire, _idempotent_and_expires, _zero_notice_expires_at_once,
    _broken_callback_does_not_mask, _pickles_down_to_ids)}


@pytest.mark.parametrize("pkg", sorted(LEASES))
@pytest.mark.parametrize("case", sorted(LEASE_CASES))
def test_chip_lease(case, pkg):
    LEASE_CASES[case](LEASES[pkg])


# -- the runtime.lease fault site ---------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 15, 2024])
def test_generated_plans_equal_jax(seed):
    for sites in (None, ["runtime.lease"], ["proxy.poll", "weights.swap"]):
        plan = tfaults.FaultPlan.generate(seed=seed, sites=sites)
        assert plan.to_json() == tfaults.FaultPlan.generate(seed=seed, sites=sites).to_json()
        assert plan.to_json() == jfaults.FaultPlan.generate(seed=seed, sites=sites).to_json()
        # the notice fields survive the environ round trip workers re-parse
        assert tfaults.FaultPlan.from_json(plan.to_json()).to_json() == plan.to_json()
    lease = [s for s in tfaults.FaultPlan.generate(seed).specs if s.site == "runtime.lease"]
    assert lease[0].action == "notice" and lease[0].notice_s >= 2.0
    with pytest.raises(ValueError, match="no generator template"):
        tfaults.FaultPlan.generate(seed, sites=["batch.runner"])


def test_notice_spec_validation_and_perturb_revoke(_clean_faults):
    for faults in (tfaults, jfaults):
        with pytest.raises(ValueError):
            faults.FaultSpec("runtime.lease", "notice", notice_s=-1.0)
        faults.install(faults.FaultPlan(seed=0, specs=[
            faults.FaultSpec("runtime.lease", "revoke", at=2),
            faults.FaultSpec("batch.runner", "delay", delay_s=0.0)]))
        assert faults.perturb("runtime.lease", key="1") is None
        with pytest.raises(faults.LeaseRevokedError, match="lease revoked"):
            faults.perturb("runtime.lease", key="1")
        assert faults.perturb("batch.runner", key="job").action == "delay"
        assert faults.stats()["fired"] == {"runtime.lease:revoke": 1,
                                           "batch.runner:delay": 1}
        faults.clear()


def test_cold_revoke_does_not_leak_chips(tair, _clean_faults):
    tfaults.install(tfaults.FaultPlan(seed=2, specs=[
        tfaults.FaultSpec("runtime.lease", "revoke", at=1)]))
    with pytest.raises(tfaults.LeaseRevokedError):
        tair.lease_chips(2, timeout=30.0)
    tfaults.clear()
    assert tair.avail["chip"] == 2.0 and sorted(tair.free_chips) == [0, 1]
    lease = tair.lease_chips(2, timeout=30.0)     # the same shape leases cleanly
    try:
        assert isinstance(lease, rt.ChipLease) and sorted(lease) == [0, 1]
        assert tair.avail["chip"] == 0.0
    finally:
        tair.release_chips(lease)
    assert tair.avail["chip"] == 2.0
    with pytest.raises(rt.TpuAirError, match="exceeds cluster total"):
        tair.lease_chips(3)
    held = tair.lease_chips(2)
    try:
        with pytest.raises(TimeoutError):
            tair.lease_chips(1, timeout=0.2)
    finally:
        tair.release_chips(held)


def test_notice_action_grants_then_revokes_with_warning(tair, _clean_faults):
    tfaults.install(tfaults.FaultPlan(seed=3, specs=[
        tfaults.FaultSpec("runtime.lease", "notice", at=1, delay_s=0.05, notice_s=30.0)]))
    lease = tair.lease_chips(1, timeout=30.0)
    try:
        got = []
        lease.on_revoke(got.append)
        deadline = time.monotonic() + 10.0
        while not lease.revoking and time.monotonic() < deadline:
            time.sleep(0.01)
        assert lease.revoking and got == [30.0]
        assert not lease.expired                 # the 30 s window is still open
        tair.revoke_lease(lease, notice_s=1.0)   # a later notice changes nothing
        assert lease.notice_s == 30.0
    finally:
        tfaults.clear()
        tair.release_chips(lease)


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_attach_chip_lease(pkg, monkeypatch, _clean_faults):
    mod, faults = (jrt, jfaults) if pkg == "jax" else (rt, tfaults)
    monkeypatch.setenv("TPU_AIR_CHIP_IDS", "1")
    lease = mod.attach_chip_lease()
    assert lease == [1] and not lease.revoking
    assert mod.attach_chip_lease([]) == []        # a fractional actor holds no id
    # a cold revoke on an actor already placed: an immediate zero notice
    faults.install(faults.FaultPlan(seed=0, specs=[
        faults.FaultSpec("runtime.lease", "revoke", at=1, match="chips=1")]))
    lease = mod.attach_chip_lease()
    assert lease.revoking and lease.notice_s == 0.0 and lease.expired
    faults.install(faults.FaultPlan(seed=0, specs=[
        faults.FaultSpec("runtime.lease", "notice", at=1, match="chips=1",
                         delay_s=0.05, notice_s=20.0)]))
    assert not mod.attach_chip_lease([0]).revoking      # not matched: no timer
    lease = mod.attach_chip_lease()
    assert lease.wait_expired(0.0) is False
    deadline = time.monotonic() + 10.0
    while not lease.revoking and time.monotonic() < deadline:
        time.sleep(0.01)
    assert lease.notice_s == 20.0 and not lease.expired


@pytest.mark.parametrize("request_chips,entitled", [(1.0, True), (0.5, False), (64.0, False)])
def test_driver_lease_does_not_outrace_a_queued_actor_that_fits(tair, air, request_chips,
                                                                entitled):
    """A queued request that fits and takes whole devices holds the host
    against a driver lease; a fractional one (no device id) and one that
    does not fit hold nothing, as the JAX scan decides on one host."""
    jax_rt = jrt.get_runtime()
    rec = {"resources": {"cpu": 0.0, "chip": request_chips}}
    for runtime in (tair, jax_rt):
        with runtime.lock:
            runtime.actor_queue.append(rec)
            try:
                got = runtime._queued_reservations()
            finally:
                runtime.actor_queue.remove(rec)
        assert bool(got) is entitled


def test_migrate_out_freezes_a_busy_loop_between_steps(model):
    """The engine's own loop decoding four long streams: ``migrate_out``
    takes the step lock between two steps and ships every slot mid-stream,
    rather than waiting for the loop to run out of work."""
    from tpu_air_torch.engine import InferenceEngine

    engine = InferenceEngine(model, EngineConfig(num_slots=4, slot_len=512, page_len=16,
                                                 max_new_tokens=400, eos_token_id=None))
    try:
        streams = [engine.submit(p) for p in _prompts(81, 4)]
        deadline = time.monotonic() + 60.0
        while min(len(s.tokens_so_far()) for s in streams) < 4:
            assert time.monotonic() < deadline
            time.sleep(0.001)
        payloads = engine.migrate_out()
        assert len(payloads) == 4
        assert all(4 <= len(pl["streamed"]) < 400 for pl in payloads)
        assert not any(s.done for s in streams)
    finally:
        engine.close()


# -- two replicas: lease notices over the serve plane -------------------------------------


def _post(path, payload, headers=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{PORT}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", **(headers or {})}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.loads(resp.read()), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


class _FeedClient(threading.Thread):
    """Keeps submitting streams (each polled to its end under its pin)
    until told to stop; records every finished stream and any non-200
    after admission."""

    def __init__(self, path, prompts, max_new):
        super().__init__(daemon=True)
        self.path, self.prompts, self.max_new = path, prompts, max_new
        self.stop = threading.Event()
        self.finished = []
        self.bad = []

    def run(self):
        for prompt in self.prompts:
            if self.stop.is_set():
                return
            status, out, hdrs = _post(self.path, {"action": "submit", "prompt": prompt,
                                                  "max_new_tokens": self.max_new})
            if status != 200:
                time.sleep(0.05)       # shed before admission: legal, go on
                continue
            pin = {"x-tpu-air-replica": hdrs.get("x-tpu-air-replica", "")}
            toks = []
            deadline = time.monotonic() + 120.0
            while time.monotonic() < deadline:
                status, res, _ = _post(self.path, {"action": "poll",
                                                   "request_id": out["request_id"],
                                                   "cursor": len(toks)}, headers=pin)
                if status != 200:
                    self.bad.append((prompt, status, res))
                    return
                toks += res.get("tokens") or []
                if res.get("done"):
                    self.finished.append((prompt, toks))
                    break
                time.sleep(0.01)


def _drive_until(clients, cond, timeout=90.0):
    deadline = time.monotonic() + timeout
    ok = False
    while time.monotonic() < deadline:
        if cond():
            ok = True
            break
        if not any(c.is_alive() for c in clients):
            break
        time.sleep(0.1)
    for c in clients:
        c.stop.set()
    for c in clients:
        c.join(timeout=120.0)
        assert not c.is_alive()
    return ok


def _two_replicas(model, name, prefix, max_new, fault_plan=None):
    ckpt = Checkpoint.from_model(model_config=model.config, params=model.state_dict())
    return serve.run(
        EngineDeployment.options(name=name, route_prefix=prefix, num_replicas=2, num_chips=1)
        .bind(ckpt, EngineConfig(num_slots=4, slot_len=96, page_len=16,
                                 max_new_tokens=max_new, eos_token_id=None), device="cpu"),
        port=PORT, fault_plan=fault_plan)


def _check_streams(lm, clients, max_new):
    for c in clients:
        assert c.bad == [], c.bad
        for prompt, toks in c.finished:
            assert toks == _expected(lm, prompt, max_new)
    assert sum(len(c.finished) for c in clients) >= 4


def test_lease_notice_migrates_live_streams_token_identical(lm, model, tair, _clean_faults):
    """A plan revokes the replica on device 1 WITH notice mid-decode under
    streaming load: the watcher moves its live KV pages into the other
    replica's process, every stream equals the undisturbed decode, and no
    prefill chunk runs again for a migrated slot."""
    from tpu_air_torch.engine.metrics import merge_snapshots

    plan = tfaults.FaultPlan(seed=19, specs=[tfaults.FaultSpec(
        "runtime.lease", "notice", at=1, match="chips=1", delay_s=1.5, notice_s=60.0)])
    max_new = 48
    try:
        _two_replicas(model, "lm-mig", "/tmig", max_new, fault_plan=plan)
        clients = [_FeedClient("/tmig", _prompts(40 + i, 40), max_new) for i in range(4)]
        for c in clients:
            c.start()

        def migrated():
            return proxy.serve_control_stats()["recovery"].get("migrations", 0) >= 1

        assert _drive_until(clients, migrated), proxy.serve_control_stats()["recovery"]
        _check_streams(lm, clients, max_new)
        rec = proxy.serve_control_stats()["recovery"]
        assert rec["preemptions"] >= 1 and rec["borrow_returns"] == 0
        assert rec["migrations"] >= 1 and rec["migrated_pages"] >= 1
        mg = merge_snapshots(proxy.replica_engine_stats()).get("migrations") or {}
        assert mg.get("in", 0) >= 1 and mg.get("in_reprefill_chunks", 0) == 0
    finally:
        serve.shutdown()


def test_zero_notice_revocation_falls_back_to_replay(lm, model, tair, _clean_faults):
    plan = tfaults.FaultPlan(seed=23, specs=[tfaults.FaultSpec(
        "runtime.lease", "notice", at=1, match="chips=1", delay_s=1.5, notice_s=0.0)])
    max_new = 48
    try:
        _two_replicas(model, "lm-fb", "/tfb", max_new, fault_plan=plan)
        clients = [_FeedClient("/tfb", _prompts(60 + i, 40), max_new) for i in range(4)]
        for c in clients:
            c.start()

        def fell_back():
            rec = proxy.serve_control_stats()["recovery"]
            return rec.get("migration_fallbacks", 0) >= 1 and rec.get("replays", 0) >= 1

        assert _drive_until(clients, fell_back), proxy.serve_control_stats()["recovery"]
        _check_streams(lm, clients, max_new)
        rec = proxy.serve_control_stats()["recovery"]
        assert rec["preemptions"] >= 1 and rec["migration_fallbacks"] >= 1
        assert rec["replays"] >= 1 and rec["replay_failures"] == 0
    finally:
        serve.shutdown()


class _Stream(threading.Thread):
    """One journaled stream through the proxy, polled to its end."""

    def __init__(self, prefix, prompt, max_new):
        super().__init__(daemon=True)
        self.prefix, self.prompt, self.max_new = prefix, prompt, max_new
        self.pin, self.tokens, self.done, self.bad = None, [], False, []

    def run(self):
        status, out, hdrs = _post(self.prefix, {"action": "submit", "prompt": self.prompt,
                                                "max_new_tokens": self.max_new,
                                                "priority": "batch"})
        if status != 200:
            self.bad.append(("submit", status, out))
            return
        self.pin = hdrs.get("x-tpu-air-replica", "")
        deadline = time.monotonic() + 120.0
        while time.monotonic() < deadline:
            status, res, _ = _post(self.prefix, {"action": "poll",
                                                 "request_id": out["request_id"],
                                                 "cursor": len(self.tokens)},
                                   headers={"x-tpu-air-replica": self.pin})
            if status != 200:
                self.bad.append(("poll", status, res))
                return
            self.tokens += res.get("tokens") or []
            if res.get("done"):
                self.done = True
                return
            time.sleep(0.005)


def test_borrow_return_migrates_without_backfill(lm, model, tair):
    """The batch lane's return path by hand: ``shrink_target``,
    ``mark_borrowed`` and the ``borrow_return`` RPC with a 5 s notice move
    the returned replica's live streams into the other process; the
    watcher counts one borrow return and spawns nothing in its place."""
    max_new = 80
    prompts = _prompts(71, 6)
    try:
        handle = _two_replicas(model, "lm-ret", "/tret", max_new)
        for r in handle._replicas:             # warm both engines
            tpu_air_torch.get(r.handle.remote("weights_probe", ([[1, 2, 3]], 2), {}))
        streams = [_Stream("/tret", p, max_new) for p in prompts]
        for s in streams:
            s.start()
        deadline = time.monotonic() + 60.0
        while not all(s.pin and len(s.tokens) >= 2 for s in streams):
            assert time.monotonic() < deadline and not any(s.bad for s in streams)
            time.sleep(0.005)
        tag = streams[0].pin
        source = next(r for r in handle._replicas if r._actor_id == tag)
        watcher = proxy.route_control("/tret")["watcher"]
        assert handle.shrink_target() == 1
        watcher.mark_borrowed(tag)
        assert tpu_air_torch.get(source.handle.remote("borrow_return", (5.0,), {})) is True
        for s in streams:
            s.join(timeout=120.0)
            assert not s.is_alive() and s.bad == [] and s.done
        for s, p in zip(streams, prompts):
            assert s.tokens == _expected(lm, p, max_new)
        deadline = time.monotonic() + 30.0
        while handle.live_replicas() != 1 and time.monotonic() < deadline:
            time.sleep(0.05)
        st = watcher.stats()
        assert st["borrow_returns"] == 1 and st["preemptions"] == 1
        assert st["migrations"] >= 1 and st["migration_fallbacks"] == 0
        assert handle.live_replicas() == 1
        dest = handle._replicas[0]
        assert dest._actor_id != tag
        mg = tpu_air_torch.get(dest.handle.remote("stats", (), {}))["migrations"]
        assert mg["in"] == st["migrations"] and mg["in_reprefill_chunks"] == 0
    finally:
        serve.shutdown()
