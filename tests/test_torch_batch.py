"""The port's batch lane (``tpu_air_torch.batch``) on the CPU, held against
the JAX package's (``tpu_air.batch``) on the same numpy-seeded inputs:

* ``shard_plan`` and ``ShardedReader``'s rows (global indices and prompts,
  whole streams and resumed suffixes) equal the JAX ones;
* a ``row_fn`` job killed by the ``batch.runner`` fault site at chunk 3 and
  then resumed commits every row exactly once, its results and counters
  equal to the JAX job's through the same kill;
* a resume with another fingerprint and an ``interactive`` job are refused
  in both packages; ``AdmissionPolicy.clamp_budget`` caps unset asks of
  the tail classes as the JAX policy does;
* a job served through ``EngineDeployment`` (``device="cpu"``) returns,
  row by row, the JAX package's ``lm_generate`` tokens, billed to tenant
  ``batch:<job_id>`` and reported on ``/-/stats``;
* borrowing on a trough: with two device slots (``init(num_chips=2)``) the
  job borrows a replica through ``scale_up`` and hands it back through
  ``borrow_return`` and the preemption watcher, with nothing stranded;
* ``/api/batch`` and the ``tpu_air_batch_*`` families of both dashboards
  agree for an equivalent registered job.

Weights: a Flax init of ``LMConfig.tiny()`` scaled by 4, carried into the
port; f32; tokens compared exactly.  Ports: ``PORT`` (8361, no other test
file uses it).  The port's runtime is this file's own (two device slots);
one another file left in place is set aside and put back.
"""

import collections
import re
import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import tpu_air.data as jdata  # noqa: E402
import tpu_air_torch  # noqa: E402
import tpu_air_torch.data as tdata  # noqa: E402
from tpu_air import batch as jbatch  # noqa: E402
from tpu_air import faults as jfaults  # noqa: E402
from tpu_air.core.runtime import get_runtime as jget_runtime  # noqa: E402
from tpu_air.models import lm as jlm  # noqa: E402
from tpu_air.models.lm.generate import generate as lm_generate  # noqa: E402
from tpu_air.observability import dashboard as jdash  # noqa: E402
from tpu_air_torch import batch as tbatch  # noqa: E402
from tpu_air_torch import serve  # noqa: E402
from tpu_air_torch.core import runtime as rt  # noqa: E402
from tpu_air_torch.engine import EngineConfig  # noqa: E402
from tpu_air_torch.faults import plan as tfaults  # noqa: E402
from tpu_air_torch.models import lm as tlm  # noqa: E402
from tpu_air_torch.observability import dashboard as tdash  # noqa: E402
from tpu_air_torch.serve import EngineDeployment  # noqa: E402
from tpu_air_torch.serve import proxy  # noqa: E402
from tpu_air_torch.train import Checkpoint  # noqa: E402

PORT = 8361
CFG = jlm.LMConfig.tiny()
V = CFG.vocab_size
PACKAGES = {
    "jax": (jdata, jbatch, jfaults),
    "torch": (tdata, tbatch, tfaults),
}
# counters a job reports that depend on the clock, not on the rows
CLOCKED = ("elapsed_s", "rows_per_s")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh_job_registries(monkeypatch):
    """Each test registers its jobs in empty job registries of both
    packages, put back afterwards, so that no job of this file is left for
    a later test (``/api/batch``, the ``tpu_air_batch_*`` families) to
    see."""
    from tpu_air.batch import job as jjob
    from tpu_air_torch.batch import job as tjob

    for job_mod in (jjob, tjob):
        monkeypatch.setattr(job_mod, "_registry", {})


@pytest.fixture(scope="module")
def lm():
    """(jax model, jax params, port model) on one set of weights."""
    jmodel = jlm.CausalLM(CFG)
    init = jmodel.init(jax.random.PRNGKey(0), jnp.ones((1, 8), jnp.int32))["params"]
    params = jax.tree_util.tree_map(lambda x: np.asarray(x) * np.float32(4), init)
    model = tlm.CausalLM(tlm.LMConfig.from_dict(CFG.to_dict()), device="cpu")
    model.load_state_dict(tlm.params_from_jax(params))
    return jmodel, params, model


@pytest.fixture(scope="module")
def tair(air):
    """The JAX session runtime (``air``) and a port runtime of this file's
    own with two device slots, so a borrowed replica has one to take."""
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


def _dataset(pkg, seed, n, parallelism=4):
    return PACKAGES[pkg][0].from_items([{"prompt": p} for p in _prompts(seed, n)],
                                       parallelism=parallelism)


def _chunk_occurrences(job, store):
    """Every global row index across the job's committed chunk objects —
    the raw exactly-once evidence (``results()`` would dedup)."""
    counts = collections.Counter()
    for s in range(job.cfg.num_shards):
        for c in range(10000):
            cid = job._chunk_id(s, c)
            if not store.contains(cid):
                break
            counts.update(int(k) for k in store.get(cid)["rows"])
    return counts


def _store(pkg):
    return (jget_runtime() if pkg == "jax" else rt.get_runtime()).store


def _unclocked(stats):
    return {k: v for k, v in stats.items() if k not in CLOCKED}


def _jax_tokens(lm, prompt, max_new):
    jmodel, params, _ = lm
    return np.asarray(lm_generate(jmodel, params, [prompt], max_new_tokens=max_new,
                                  eos_token_id=None))[0].tolist()


# -- sharded readers ---------------------------------------------------------------------


@pytest.mark.parametrize("counts,num_shards,seed", [
    ([10, 5, 7, 3, 12, 1, 9, 4], 3, 7),
    ([10, 5, 7, 3, 12, 1, 9, 4], 3, 8),
    ([4, 4, 4, 4], 2, 0),
    ([1], 4, 5),
    (list(np.random.RandomState(11).randint(1, 50, size=33)), 5, 123),
])
def test_shard_plan_equals_jax(counts, num_shards, seed):
    counts = [int(c) for c in counts]
    plan = tbatch.shard_plan(counts, num_shards, seed)
    assert plan == jbatch.shard_plan(counts, num_shards, seed)
    assert sorted(b for s in plan for b in s) == list(range(len(counts)))
    for pkg in (tbatch, jbatch):
        with pytest.raises(ValueError):
            pkg.shard_plan(counts, 0, seed)


def _rows(reader, start=0):
    # pandas round-trips the list column as ndarray cells: normalize
    return [(gi, [int(t) for t in row["prompt"]]) for gi, row in reader.rows(start)]


@pytest.mark.parametrize("n,parallelism,num_shards,seed", [(23, 5, 3, 11), (17, 4, 2, 9)])
def test_sharded_reader_rows_equal_jax(tair, n, parallelism, num_shards, seed):
    ds = {pkg: _dataset(pkg, 3 + n, n, parallelism) for pkg in PACKAGES}
    seen = collections.Counter()
    for s in range(num_shards):
        readers = {pkg: PACKAGES[pkg][1].ShardedReader(ds[pkg], s, num_shards, seed)
                   for pkg in PACKAGES}
        assert readers["torch"].describe() == readers["jax"].describe()
        full = _rows(readers["torch"])
        assert full == _rows(readers["jax"])
        assert len(full) == readers["torch"].total_rows()
        seen.update(gi for gi, _ in full)
        for cut in (0, 1, len(full) // 2, len(full)):
            tail = _rows(readers["torch"], cut)
            assert tail == full[cut:] == _rows(readers["jax"], cut)
    assert sorted(seen) == list(range(n)) and set(seen.values()) == {1}
    cursor = tbatch.ShardCursor(shard=1, rows_done=7)
    assert tbatch.ShardCursor.from_dict(cursor.to_dict()) == cursor
    assert cursor.to_dict() == jbatch.ShardCursor(shard=1, rows_done=7).to_dict()


# -- BatchJob checkpoint machinery (engine-free via row_fn) -------------------------------


def _killed_then_resumed(pkg, job_id):
    """Kill a ``row_fn`` job at its 3rd chunk commit, then resume it; the
    two incarnations' stats, the resumed results and the row calls."""
    _, batch, faults = PACKAGES[pkg]
    ds = _dataset(pkg, 17, 26, parallelism=5)
    cfg = batch.BatchJobConfig(num_shards=2, seed=6, chunk_rows=4, window=3)
    calls = []

    def row_fn(p):
        calls.append(1)
        return [t * 2 for t in p]

    faults.install(faults.FaultPlan(seed=1, specs=[
        faults.FaultSpec("batch.runner", "kill", at=3)]))
    job1 = batch.BatchJob(ds, job_id=job_id, config=cfg, row_fn=row_fn)
    with pytest.raises(batch.BatchJobKilled):
        job1.run()
    faults.clear()
    job2 = batch.BatchJob(ds, job_id=job_id, config=cfg, row_fn=row_fn)
    stats = job2.run()
    occ = _chunk_occurrences(job2, _store(pkg))
    return job1.stats(), stats, job2.results(), len(calls), occ


def test_killed_row_fn_job_resumes_exactly_once_as_jax(tair, _clean_faults):
    n = 26
    before, after, results, calls, occ = _killed_then_resumed("torch", "tb-resume")
    assert before["state"] == "failed" and 0 < before["rows_done"] < n
    assert after["state"] == "done" and after["resumes"] == 1
    assert after["rows_resumed"] == before["rows_done"]
    assert after["rows_processed"] == n - before["rows_done"]
    assert after["chunks_resumed"] >= 1
    assert calls == n                        # across both incarnations: each row ran ONCE
    assert sorted(occ) == list(range(n)), "dropped rows"
    assert set(occ.values()) == {1}, "duplicated rows"
    prompts = _prompts(17, n)
    assert results == {gi: [t * 2 for t in prompts[gi]] for gi in range(n)}
    jbefore, jafter, jresults, jcalls, jocc = _killed_then_resumed("jax", "tb-resume")
    assert _unclocked(before) == _unclocked(jbefore)
    assert _unclocked(after) == _unclocked(jafter)
    assert results == jresults and calls == jcalls and occ == jocc
    assert tfaults.stats()["installed"] is False


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_mismatched_resume_is_refused(tair, pkg):
    _, batch, _ = PACKAGES[pkg]
    ds = _dataset(pkg, 19, 8, parallelism=2)
    base = dict(num_shards=2, chunk_rows=4, window=2)
    batch.BatchJob(ds, job_id="tb-fpr", config=batch.BatchJobConfig(seed=1, **base),
                   row_fn=list).run()
    clash = batch.BatchJob(ds, job_id="tb-fpr", config=batch.BatchJobConfig(seed=2, **base),
                           row_fn=list)
    with pytest.raises(ValueError, match="re-shard"):
        clash.run()
    assert clash.stats()["state"] == "failed"


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_interactive_priority_is_refused(tair, pkg):
    _, batch, _ = PACKAGES[pkg]
    ds = _dataset(pkg, 19, 4, parallelism=1)
    with pytest.raises(ValueError, match="interactive"):
        batch.BatchJob(ds, config=batch.BatchJobConfig(priority="interactive"))


def test_config_defaults_equal_jax():
    assert (tbatch.BatchJobConfig().__dict__ == jbatch.BatchJobConfig().__dict__)
    assert tbatch.BatchJobConfig().borrow_notice_s == 5.0


def test_clamp_budget_caps_unset_asks_as_jax():
    from tpu_air.serve.admission import AdmissionPolicy as JPolicy
    from tpu_air_torch.serve.admission import AdmissionPolicy as TPolicy

    kw = dict(token_budgets={"interactive": 256, "batch": 1024, "best_effort": 512},
              tenant_token_budgets={"t-small": 64})
    tp, jp = TPolicy(**kw), JPolicy(**kw)
    for priority in ("interactive", "batch", "best_effort"):
        for ask in (None, 1, 100, 9000):
            for tenant in (None, "t-small", "t-other"):
                assert tp.clamp_budget(priority, ask, tenant) == \
                    jp.clamp_budget(priority, ask, tenant)
    assert tp.clamp_budget("interactive", None) is None
    assert tp.clamp_budget("best_effort", None) == 512
    assert tp.clamp_budget("batch", None) == 1024
    assert tp.clamp_budget("best_effort", None, "t-small") == 64


# -- the serve lane -----------------------------------------------------------------------


def _deploy(model, name, prefix, max_new, **opts):
    ckpt = Checkpoint.from_model(model_config=model.config, params=model.state_dict())
    return serve.run(
        EngineDeployment.options(name=name, route_prefix=prefix, num_replicas=1,
                                 num_chips=1, **opts)
        .bind(ckpt, EngineConfig(num_slots=4, slot_len=64, page_len=16,
                                 max_new_tokens=max_new, eos_token_id=None),
              device="cpu"),
        port=PORT)


def test_served_job_tokens_equal_jax_generate(lm, tair):
    from tpu_air_torch.engine.metrics import merge_snapshots

    n, max_new = 10, 12
    ds = _dataset("torch", 29, n, parallelism=3)
    try:
        _deploy(lm[2], "lm-batch", "/batchlane", max_new)
        job = tbatch.BatchJob(ds, job_id="tb-serve", config=tbatch.BatchJobConfig(
            route_prefix="/batchlane", max_new_tokens=max_new, num_shards=2, seed=8,
            chunk_rows=3, window=4))
        stats = job.run()
        assert stats["state"] == "done" and stats["rows_done"] == n
        results = job.results()
        prompts = _prompts(29, n)
        assert sorted(results) == list(range(n))
        for gi, toks in results.items():
            assert toks == _jax_tokens(lm, prompts[gi], max_new), gi
        # one admission path: the route's controller metered every row
        # under the job's tenant, and the engine billed its tokens to it
        adm = proxy.route_control("/batchlane")["admission"]
        assert adm.tenants["batch:tb-serve"]["admitted"] == n
        tenants = merge_snapshots(proxy.replica_engine_stats()).get("tenants") or {}
        assert tenants["batch:tb-serve"]["requests_completed"] == n
        assert proxy.serve_control_stats()["batch"]["tb-serve"]["rows_done"] == n
        with pytest.raises(KeyError, match="no deployment"):
            proxy.route_control("/nowhere")
    finally:
        serve.shutdown()


def test_borrowing_on_a_trough_returns_every_loan(lm, tair):
    n, max_new = 8, 8
    ds = _dataset("torch", 31, n, parallelism=2)
    try:
        handle = _deploy(lm[2], "lm-borrow", "/borrow", max_new)
        assert handle.live_replicas() == 1
        assert rt.get_runtime().avail["chip"] == 1.0     # one slot free to borrow
        job = tbatch.BatchJob(ds, job_id="tb-borrow", config=tbatch.BatchJobConfig(
            route_prefix="/borrow", max_new_tokens=max_new, num_shards=2, seed=12,
            chunk_rows=2, window=2, borrow=True, borrow_depth_low=4.0,
            borrow_depth_high=100.0, borrow_notice_s=10.0))
        stats = job.run()
        assert stats["state"] == "done" and stats["rows_done"] == n
        assert stats["borrows"] >= 1
        assert stats["borrow_returns"] == stats["borrows"]
        assert stats["borrowed_replicas"] == 0           # nothing stranded
        deadline = time.monotonic() + 60.0
        while time.monotonic() < deadline:
            rec = proxy.serve_control_stats()["recovery"]
            if (rec.get("borrow_returns", 0) >= stats["borrows"]
                    and handle.live_replicas() == 1
                    and rt.get_runtime().avail["chip"] == 1.0):
                break
            time.sleep(0.2)
        rec = proxy.serve_control_stats()["recovery"]
        assert rec["borrow_returns"] == stats["borrows"], rec
        # a voluntary return is not backfilled: back at the deployed size,
        # the borrowed slot free again
        assert handle.live_replicas() == 1
        assert rt.get_runtime().avail["chip"] == 1.0
        prompts = _prompts(31, n)
        for gi, toks in job.results().items():
            assert toks == _jax_tokens(lm, prompts[gi], max_new), gi
    finally:
        serve.shutdown()


# -- observability ------------------------------------------------------------------------


def _batch_samples(text):
    """``{(family, labels): value}`` of the ``tpu_air_batch_*`` samples."""
    out = {}
    for line in text.splitlines():
        m = re.match(r"(tpu_air_batch_\w+)(\{[^}]*\})? (\S+)$", line)
        if m:
            out[(m.group(1), m.group(2) or "")] = float(m.group(3))
    return out


def test_api_batch_and_families_equal_jax(tair):
    """Each package's job registry holds only this test's job (the same
    dataset, config and ``row_fn``): ``/api/batch`` and the
    ``tpu_air_batch_*`` samples of ``/metrics`` agree, clocked values
    aside."""
    for pkg in PACKAGES:
        _, batch, _ = PACKAGES[pkg]
        batch.BatchJob(_dataset(pkg, 41, 11, parallelism=3), job_id="tb-obs",
                       config=batch.BatchJobConfig(num_shards=2, seed=3, chunk_rows=4),
                       row_fn=list).run()
    tpay, jpay = tdash.batch_payload(), jdash.batch_payload()
    assert sorted(tpay["jobs"]) == ["tb-obs"]
    assert {j: _unclocked(s) for j, s in tpay["jobs"].items()} == \
        {j: _unclocked(s) for j, s in jpay["jobs"].items()}
    assert tpay["jobs"]["tb-obs"]["rows_done"] == 11
    tsamples, jsamples = (_batch_samples(tdash._prometheus_text()),
                          _batch_samples(jdash._prometheus_text()))
    assert sorted(tsamples) == sorted(jsamples)
    assert tsamples[("tpu_air_batch_rows_done", '{job="tb-obs"}')] == 11.0
    for key, value in tsamples.items():
        if key[0] != "tpu_air_batch_rows_per_s":
            assert value == jsamples[key], key
