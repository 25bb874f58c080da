"""The port's sharded and disaggregated LM serving
(``tpu_air_torch/engine/dist``) on the CPU, against ``tpu_air.engine.dist``.

* ``ShardedPagedPool``: the JAX package's ``TestShardedPagedPool`` cases on
  both packages, and one seeded sequence of admit, chunk_row, register,
  resolve_cow, prompt_page_ids and release calls giving equal block tables,
  null pages, capacities and stats.
* ``MeshEngine`` at (dp, tp) in (1,1), (2,1), (1,2), (2,2), (1,4), manual
  stepping, prompts behind a shared prefix: tokens identical to the JAX
  ``MeshEngine`` at the same mesh (the 8 host devices ``tests/conftest.py``
  forces), to the port's ``InferenceEngine`` and to the JAX offline
  ``generate``; the first decode step's logits within 1e-4 (scaled) of
  the JAX model's.  Its refusals and per-replica admission on both
  packages, its chip lease, and a stream migrated out of it.
* ``submit_prefilled``: a payload the JAX package's ``extract_kv_pages``
  made after a JAX prefill, and the port's ``PrefillWorker``'s own, give
  the JAX engine's tokens; a handoff defers on pool exhaustion.
* ``DisaggRouter`` with 2 prefill replicas on the CPU, in a port runtime
  this file starts: tokens, one trace id across ``engine.prefill``,
  ``engine.kv_transfer`` and decode, a replica killed by the
  ``prefill.worker`` fault re-routing, all killed falling back.
* ``_EngineServer`` with ``mesh=(2, 2)`` and ``disagg=``.

Weights: a Flax init of ``LMConfig.tiny()`` scaled by 4, carried into the
port; f32, the decode kernel's plain version.  Tokens are compared exactly.
"""

import importlib
import os
import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import tpu_air_torch  # noqa: E402
from tpu_air.engine import EngineConfig as JEngineConfig  # noqa: E402
from tpu_air.engine import InferenceEngine as JInferenceEngine  # noqa: E402
from tpu_air.engine import MeshEngine as JMeshEngine  # noqa: E402
from tpu_air.engine import ShardedPagedPool as JShardedPagedPool  # noqa: E402
from tpu_air.engine.dist.kv_transfer import extract_kv_pages as jextract  # noqa: E402
from tpu_air.engine.kvpool import PagedKVPool as JPagedKVPool  # noqa: E402
from tpu_air.models import lm as jlm  # noqa: E402
jgen = importlib.import_module("tpu_air.models.lm.generate")   # the module, not the function
from tpu_air_torch.core import runtime as rt  # noqa: E402
from tpu_air_torch.engine import (  # noqa: E402
    DisaggRouter,
    EngineConfig,
    InferenceEngine,
    MeshEngine,
    PrefillWorker,
    ShardedPagedPool,
)
from tpu_air_torch.engine.dist import mesh_engine as tmesh_engine  # noqa: E402
from tpu_air_torch.engine.dist.sharded import paged_decode_logits  # noqa: E402
from tpu_air_torch.faults import plan as tfaults  # noqa: E402
from tpu_air_torch.models import lm as tlm  # noqa: E402
from tpu_air_torch.observability import tracing  # noqa: E402
from tpu_air_torch.serve.engine_deployment import _EngineServer  # noqa: E402
from tpu_air_torch.train import Checkpoint  # noqa: E402

CFG = jlm.LMConfig.tiny()
V = CFG.vocab_size
CPU = torch.device("cpu")
MESHES = [(1, 1), (2, 1), (1, 2), (2, 2), (1, 4)]
ECFG = dict(num_slots=4, slot_len=64, max_new_tokens=6, page_len=8)


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


@pytest.fixture(scope="module")
def ckpt(lm, tmp_path_factory):
    model = lm[2]
    return Checkpoint.from_model(model_config=model.config, params=model.state_dict(),
                                 path=str(tmp_path_factory.mktemp("dist_ckpt")))


@pytest.fixture(scope="module")
def tair():
    """A port runtime of this file's own (4 chip slots for the mesh lease),
    the session's put back afterwards."""
    saved = rt._runtime
    rt._runtime = None
    runtime = tpu_air_torch.init(num_cpus=4, num_chips=4)
    try:
        yield runtime
    finally:
        tpu_air_torch.shutdown()
        rt._runtime = saved


@pytest.fixture
def _clean():
    tfaults.clear()
    tracing.disable()
    tracing.recorder().clear()
    yield
    tfaults.clear()
    tracing.disable()
    tracing.recorder().clear()


def _prompts(seed=0, n=7):
    """Prompts of 3-20 tokens; every other one behind one 16-token (two
    page) prefix, one of them the prefix itself cut mid-page."""
    rng = np.random.RandomState(seed)
    prefix = list(map(int, rng.randint(1, V, 16)))
    out = []
    for i in range(n):
        if i == 2:
            out.append(prefix[:13])
        elif i % 2 == 0:
            out.append(prefix + list(map(int, rng.randint(1, V, rng.randint(1, 6)))))
        else:
            out.append(list(map(int, rng.randint(1, V, rng.randint(3, 20)))))
    return out


def _drain(engine, limit=800):
    steps = 0
    while not engine.idle():
        engine.step()
        steps += 1
        assert steps < limit, "engine failed to drain"
    return steps


def _offline_jax(jmodel, params, prompt, max_new):
    return np.asarray(jgen.generate(jmodel, params, [prompt], max_new_tokens=max_new))[0].tolist()


def _offline(model, prompt, max_new):
    return tlm.generate(model, [prompt], max_new_tokens=max_new)[0].tolist()


# -- ShardedPagedPool --------------------------------------------------------------------------

POOLS = {"jax": JShardedPagedPool, "torch": ShardedPagedPool}


def _pool(pkg, dp=2, ppr=9, page_len=8, slots=4, ppslot=4):
    return POOLS[pkg](dp, ppr, page_len, slots, ppslot)


def _slot_routing_and_null_pages(pkg):
    pool = _pool(pkg)
    assert [pool.replica_of(s) for s in range(4)] == [0, 0, 1, 1]
    assert [pool.null_page_of(s) for s in range(4)] == [0, 0, 9, 9]


def _global_block_table_offsets(pkg):
    pool = _pool(pkg)
    pool.admit(0, list(range(1, 17)), 4)
    pool.admit(2, list(range(1, 17)), 4)
    table = pool.block_table
    r0 = [p for p in table[0] if p != 0]
    r1 = [p for p in table[2] if p != 9]
    assert r0 and r1
    assert all(0 < p < 9 for p in r0) and all(9 < p < 18 for p in r1)
    assert [p - 9 for p in r1] == r0


def _chunk_row_and_prompt_ids_offset(pkg):
    pool = _pool(pkg)
    prompt = list(range(1, 17))
    pool.admit(3, prompt, 4)
    assert all(p >= 9 for p in pool.chunk_row(3, 0, null_target=False))
    ids = pool.prompt_page_ids(3, len(prompt))
    assert len(ids) == 2 and all(9 < p < 18 for p in ids)


def _capacity_is_per_replica(pkg):
    pool = _pool(pkg)
    assert pool.replica_capacity(0) == pool.replicas[0].capacity()
    assert pool.capacity() == sum(p.capacity() for p in pool.replicas)
    pool.admit(0, list(range(1, 17)), 4)
    pool.admit(1, list(range(17, 33)), 4)
    assert pool.replica_capacity(1) == pool.replicas[1].capacity()
    assert pool.replica_capacity(0) < pool.replica_capacity(1)


def _stats_aggregate(pkg):
    pool = _pool(pkg)
    pool.admit(0, list(range(1, 17)), 4)
    st = pool.stats()
    assert st["dp_replicas"] == 2 and st["pages_total"] == 16
    assert st["pages_used"] == sum(p.stats()["pages_used"] for p in pool.replicas)


def _rejects_indivisible_slots(pkg):
    with pytest.raises(ValueError, match="not divisible by dp 3"):
        POOLS[pkg](3, 9, 8, 4, 4)


POOL_CASES = {f.__name__.lstrip("_"): f for f in (
    _slot_routing_and_null_pages, _global_block_table_offsets, _chunk_row_and_prompt_ids_offset,
    _capacity_is_per_replica, _stats_aggregate, _rejects_indivisible_slots)}


@pytest.mark.parametrize("pkg", sorted(POOLS))
@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_sharded_pool_cases_on_both_packages(case, pkg):
    POOL_CASES[case](pkg)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sharded_pool_differential_op_sequence(seed):
    """The same seeded admit / chunk_row / register / resolve_cow /
    prompt_page_ids / release sequence on both packages' pools."""
    rng = np.random.RandomState(seed)
    pools = [POOLS[p](2, 13, 4, 6, 6) for p in ("jax", "torch")]
    prefix = list(map(int, rng.randint(1, 50, 8)))
    live = {}
    for _ in range(40):
        free = [s for s in range(6) if s not in live]
        if free and (not live or rng.rand() < 0.6):
            slot = int(rng.choice(free))
            n = int(rng.randint(1, 14))
            prompt = (prefix[:int(rng.randint(4, 9))] if rng.rand() < 0.5 else []) \
                + list(map(int, rng.randint(1, 50, n)))
            budget = int(rng.randint(1, 8))
            if len(prompt) + budget > 24:
                continue
            r = pools[0].replica_of(slot)
            if pools[0].worst_case_pages(len(prompt), budget) > pools[0].replica_capacity(r):
                continue
            plans = [p.admit(slot, prompt, budget) for p in pools]
            assert [vars(plans[0])] == [vars(plans[1])]
            for start in plans[0].chunk_starts:
                rows = [p.chunk_row(slot, start, plans[0].null_target) for p in pools]
                assert np.array_equal(rows[0], rows[1])
            assert pools[0].register(slot, prompt) == pools[1].register(slot, prompt)
            assert pools[0].resolve_cow(slot) == pools[1].resolve_cow(slot)
            assert (pools[0].prompt_page_ids(slot, len(prompt))
                    == pools[1].prompt_page_ids(slot, len(prompt)))
            live[slot] = prompt
        else:
            slot = int(rng.choice(sorted(live)))
            for p in pools:
                p.release(slot)
            del live[slot]
        assert np.array_equal(pools[0].block_table, pools[1].block_table)
        assert [p.null_page_of(s) for s in range(6) for p in pools[:1]] == \
            [p.null_page_of(s) for s in range(6) for p in pools[1:]]
        assert pools[0].capacity() == pools[1].capacity()
        assert [pools[0].replica_capacity(r) for r in (0, 1)] == \
            [pools[1].replica_capacity(r) for r in (0, 1)]
        assert pools[0].stats() == pools[1].stats()


# -- MeshEngine --------------------------------------------------------------------------------


def _capture_first_step(engine):
    """Wrap the decode step: on its first call, record the f32 logits of
    the rows decoding and their requests."""
    seen = {}
    step = engine._decode_step

    def wrapped(cache, tok, pos, table):
        if not seen:
            logits = paged_decode_logits(engine.sharded, cache, tok, pos, table)
            rows = [s.index for s in engine.slots.active_slots() if not s.prefilling]
            seen.update(logits=logits.clone(), rows=rows,
                        requests={i: engine.slots.slots[i].request for i in rows})
        return step(cache, tok, pos, table)

    engine._decode_step = wrapped
    return seen


MESH_PROMPTS = _prompts(0)
LOGIT_LEN = 32          # the JAX forward's right-padded length (causal: pads change nothing)


@pytest.fixture(scope="module")
def jax_reference(lm):
    """The JAX offline greedy tokens of ``MESH_PROMPTS`` and a function for
    the JAX model's next-token logits after a token list."""
    jmodel, params, _ = lm
    tokens = [_offline_jax(jmodel, params, p, ECFG["max_new_tokens"]) for p in MESH_PROMPTS]
    forward = jax.jit(lambda p, ids: jmodel.apply({"params": p}, ids))

    def logits(ids):
        padded = np.zeros((1, LOGIT_LEN), np.int32)
        padded[0, :len(ids)] = ids
        return np.asarray(forward(params, jnp.asarray(padded)))[0, len(ids) - 1]

    return tokens, logits


@pytest.mark.parametrize("dp,tp", MESHES)
def test_mesh_engine_matches_jax_mesh_and_single_card(lm, jax_reference, dp, tp):
    jmodel, params, model = lm
    prompts = MESH_PROMPTS
    cfg = dict(ECFG, prefill_chunks_per_step=16)
    eng = MeshEngine(model, EngineConfig(**cfg), dp=dp, tp=tp, devices=[CPU] * (dp * tp),
                     auto_start=False, name=f"mesh-{dp}x{tp}")
    try:
        first = _capture_first_step(eng)
        got = eng.generate(prompts)
        assert eng.metrics.snapshot()["topology"]["mesh"] == f"{dp}x{tp}"
    finally:
        eng.close()
    jeng = JMeshEngine(jmodel, params, JEngineConfig(**cfg), dp=dp, tp=tp,
                       devices=jax.devices()[:dp * tp], auto_start=False, name=f"jmesh-{dp}x{tp}")
    try:
        want_mesh = jeng.generate(prompts)
    finally:
        jeng.close()
    single = InferenceEngine(model, EngineConfig(**cfg), auto_start=False)
    try:
        want_single = single.generate(prompts)
    finally:
        single.close()
    assert got == want_mesh
    assert got == want_single
    assert got == jax_reference[0]
    # the first decode step's logits against the JAX model's dense forward
    # over the prompt and the first token
    assert len(first["rows"]) >= 2
    for row in first["rows"]:
        req = first["requests"][row]
        want = jax_reference[1](req.prompt + [req.stream.tokens_so_far()[0]])
        have = first["logits"][row].numpy()
        assert np.max(np.abs(have - want) / np.maximum(1.0, np.abs(want))) < 1e-4


MESH_PKGS = {"torch": lambda m, c, **kw: MeshEngine(m[2], EngineConfig(**c), **kw,
                                                    devices=[CPU] * (kw["dp"] * kw["tp"])),
             "jax": lambda m, c, **kw: JMeshEngine(m[0], m[1], JEngineConfig(**c), **kw,
                                                   devices=jax.devices()[:kw["dp"] * kw["tp"]])}


def _refusal(fn):
    try:
        fn().close()
    except ValueError as e:
        return str(e)
    return None


def test_mesh_engine_requires_paged_and_divisible(lm):
    """The JAX test's cases on both packages, with the same texts."""
    cases = [dict(kv_mode="slab"), dict(num_slots=3), dict(adapter_slots=2),
             dict(num_slots=4, num_pages=9), dict(num_slots=4, num_pages=2)]
    for c in cases:
        texts = {pkg: _refusal(lambda: make(lm, c, dp=2, tp=1, auto_start=False))
                 for pkg, make in MESH_PKGS.items()}
        assert texts["torch"] is not None and texts["torch"] == texts["jax"], (c, texts)


@pytest.mark.parametrize("pkg", sorted(MESH_PKGS))
def test_mesh_engine_per_replica_admission(lm, pkg):
    """A prompt that fits replica 1 is not blocked by a full replica 0, and
    all six requests complete through 4 slots, 2 a replica."""
    ecfg = dict(num_slots=4, slot_len=32, max_new_tokens=4, page_len=16, reorder_window=2,
                prefix_cache=False)
    eng = MESH_PKGS[pkg](lm, ecfg, dp=2, tp=1, auto_start=False, name=f"mesh-admission-{pkg}")
    try:
        streams = [eng.submit([i + 1] * 20, 4) for i in range(6)]
        _drain(eng)
        outs = [s.result(5.0) for s in streams]
        assert all(len(o) >= 1 for o in outs)
        assert eng.metrics.snapshot()["requests_completed"] == 6
    finally:
        eng.close()


def test_mesh_engine_leases_its_chips_and_wraps_them(lm, tair, monkeypatch):
    """With the runtime up the engine leases dp x tp chip slots and meshes
    them onto the devices there are (here one CPU device stands for the
    card), and gives the lease back on close."""
    monkeypatch.setattr(tmesh_engine, "platform_devices", lambda: [CPU])
    free = len(tair.free_chips)
    eng = MeshEngine(lm[2], EngineConfig(**ECFG), dp=2, tp=2, auto_start=False,
                     name="mesh-lease")
    try:
        assert eng.lease_id.startswith("chips:") and len(tair.free_chips) == free - 4
        assert eng.metrics.snapshot()["topology"]["lease"] == eng.lease_id
        p = _prompts(3, 2)
        assert eng.generate(p) == [_offline(lm[2], x, ECFG["max_new_tokens"]) for x in p]
    finally:
        eng.close()
    assert len(tair.free_chips) == free


def test_stream_migrates_out_of_a_mesh_engine(lm):
    """A decoding stream's pages leave a dp 2 x tp 2 engine as the flat
    payload and continue token for token on a single-card engine."""
    model = lm[2]
    prompt = _prompts(5, 1)[0]
    want = _offline(model, prompt, 8)
    src = MeshEngine(model, EngineConfig(**dict(ECFG, max_new_tokens=8)), dp=2, tp=2,
                     devices=[CPU] * 4, auto_start=False)
    dst = InferenceEngine(model, EngineConfig(**dict(ECFG, max_new_tokens=8)), auto_start=False)
    try:
        src.submit([1, 2, 3], 2)              # slot 0, replica 0
        stream = src.submit(prompt, 8)         # slot 1
        src.submit([4, 5, 6, 7], 2)            # slot 2, replica 1
        while len(stream.tokens_so_far()) < 3:
            src.step()
        payloads = [p for p in src.migrate_out() if p["prompt"] == prompt]
        moved = dst.submit_migrated(payloads[0])
        _drain(dst)
        assert moved.result(0) == want
    finally:
        src.close()
        dst.close()


def test_mesh_engine_replicates_what_tp_does_not_divide(lm):
    """tp 3 divides neither the tiny LM's 4 heads nor its 128 ff columns:
    both parts replicate (``lm_param_spec``'s divisibility drop) and run
    once a replica, and the tokens are the single card's."""
    model = lm[2]
    eng = MeshEngine(model, EngineConfig(**ECFG), dp=1, tp=3, devices=[CPU] * 3,
                     auto_start=False, name="mesh-tp3")
    try:
        assert (eng.sharded.n_attn, eng.sharded.n_mlp) == (1, 1)
        assert [len(rep) for rep in eng.cache.layout] == [1]
        p = _prompts(11, 4)
        assert eng.generate(p) == [_offline(model, x, ECFG["max_new_tokens"]) for x in p]
    finally:
        eng.close()


def test_mesh_engine_swaps_weights_into_its_shards(lm):
    """A weight swap reshards: new weights change the tokens as on a single
    card, and a rollback gives the old ones back."""
    model = tlm.CausalLM(tlm.LMConfig.from_dict(CFG.to_dict()), device="cpu")
    model.load_state_dict(lm[2].state_dict())
    prompts = _prompts(9, 3)
    eng = MeshEngine(model, EngineConfig(**ECFG), dp=1, tp=2, devices=[CPU] * 2,
                     auto_start=False, name="mesh-swap")
    other = {k: -v if k == "layers.1.mlp.down.weight" else v.clone()
             for k, v in lm[2].state_dict().items()}
    single = tlm.CausalLM(tlm.LMConfig.from_dict(CFG.to_dict()), device="cpu")
    single.load_state_dict(other)
    try:
        before = eng.generate(prompts)
        eng.swap_params(other, version=2)
        after = eng.generate(prompts)
        assert after != before
        assert after == [_offline(single, p, ECFG["max_new_tokens"]) for p in prompts]
        eng.rollback_params()
        assert eng.generate(prompts) == before
    finally:
        eng.close()


def test_topology_in_metrics_export(lm):
    from tpu_air_torch.engine.metrics import prometheus_lines

    eng = MeshEngine(lm[2], EngineConfig(num_slots=2, slot_len=32, page_len=8), dp=2, tp=1,
                     devices=[CPU] * 2, auto_start=False, name="topo-export")
    try:
        lines = prometheus_lines({"topo-export": eng.metrics.snapshot()})
        info = [ln for ln in lines if ln.startswith("tpu_air_engine_topology_info")]
        assert len(info) == 1
        assert 'mesh="2x1"' in info[0] and 'lease="local"' in info[0]
        assert 'role="decode"' in info[0]
        gauges = [ln for ln in lines if ln.startswith("tpu_air_engine_topology_decode_replicas")]
        assert gauges and gauges[0].endswith(" 2")
    finally:
        eng.close()


# -- submit_prefilled --------------------------------------------------------------------------


def _jax_prefill(jmodel, params, prompt, page_len=8, slot_len=32):
    """A JAX prefill as the JAX package's PrefillWorker runs it, and the
    payload its ``extract_kv_pages`` makes (numpy, no object store)."""
    pool = JPagedKVPool(4 * (slot_len // page_len) + 1, page_len, 1, slot_len // page_len)
    cache = jgen.init_paged_cache(jmodel, 1, pool.allocator.num_pages, page_len,
                                  slot_len // page_len)
    chunk_fn = jgen.make_lm_prefill_chunk_fn(jmodel, page_len, slot_len)
    plan = pool.admit(0, prompt, 1)
    n, tok = len(prompt), None
    while not plan.done:
        p0 = plan.next_start
        ids = np.zeros((1, page_len), np.int32)
        ids[0, :len(prompt[p0:p0 + page_len])] = prompt[p0:p0 + page_len]
        last = (n - 1 - p0) if plan.chunks_done == len(plan.chunk_starts) - 1 else page_len - 1
        row = pool.chunk_row(0, p0, plan.null_target)
        cache, tok = chunk_fn(params, cache, jnp.asarray(ids), jnp.int32(p0), jnp.int32(last),
                              jnp.asarray(row))
        plan.chunks_done += 1
    pool.register(0, prompt)
    payload = jax.tree_util.tree_map(np.asarray,
                                     jextract(cache, pool.prompt_page_ids(0, n)))
    return int(np.asarray(tok)), payload


def test_jax_prefilled_payload_lands_in_the_port(lm):
    jmodel, params, model = lm
    ecfg = dict(num_slots=2, slot_len=32, max_new_tokens=6, page_len=8)
    prompts = _prompts(7, 3)
    jeng = JInferenceEngine(jmodel, params, JEngineConfig(**ecfg), auto_start=False)
    try:
        want = jeng.generate(prompts)
    finally:
        jeng.close()
    eng = InferenceEngine(model, EngineConfig(**ecfg), auto_start=False, name="prefilled-jax")
    try:
        streams = []
        for p in prompts:
            first, payload = _jax_prefill(jmodel, params, p)
            streams.append(eng.submit_prefilled(p, first, payload, 6))
        _drain(eng)
        assert [s.result(0) for s in streams] == want
        assert eng._chunks_run == 0
    finally:
        eng.close()


@pytest.mark.parametrize("mesh", [None, (2, 2)])
def test_port_prefill_worker_payload(lm, ckpt, tair, mesh):
    """The port's own worker (in process) and a handoff into the engine,
    single-card and 2 x 2 mesh: the JAX engine's tokens."""
    jmodel, params, model = lm
    ecfg = dict(num_slots=2, slot_len=32, max_new_tokens=6, page_len=8)
    prompts = _prompts(8, 3)
    jeng = JInferenceEngine(jmodel, params, JEngineConfig(**ecfg), auto_start=False)
    try:
        want = jeng.generate(prompts)
    finally:
        jeng.close()
    worker = PrefillWorker(ckpt, page_len=8, slot_len=32, device="cpu", name="local-worker")
    eng = (InferenceEngine(model, EngineConfig(**ecfg), auto_start=False) if mesh is None else
           MeshEngine(model, EngineConfig(**ecfg), dp=mesh[0], tp=mesh[1],
                      devices=[CPU] * 4, auto_start=False))
    try:
        streams = []
        for p in prompts:
            h = worker.prefill(p)
            streams.append(eng.submit_prefilled(p, h["first_token"],
                                                tpu_air_torch.get(h["kv"]), 6))
        _drain(eng)
        assert [s.result(0) for s in streams] == want
        assert eng._chunks_run == 0
        st = worker.stats()
        assert st["prefills"] == 3 and st["device"] == "cpu" and st["pages_shipped"] > 0
    finally:
        eng.close()


def test_submit_prefilled_defers_on_pool_exhaustion(lm, ckpt, tair):
    """num_pages=5 leaves 4 after the null page: one worst-case admit (16
    tokens + 4 -> 3 pages) fits, so one handoff admits a round and the
    others wait in the queue, then complete token-identical."""
    model = lm[2]
    ecfg = EngineConfig(num_slots=2, slot_len=32, max_new_tokens=4, page_len=8, num_pages=5,
                        prefix_cache=False, reorder_window=0)
    engine = InferenceEngine(model, ecfg, auto_start=False, name="disagg-exhaustion")
    worker = PrefillWorker(ckpt, page_len=8, slot_len=32, device="cpu", name="exhaustion")
    try:
        prompts = [[i + 1] * 16 for i in range(3)]
        streams = []
        for p in prompts:
            h = worker.prefill(p)
            streams.append(engine.submit_prefilled(p, h["first_token"],
                                                   tpu_air_torch.get(h["kv"]), 4))
        engine.step()
        snap = engine.metrics.snapshot()
        assert snap["slot_occupancy"] == 1 and snap["queue_depth"] == 2
        _drain(engine)
        assert [s.result(5.0) for s in streams] == [_offline(model, p, 4) for p in prompts]
    finally:
        engine.close()


def test_submit_prefilled_rides_a_drain_and_refuses_slab(lm):
    jmodel, params, model = lm
    first, payload = _jax_prefill(jmodel, params, [5, 6, 7, 8, 9])
    eng = InferenceEngine(model, EngineConfig(num_slots=2, slot_len=32, page_len=8),
                          auto_start=False)
    slab = InferenceEngine(model, EngineConfig(num_slots=2, slot_len=32, kv_mode="slab"),
                           auto_start=False)
    try:
        eng.drain()
        s = eng.submit_prefilled([5, 6, 7, 8, 9], first, payload, 4)
        _drain(eng)
        assert s.result(0) == _offline(model, [5, 6, 7, 8, 9], 4)
        with pytest.raises(ValueError, match="requires a paged engine"):
            slab.submit_prefilled([5, 6, 7, 8, 9], first, payload, 4)
    finally:
        eng.close()
        slab.close()


# -- DisaggRouter ------------------------------------------------------------------------------

WAIT_S = 60.0


def _until(cond, what: str) -> None:
    """Wait for ``cond()`` on the condition itself, up to ``WAIT_S``."""
    deadline = time.monotonic() + WAIT_S
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.005)


def _replicas_up(router) -> None:
    """Every prefill replica's actor is placed and built: its ready object is
    in the store (a replica still starting would add it later)."""
    tpu_air_torch.get([w._ready_ref for w in router._workers], timeout=WAIT_S)


def _router(ckpt, name, **kw):
    return DisaggRouter(ckpt, EngineConfig(num_slots=4, slot_len=64, max_new_tokens=6,
                                           page_len=8),
                        prefill_replicas=2, prefill_timeout=WAIT_S, device="cpu",
                        name=name, **kw)


def test_disagg_end_to_end_trace_and_parity(lm, ckpt, tair, _clean):
    model = lm[2]
    prompts = [[7, 8, 9, 10, 11, 12, 13, 14], [7, 8, 9, 10, 11, 12, 13, 14, 3, 4],
               [101, 102, 103]]
    want = [_offline(model, p, 6) for p in prompts]
    tracing.enable()
    router = _router(ckpt, "disagg-e2e")
    try:
        got, trace_ids = [], []
        for p in prompts:
            with tracing.span("client.request") as root:
                trace_ids.append(root.trace_id)
                got.append(router.submit(p).result(WAIT_S))
        assert got == want
        needed = {"engine.queue_wait", "engine.prefill", "engine.kv_transfer",
                  "engine.request", "engine.decode"}
        deadline = time.monotonic() + 20.0
        while time.monotonic() < deadline:
            by_trace = {}
            for sp in tracing.recorder().recent(limit=0):
                by_trace.setdefault(sp.trace_id, []).append(sp)
            if all(needed <= {s.name for s in by_trace.get(t, [])} for t in trace_ids):
                break
            time.sleep(0.1)
        for tid in trace_ids:
            spans = by_trace.get(tid, [])
            assert needed <= {s.name for s in spans}, tid
            prefill_pids = {s.pid for s in spans if s.name == "engine.prefill"}
            assert prefill_pids and os.getpid() not in prefill_pids
            assert {s.pid for s in spans if s.name == "engine.decode"} == {os.getpid()}
        st = router.stats()
        assert (router.handoffs, router.fallbacks, router.reroutes) == (3, 0, 0)
        assert all(w.get("prefills", 0) >= 1 and w["device"] == "cpu" for w in st["workers"])
        assert st["engine"]["topology"]["prefill_replicas"] == 2
    finally:
        router.close()


def _store_level():
    """The runtime store's live objects and bytes: the arena's, and the
    files beside it (objects too big for the arena, or spilled)."""
    store = rt.get_runtime().store
    arena = store._arena.stats() if store._arena is not None else dict.fromkeys(
        ("live_objects", "sealed_bytes", "used", "free_bytes"), 0)
    files = [e for d in (store.root, store._spill_dir) if os.path.isdir(d)
             for e in os.scandir(d) if e.is_file() and not e.name.startswith(("__", "."))]
    return {"arena_objects": arena["live_objects"], "arena_sealed": arena["sealed_bytes"],
            # blocks off the free list: the live objects' and any still pinned
            "arena_held": arena["used"] - arena["free_bytes"],
            "files": len(files), "file_bytes": sum(e.stat().st_size for e in files)}


@pytest.mark.parametrize("deferred", [False, True])
def test_router_handoffs_leave_no_payload_in_the_store(lm, ckpt, tair, _clean, deferred):
    """Every handoff's payload (and the worker's reply) is deleted once the
    engine has copied its pages into the pool: after the router's handoffs
    the store is back at its level before them, tokens equal to in-process
    decoding.  With ``deferred`` the pool holds one 16-token prompt at a
    time and every handoff is submitted while the engine is held between
    two steps, so all but one wait in the admission queue holding their
    payloads, which must still be in the store, until they land."""
    model = lm[2]
    if deferred:
        ecfg = EngineConfig(num_slots=2, slot_len=32, max_new_tokens=4, page_len=8,
                            num_pages=5, prefix_cache=False, reorder_window=0)
        prompts, max_new = [[i + 1] * 16 for i in range(3)], 4
    else:
        ecfg = EngineConfig(num_slots=4, slot_len=64, max_new_tokens=6, page_len=8)
        prompts, max_new = _prompts(seed=5, n=5), 6
    want = [_offline(model, p, max_new) for p in prompts]
    router = DisaggRouter(ckpt, ecfg, prefill_replicas=2, prefill_timeout=WAIT_S,
                          device="cpu", name=f"disagg-leak-{int(deferred)}")
    try:
        _replicas_up(router)
        router.submit(prompts[0], max_new).result(WAIT_S)
        _until(lambda: router.handoffs == 1, "the first handoff did not land")
        before = _store_level()
        if deferred:
            with router.engine._between_steps():
                streams = [router.submit(p, max_new) for p in prompts]
                _until(lambda: router.handoffs >= len(prompts) + 1,
                       "the handoffs did not arrive")
                assert router.engine.scheduler.depth() == len(prompts)
                held = _store_level()
                assert held["arena_objects"] + held["files"] == \
                    before["arena_objects"] + before["files"] + len(prompts)
        else:
            streams = [router.submit(p, max_new) for p in prompts]
        assert [s.result(WAIT_S) for s in streams] == want
        # a stream can finish before its dispatcher thread counts the handoff
        _until(lambda: router.handoffs >= len(prompts) + 1, "the handoffs did not arrive")
        assert router.handoffs == len(prompts) + 1 and router.fallbacks == 0
        deadline = time.monotonic() + WAIT_S
        while _store_level() != before and time.monotonic() < deadline:
            time.sleep(0.05)
        assert _store_level() == before
    finally:
        router.close()


def test_prefill_worker_fault_reroutes_then_falls_back(lm, ckpt, tair, _clean):
    """Idle replicas take requests in turn (0, 1, 0, 1).  Replica 0 dies at
    its second prefill (the ``prefill.worker`` fault): that request
    re-routes to replica 1.  Replica 1 dies at its third: the next request
    finds no replica and the decode engine prefills it.  The first stream,
    admitted before either failure with a long budget, completes
    unchanged, and so does every other."""
    model = lm[2]
    tfaults.install(tfaults.FaultPlan(seed=0, specs=[
        tfaults.FaultSpec("prefill.worker", "kill", at=2, match="disagg-death-prefill-0"),
        tfaults.FaultSpec("prefill.worker", "kill", at=3, match="disagg-death-prefill-1"),
    ]))
    router = _router(ckpt, "disagg-death")
    try:
        _replicas_up(router)
        first_prompt = [41, 42, 43, 44, 45]
        first = router.submit(first_prompt, 50)
        # replica 0 has taken the first prompt before the next one picks
        _until(lambda: router.handoffs == 1, "the first handoff did not land")
        p = [[51, 52, 53, 54], [55, 56, 57], [61, 62, 63]]
        assert router.submit(p[0]).result(WAIT_S) == _offline(model, p[0], 6)
        _until(lambda: router.handoffs == 2, "the second handoff did not land")
        assert (router.handoffs, router.reroutes, router.fallbacks) == (2, 0, 0)
        assert router.submit(p[1]).result(WAIT_S) == _offline(model, p[1], 6)
        _until(lambda: router.handoffs == 3, "the third handoff did not land")
        assert router.live_prefill_replicas() == 1
        assert (router.handoffs, router.reroutes, router.fallbacks) == (3, 1, 0)
        assert router.submit(p[2]).result(WAIT_S) == _offline(model, p[2], 6)
        assert router.live_prefill_replicas() == 0
        assert (router.handoffs, router.reroutes, router.fallbacks) == (3, 2, 1)
        assert first.result(WAIT_S) == _offline(model, first_prompt, 50)
        st = router.stats()
        assert [w.get("dead") for w in st["workers"]] == [True, True]
    finally:
        router.close()


def test_router_refuses_while_draining(lm, ckpt, tair, _clean):
    from tpu_air_torch.engine import EngineDrainingError

    router = DisaggRouter(ckpt, EngineConfig(num_slots=2, slot_len=32, page_len=8),
                          prefill_replicas=1, device="cpu", name="disagg-drain")
    try:
        router.drain()
        assert router.draining
        with pytest.raises(EngineDrainingError):
            router.submit([1, 2, 3])
        assert router.drained()
        with pytest.raises(ValueError, match="prefill_replicas must be >= 1"):
            DisaggRouter(ckpt, prefill_replicas=0)
    finally:
        router.close()


# -- _EngineServer -----------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["mesh", "disagg"])
def test_engine_server_mesh_and_disagg(lm, ckpt, tair, kind):
    from tpu_air_torch.engine.metrics import prometheus_lines

    model = lm[2]
    extra = {"mesh": (2, 2)} if kind == "mesh" else {"disagg": {"prefill_replicas": 2}}
    server = _EngineServer(ckpt, EngineConfig(num_slots=4, slot_len=64, max_new_tokens=4,
                                              page_len=8),
                           device="cpu", engine_name=f"serve-{kind}", **extra)
    try:
        assert server.stats() == {}       # a scrape before the build stays lazy
        prompts = [[5, 6, 7, 8], [9, 10, 11, 12], [13, 14]]
        out = server({"prompts": prompts, "max_new_tokens": 4})
        assert [r["tokens"] for r in out["results"]] == [_offline(model, p, 4) for p in prompts]
        rid = server.submit([21, 22, 23], 4)
        deadline = time.monotonic() + WAIT_S
        while not (res := server.poll(rid))["done"] and time.monotonic() < deadline:
            time.sleep(0.01)
        assert server.poll(rid)["tokens"] == _offline(model, [21, 22, 23], 4)
        snap = server.stats()
        topo = snap["topology"]
        lines = prometheus_lines({f"serve-{kind}": snap})
        assert any(ln.startswith("tpu_air_engine_topology_info") for ln in lines)
        if kind == "mesh":
            assert topo["mesh"] == "2x2" and topo["decode_replicas"] == 2
            assert topo["lease"] == "local" and "disagg" not in snap
            assert any(ln.startswith("tpu_air_engine_topology_mesh_devices") for ln in lines)
        else:
            assert topo["disagg"] == "on" and topo["prefill_replicas"] == 2
            assert topo["live_prefill_replicas"] == 2
            assert snap["disagg"]["handoffs"] == 4 and snap["disagg"]["fallbacks"] == 0
            assert any(ln.startswith("tpu_air_engine_topology_prefill_replicas") for ln in lines)
    finally:
        server.close()
