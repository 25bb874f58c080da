"""The port's causal-LM serving path on the CPU: the paged KV pool's host
pieces, ``InferenceEngine`` in both KV modes and ``EngineDeployment`` over
an LM checkpoint, against the JAX package and against the port's offline
``generate``.

* The host cases of tests/test_kvpool.py (allocator, prefix cache, pool,
  reorder window) on the port's copies, and one differential run: the same
  operation sequence on both packages' pools gives the same page ids,
  refcounts and plans.
* Engine streams: token-identical to the port's offline greedy
  ``generate`` in both ``kv_mode``s for burst, staggered and trickle
  arrivals, and to the JAX ``InferenceEngine``'s on the same weights for
  one schedule; EOS retirement, slot reuse deeper than the pool, prefix
  hits with copy-on-write, deferral on pool exhaustion, chunked-prefill
  TTFT; validation, backpressure, metrics, spans, the background thread
  and the refusals.
* ``EngineDeployment`` over HTTP on ``PORT`` (8355, no other test file
  uses it): blocking POSTs, submit/poll streams and the 503 on overload,
  with the port's runtime started by a module fixture.

Weights: a Flax init of ``LMConfig.tiny()`` scaled by 4 (greedy decoding
then does not repeat one token), carried into the port; f32, the decode
kernel's plain version.  Tokens are compared exactly.
"""

import json
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
from tpu_air.engine.kvpool import PagedKVPool as JPagedKVPool  # noqa: E402
from tpu_air.models import lm as jlm  # noqa: E402
from tpu_air_torch import serve  # noqa: E402
from tpu_air_torch.engine import (  # noqa: E402
    BlockAllocator,
    EngineConfig,
    EngineDrainingError,
    EngineOverloadedError,
    InferenceEngine,
    KVPoolOOMError,
    PagedKVPool,
    PrefixCache,
    Request,
    ResponseStream,
    Scheduler,
)
from tpu_air_torch.engine.dist import extract_kv_pages  # noqa: E402
from tpu_air_torch.engine.kvpool.allocator import NULL_PAGE  # noqa: E402
from tpu_air_torch.models import lm as tlm  # noqa: E402
from tpu_air_torch.observability import tracing  # noqa: E402
from tpu_air_torch.ops.decode_attention import decode_attention  # noqa: E402
from tpu_air_torch.serve import EngineDeployment  # noqa: E402
from tpu_air_torch.train import Checkpoint  # noqa: E402

PORT = 8355
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


def _offline(model, prompt, max_new, eos=None):
    """The port's offline greedy generate, cut after the first EOS
    (inclusive: the engine emits the EOS id, then retires)."""
    out = tlm.generate(model, [prompt], max_new_tokens=max_new, eos_token_id=eos)[0].tolist()
    if eos is not None and eos in out:
        out = out[: out.index(eos) + 1]
    return out


def _drain(engine, limit=500):
    steps = 0
    while not engine.idle():
        engine.step()
        steps += 1
        assert steps < limit, "engine failed to drain"
    return steps


def _run_schedule(engine, arrivals):
    """Drive a manual-step engine through (engine_step, prompt) arrivals;
    returns the streams in submission order."""
    order = sorted(range(len(arrivals)), key=lambda i: arrivals[i][0])
    streams = {}
    t, i = 0, 0
    while i < len(order) or not engine.idle():
        while i < len(order) and arrivals[order[i]][0] <= t:
            streams[order[i]] = engine.submit(arrivals[order[i]][1])
            i += 1
        engine.step()
        t += 1
    return [streams[j] for j in range(len(arrivals))]


# -- the kvpool host pieces (tests/test_kvpool.py's cases on the port) ------------------


def test_allocator_lowest_first_refcounts_and_oom():
    a = BlockAllocator(num_pages=5, page_len=8)
    assert a.free_count() == 4 and a.used_count() == 0
    assert a.refcount(NULL_PAGE) == 1  # pinned forever
    pages = [a.alloc() for _ in range(4)]
    assert pages == [1, 2, 3, 4]  # deterministic lowest-first
    with pytest.raises(KVPoolOOMError):
        a.alloc()
    # refcounting: a shared page survives one holder's release
    a.incref(2)
    assert a.refcount(2) == 2
    assert a.decref(2) is False and a.free_count() == 0
    assert a.decref(2) is True and a.free_count() == 1
    # freed page is handed out again, lowest-first
    a.decref(1)
    assert a.alloc() == 1
    assert a.alloc() == 2


def test_allocator_misuse_is_loud():
    a = BlockAllocator(num_pages=4, page_len=8)
    with pytest.raises(ValueError):
        a.incref(NULL_PAGE)  # null page is not a refcountable target
    with pytest.raises(ValueError):
        a.incref(99)
    with pytest.raises(ValueError):
        a.incref(1)  # still free
    with pytest.raises(ValueError):
        a.decref(1)
    with pytest.raises(ValueError):
        BlockAllocator(num_pages=1, page_len=8)
    with pytest.raises(ValueError):
        BlockAllocator(num_pages=4, page_len=0)


# ---------------------------------------------------------------------------
# PrefixCache
# ---------------------------------------------------------------------------


def _cached(allocator, cache, tokens):
    """Simulate a retired request: insert ``tokens``'s full chunks on fresh
    pages, then drop the slot's own refs so only the cache holds them."""
    full = len(tokens) // cache.page_len
    pages = [allocator.alloc() for _ in range(full)]
    cache.insert(tokens, pages)
    for p in pages:
        allocator.decref(p)
    return pages


def test_prefix_match_full_partial_and_miss():
    a = BlockAllocator(num_pages=16, page_len=4)
    c = PrefixCache(a, page_len=4)
    donor = list(range(100, 112))  # 3 full chunks
    pages = _cached(a, c, donor)
    assert c.resident_pages() == 3

    m = c.match(donor)
    assert m.pages == pages and m.matched_tokens == 12 and m.tail_page is None
    # longer prompt sharing the prefix: full chunks only
    m = c.match(donor + [7, 7, 7, 7, 7])
    assert m.pages == pages and m.matched_tokens == 12
    # partial tail: prompt ends inside a cached chunk -> that page shared
    m = c.match(donor[:10])
    assert m.pages == pages[:2]
    assert m.tail_page == pages[2] and m.matched_tokens == 10
    # diverging inside a chunk breaks the walk at the chunk boundary
    m = c.match(donor[:4] + [999] * 8)
    assert m.pages == pages[:1] and m.matched_tokens == 4
    m = c.match([999] * 8)
    assert m.pages == [] and m.matched_tokens == 0
    assert c.hits == 4 and c.misses == 1 and c.partial_hits == 1
    # capacity probes (touch=False) must not move stats
    c.match(donor, touch=False)
    assert c.hits == 4 and c.misses == 1


def test_prefix_insert_dedup_keeps_first_writer():
    a = BlockAllocator(num_pages=16, page_len=4)
    c = PrefixCache(a, page_len=4)
    donor = list(range(50, 58))
    pages = _cached(a, c, donor)
    # a second slot computed the same chunks on its own pages: existing
    # edges win, nothing new inserted, no extra refs taken
    dup = [a.alloc(), a.alloc()]
    assert c.insert(donor, dup) == 0
    assert c.match(donor).pages == pages
    assert a.refcount(dup[0]) == 1  # still only the slot's own ref


def test_prefix_evict_lru_leaves_cascade():
    a = BlockAllocator(num_pages=16, page_len=4)
    c = PrefixCache(a, page_len=4)
    old = _cached(a, c, list(range(0, 8)))      # 2 chunks
    new = _cached(a, c, list(range(20, 28)))    # 2 chunks
    c.match(list(range(20, 28)))                # bump 'new' to MRU
    assert c.evictable_count() == 2             # only the two leaves
    free0 = a.free_count()
    assert c.evict(1) == 1                      # LRU leaf: old's chunk 2
    assert a.free_count() == free0 + 1
    assert c.match(list(range(0, 8))).pages == old[:1]
    # cascading: evicting the leaf exposed old's chunk 1
    assert c.evict(3) == 3                      # old chunk1 + both of new
    assert c.resident_pages() == 0 and c.evictions == 4
    # a page a live slot still references is pinned: nothing to evict
    pinned = _cached(a, c, list(range(40, 44)))
    a.incref(pinned[0])  # a slot's block-table entry
    assert c.evictable_count() == 0 and c.evict(1) == 0


# ---------------------------------------------------------------------------
# PagedKVPool: admission plans, CoW, release
# ---------------------------------------------------------------------------


def test_pool_admit_miss_then_full_chunk_share():
    pool = PagedKVPool(num_pages=12, page_len=4, num_slots=2,
                       pages_per_slot=8)
    prompt = list(range(200, 210))  # 10 tokens = 2 full chunks + 2
    plan = pool.admit(0, prompt, budget=3)  # last write at pos 10+3-2 -> 3 pages
    assert plan.chunk_starts == [0, 4, 8] and not plan.null_target
    assert plan.prefix_tokens == 0 and not plan.shared_tail
    row0 = list(pool.block_table[0][:3])
    assert row0 == [1, 2, 3]
    pool.register(0, prompt)   # 2 full chunks become resident
    pool.release(0)
    assert (pool.block_table[0] == NULL_PAGE).all()
    assert pool.allocator.refcount(1) == 1  # cache residency survives
    assert pool.allocator.refcount(3) == 0  # decode page freed

    # same prompt again: leading chunks shared, only the tail prefilled
    plan = pool.admit(1, prompt, budget=3)
    assert plan.prefix_tokens == 8 and plan.chunk_starts == [8]
    assert list(pool.block_table[1][:2]) == row0[:2]
    assert pool.allocator.refcount(1) == 2  # cache + slot 1


def test_pool_partial_tail_cow_and_null_target():
    pool = PagedKVPool(num_pages=16, page_len=4, num_slots=2,
                       pages_per_slot=8)
    donor = list(range(300, 312))  # 3 full chunks
    pool.admit(0, donor, budget=2)
    pool.register(0, donor)
    pool.release(0)

    # prompt ends INSIDE donor's 3rd chunk: tail page shared, fully
    # covered -> single null-target chunk just for the first token's logits
    prompt = donor[:10]
    plan = pool.admit(1, prompt, budget=4)
    assert plan.shared_tail and plan.null_target
    assert plan.prefix_tokens == 10 and plan.chunk_starts == [8]
    tail_idx = len(prompt) // 4
    shared_tail = int(pool.block_table[1][tail_idx])
    assert pool.allocator.refcount(shared_tail) >= 2
    # the chunk's prefill view is redirected to the null page; the
    # authoritative table is untouched
    view = pool.chunk_row(1, plan.chunk_starts[0], plan.null_target)
    assert view[tail_idx] == NULL_PAGE
    assert int(pool.block_table[1][tail_idx]) == shared_tail

    # first decode append diverges from the cached content: CoW repoints
    # the tail at the reserved private page, donor's page keeps its holders
    cow = pool.resolve_cow(1)
    assert cow is not None
    dst, src = cow
    assert src == shared_tail and int(pool.block_table[1][tail_idx]) == dst
    assert pool.allocator.refcount(src) == 1  # cache residency only
    assert pool.cow_copies == 1
    assert pool.resolve_cow(1) is None  # idempotent
    pool.release(1)
    assert pool.allocator.refcount(dst) == 0


def test_pool_page_math_and_capacity():
    pool = PagedKVPool(num_pages=8, page_len=4, num_slots=1,
                       pages_per_slot=7, prefix_cache=False)
    # budget=1: the single emitted token is computed, never written
    assert pool.worst_case_pages(4, 1) == 1
    assert pool.worst_case_pages(5, 1) == 2
    # budget>1: budget-1 decode scatters land after the prompt
    assert pool.worst_case_pages(3, 2) == 1
    assert pool.worst_case_pages(4, 2) == 2
    assert pool.worst_case_pages(8, 5) == 3
    assert pool.capacity() == 7  # no prefix cache: free pages only
    pool.admit(0, list(range(10)), budget=3)
    assert pool.capacity() == 4


# ---------------------------------------------------------------------------
# scheduler: bounded reorder window
# ---------------------------------------------------------------------------


def _req(rid, n):
    return Request(request_id=rid, prompt=[1] * n, max_new_tokens=4,
                   stream=ResponseStream(rid))


def test_scheduler_reorder_window_relieves_blocked_head():
    s = Scheduler(EngineConfig(max_queue=16, reorder_window=2))
    for rid, n in enumerate([8, 2, 3, 9, 2]):  # big head, smalls behind
        s.submit(_req(rid, n))
    fits = lambda r: len(r.prompt) < 5
    out = s.pop_admissible(3, can_admit=fits)
    # head (r0) blocked each round; window=2 look-ahead admits in queue
    # order: r1, r2, then r4 (r3 also blocked)
    assert [r.request_id for r in out] == [1, 2, 4]
    assert s.reordered_admits == 3
    assert s.depth() == 2  # r0, r3 still queued, order preserved
    out = s.pop_admissible(2, can_admit=lambda r: True)
    assert [r.request_id for r in out] == [0, 3]


def test_scheduler_reorder_window_zero_is_strict_fifo():
    s = Scheduler(EngineConfig(max_queue=16, reorder_window=0))
    for rid, n in enumerate([8, 2, 2]):
        s.submit(_req(rid, n))
    assert s.pop_admissible(3, can_admit=lambda r: len(r.prompt) < 5) == []
    assert s.reordered_admits == 0 and s.depth() == 3




def test_pool_operation_sequence_matches_jax():
    """One seeded sequence of admissions, publications, copy-on-writes and
    releases on both packages' pools: every plan, block table, refcount and
    stat is the same."""
    rng = np.random.default_rng(5)
    pools = [PagedKVPool(40, 4, 4, 8), JPagedKVPool(40, 4, 4, 8)]
    shared = list(rng.integers(1, V, 12))
    live = {}
    for step in range(60):
        free = [s for s in range(4) if s not in live]
        if free and (not live or rng.random() < 0.6):
            slot = free[0]
            if rng.random() < 0.3:        # ends inside a published chunk: CoW
                prompt = shared[:int(rng.integers(5, 12))]
            else:
                n = int(rng.integers(1, 20))
                prompt = (shared[:int(rng.integers(0, 13))] + list(rng.integers(1, V, n)))[:24]
            budget = int(rng.integers(1, 8))
            if pools[0].capacity() < pools[0].worst_case_pages(len(prompt), budget):
                continue
            plans = [p.admit(slot, prompt, budget) for p in pools]
            assert vars(plans[0]) == vars(plans[1])
            for p in pools:
                p.register(slot, prompt)
            cows = [p.resolve_cow(slot) for p in pools]
            assert cows[0] == cows[1]
            live[slot] = prompt
        else:
            slot = sorted(live)[int(rng.integers(0, len(live)))]
            for p in pools:
                p.release(slot)
            del live[slot]
        np.testing.assert_array_equal(pools[0].block_table, pools[1].block_table)
        assert pools[0].allocator._ref == pools[1].allocator._ref
        assert pools[0].stats() == pools[1].stats()
    assert pools[0].stats()["prefix_hits"] > 0 and pools[0].cow_copies > 0


# -- the engine against offline generate ---------------------------------------------------


ARRIVALS = {"burst": lambda i: 0, "staggered": lambda i: i, "trickle": lambda i: 4 * i}


@pytest.mark.parametrize("kv_mode", ["paged", "slab"])
@pytest.mark.parametrize("name", sorted(ARRIVALS))
def test_token_parity_with_offline_generate(lm, kv_mode, name):
    """Token-identical to offline greedy generate under deterministic
    scheduling, for three arrival shapes, in both KV layouts."""
    _, _, model = lm
    prompts = _prompts(7, 7, hi=30)
    engine = InferenceEngine(model, EngineConfig(num_slots=3, slot_len=64, max_new_tokens=10,
                                                 kv_mode=kv_mode, page_len=8),
                             auto_start=False, name=f"parity-{kv_mode}-{name}")
    before = decode_attention.launches
    streams = _run_schedule(engine, [(ARRIVALS[name](i), p) for i, p in enumerate(prompts)])
    for p, s in zip(prompts, streams):
        assert s.result(5.0) == _offline(model, p, 10)
    assert decode_attention.launches == before      # CPU tensors: the plain version
    engine.close()


def test_engine_matches_the_jax_engine(lm):
    """The port's paged engine and the JAX package's, same weights, same
    staggered schedule with a shared prefix: the same streams."""
    jmodel, params, model = lm
    prompts = _prompts(8, 6, hi=20)
    prompts[3] = prompts[0][:9] + prompts[3]         # a prefix hit
    cfg = dict(num_slots=2, slot_len=64, max_new_tokens=8, page_len=8)
    jengine = JInferenceEngine(jmodel, params, JEngineConfig(**cfg), auto_start=False,
                               name="jax-twin")
    engine = InferenceEngine(model, EngineConfig(**cfg), auto_start=False, name="port-twin")
    arrivals = [(i, p) for i, p in enumerate(prompts)]
    want = [s.result(5.0) for s in _run_schedule(jengine, arrivals)]
    got = [s.result(5.0) for s in _run_schedule(engine, arrivals)]
    assert got == want
    assert engine.pool.stats() == jengine.pool.stats()
    jengine.close()
    engine.close()


@pytest.mark.parametrize("kv_mode", ["paged", "slab"])
def test_token_parity_with_eos_retirement(lm, kv_mode):
    """Rows retire the step they emit EOS (id included), as offline
    generate cut after the first EOS."""
    _, _, model = lm
    prompts = _prompts(11, 6)
    eos = _offline(model, prompts[0], 12)[2]
    engine = InferenceEngine(model, EngineConfig(num_slots=2, slot_len=64, max_new_tokens=12,
                                                 eos_token_id=eos, kv_mode=kv_mode,
                                                 page_len=8), auto_start=False)
    streams = _run_schedule(engine, [(i, p) for i, p in enumerate(prompts)])
    early = 0
    for p, s in zip(prompts, streams):
        want = _offline(model, p, 12, eos)
        assert s.result(5.0) == want
        early += len(want) < 12
    assert early > 0, "EOS never triggered"
    engine.close()


def test_slot_reuse_burst_deeper_than_pool(lm):
    """7 requests through a 2-slot pool: every slot is reused and the
    engine drains completely."""
    _, _, model = lm
    prompts = _prompts(3, 7)
    engine = InferenceEngine(model, EngineConfig(num_slots=2, slot_len=64, max_new_tokens=6),
                             auto_start=False)
    streams = [engine.submit(p) for p in prompts]
    _drain(engine)
    assert engine.slots.free_count() == 2
    for p, s in zip(prompts, streams):
        assert s.result(5.0) == _offline(model, p, 6)
    assert engine.metrics.snapshot()["requests_completed"] == 7
    engine.close()


def test_paged_engine_prefix_hits_and_cow(lm):
    """A shared system prompt: later prompts skip the covered chunks, a
    mid-chunk cut makes one copy-on-write, every stream stays equal to
    offline generate."""
    _, _, model = lm
    rng = np.random.RandomState(31)
    sys_prompt = list(map(int, rng.randint(1, V, size=16)))
    a = sys_prompt + list(map(int, rng.randint(1, V, size=8)))
    b = sys_prompt + list(map(int, rng.randint(1, V, size=5)))
    tail = a[:20]
    engine = InferenceEngine(model, EngineConfig(num_slots=2, slot_len=64, max_new_tokens=6,
                                                 page_len=8), auto_start=False)
    results = []
    for p in (a, b, tail):
        s = engine.submit(p)
        _drain(engine)
        results.append(s.result(5.0))
    stats = engine.pool.stats()
    engine.close()
    for p, got in zip((a, b, tail), results):
        assert got == _offline(model, p, 6)
    assert stats["prefix_hits"] == 2 and stats["prefix_partial_hits"] == 1
    assert stats["cow_copies"] == 1 and stats["prefix_tokens_reused"] == 16 + 20


def test_chunked_prefill_keeps_short_ttft_flat(lm):
    """A short prompt beside a 40-token one reaches its first token in as
    many engine steps as on an idle engine; the long prompt's chunks run
    one a step behind it."""
    _, _, model = lm

    def steps_to_first(engine, stream):
        steps = 0
        while not stream.tokens_so_far():
            assert engine.step(), "engine idle before first token"
            steps += 1
        return steps

    def fresh():
        return InferenceEngine(model, EngineConfig(num_slots=2, slot_len=64, max_new_tokens=6,
                                                   page_len=8), auto_start=False)

    rng = np.random.RandomState(41)
    long_p = list(map(int, rng.randint(1, V, size=40)))
    short_p = list(map(int, rng.randint(1, V, size=5)))
    engine = fresh()
    baseline = steps_to_first(engine, engine.submit(short_p))
    _drain(engine)
    engine.close()
    engine = fresh()
    s_long, s_short = engine.submit(long_p), engine.submit(short_p)
    loaded = steps_to_first(engine, s_short)
    assert loaded == baseline and not s_long.tokens_so_far()
    assert loaded + steps_to_first(engine, s_long) >= 5
    assert len(s_short.tokens_so_far()) > 1
    _drain(engine)
    assert s_short.result(5.0) == _offline(model, short_p, 6)
    assert s_long.result(5.0) == _offline(model, long_p, 6)
    assert engine.metrics.snapshot()["prefill_chunks"] == 6
    engine.close()


def test_paged_engine_defers_on_pool_exhaustion(lm):
    """A request whose worst case exceeds the free pages waits, a small one
    behind it jumps the line, and the big one admits once pages free up."""
    _, _, model = lm
    rng = np.random.RandomState(51)
    big_a = list(map(int, rng.randint(1, V, size=20)))
    big_b = list(map(int, rng.randint(1, V, size=21)))
    small = list(map(int, rng.randint(1, V, size=4)))
    engine = InferenceEngine(model, EngineConfig(num_slots=2, slot_len=32, max_new_tokens=6,
                                                 page_len=8, num_pages=6, reorder_window=2),
                             auto_start=False)
    s_a, s_b = engine.submit(big_a), engine.submit(big_b)
    s_small = engine.submit(small, max_new_tokens=4)
    engine.step()
    assert engine.scheduler.depth() == 1 and engine.scheduler.reordered_admits == 1
    _drain(engine)
    assert s_a.result(5.0) == _offline(model, big_a, 6)
    assert s_b.result(5.0) == _offline(model, big_b, 6)
    assert s_small.result(5.0) == _offline(model, small, 4)
    engine.close()


# -- validation, metrics, spans, the thread, refusals ---------------------------------------


def test_submit_validation_and_backpressure(lm):
    _, _, model = lm
    engine = InferenceEngine(model, EngineConfig(num_slots=1, slot_len=32, max_new_tokens=8,
                                                 max_queue=2), auto_start=False)
    with pytest.raises(ValueError):
        engine.submit([])
    with pytest.raises(ValueError):
        engine.submit(list(range(1, 30)), max_new_tokens=8)     # 29 + 8 > 32
    with pytest.raises(ValueError, match="unknown priority"):
        engine.submit([1, 2], priority="urgent")
    engine.submit([1, 2, 3])
    engine.submit([4, 5, 6])
    with pytest.raises(EngineOverloadedError):
        engine.submit([7, 8, 9])
    assert engine.metrics.snapshot()["requests_rejected"] == 1
    _drain(engine)
    engine.drain()
    with pytest.raises(EngineOverloadedError, match="draining"):
        engine.submit([1, 2])
    assert engine.drained()
    with pytest.raises(ValueError, match="slot_len"):
        InferenceEngine(model, EngineConfig(slot_len=4096), auto_start=False)
    with pytest.raises(ValueError, match="kv_mode"):
        InferenceEngine(model, EngineConfig(kv_mode="ring"), auto_start=False)
    engine.close()


def test_metrics_gauges_and_prometheus_text(lm):
    _, _, model = lm
    from tpu_air_torch.engine.metrics import prometheus_lines

    engine = InferenceEngine(model, EngineConfig(num_slots=2, slot_len=64, max_new_tokens=4,
                                                 page_len=8), auto_start=False,
                             name="lm-gauges")
    engine.generate(_prompts(61, 3))
    snap = engine.metrics.snapshot()
    assert snap["requests_submitted"] == snap["requests_completed"] == 3
    assert snap["tokens_emitted"] == 12 and snap["ttft_s"]["count"] == 3
    assert snap["slot_occupancy"] == 0 and snap["queue_depth"] == 0
    assert snap["kvpool"]["pages_total"] == 2 * 8
    assert snap["kvpool"]["pages_used"] == snap["kvpool"]["prefix_resident_pages"]
    assert snap["prefill_chunks"] >= 3
    text = "\n".join(prometheus_lines({snap["name"]: snap}))
    assert 'tpu_air_engine_tokens_emitted{engine="lm-gauges"} 12' in text
    assert 'tpu_air_engine_kvpool_pages_free{engine="lm-gauges"}' in text
    engine.close()


def test_engine_emits_a_connected_trace_and_costs_nothing_untraced(lm):
    _, _, model = lm
    tracing.disable()
    before = len(tracing.recorder())
    engine = InferenceEngine(model, EngineConfig(num_slots=2, slot_len=64, max_new_tokens=3),
                             auto_start=False)
    engine.generate(_prompts(14, 2))
    engine.close()
    assert len(tracing.recorder()) == before         # tracing off: no spans
    tracing.enable()
    try:
        engine = InferenceEngine(model, EngineConfig(num_slots=2, slot_len=64,
                                                     max_new_tokens=4), auto_start=False)
        with tracing.span("client.generate") as root:
            engine.generate(_prompts(13, 2))
        engine.close()
        spans = tracing.recorder().for_trace(root.trace_id)
    finally:
        tracing.disable()
        tracing.recorder().clear()
    by_name = {}
    for s in spans:
        by_name.setdefault(s.name, []).append(s)
    for name in ("engine.request", "engine.queue_wait", "engine.prefill", "engine.decode"):
        assert len(by_name.get(name, [])) == 2, name
    req_ids = {s.span_id for s in by_name["engine.request"]}
    assert all(s.parent_id == root.span_id for s in by_name["engine.request"])
    for name in ("engine.queue_wait", "engine.prefill", "engine.decode"):
        assert all(s.parent_id in req_ids for s in by_name[name])
    assert all(s.attrs["chunks"] >= 1 and "prefix_hit" in s.attrs
               for s in by_name["engine.prefill"])
    assert all(s.attrs["tokens"] == 4 for s in by_name["engine.decode"])


def test_background_thread_streams_tokens(lm):
    _, _, model = lm
    with InferenceEngine(model, EngineConfig(num_slots=2, slot_len=64,
                                             max_new_tokens=8)) as engine:
        prompt = _prompts(5, 1)[0]
        assert list(engine.submit(prompt)) == _offline(model, prompt, 8)
        outs = engine.generate(_prompts(6, 3), max_new_tokens=5)
        assert [len(o) for o in outs] == [5, 5, 5]
    assert engine._thread is None


def test_close_fails_what_is_still_queued(lm):
    _, _, model = lm
    engine = InferenceEngine(model, EngineConfig(num_slots=1, slot_len=64, max_new_tokens=4),
                             auto_start=False)
    streams = [engine.submit(p) for p in _prompts(15, 3)]
    engine.step()
    engine.close()
    for s in streams:
        with pytest.raises(Exception, match="shut down"):
            s.result(1.0)


def _prefilled(model):
    """The disaggregated handoff: one engine prefills a prompt, its pages
    and first token land on another through ``submit_prefilled``, which
    runs no chunk and decodes the tokens the prompt gives anywhere."""
    want = _run(_manual(model), [1, 2, 3])
    src, dst = _manual(model), _manual(model)
    stream = src.submit([1, 2, 3], 3)
    src.step()                                   # the prompt's one chunk, then a decode
    slot = src.slots.active_slots()[0]
    pages = extract_kv_pages(src.cache, src.pool.prompt_page_ids(slot.index, 3))
    moved = dst.submit_prefilled([1, 2, 3], stream.tokens_so_far()[0], pages, 3)
    while not dst.idle():
        dst.step()
    return moved.result(0) == want and dst._chunks_run == 0


# the branch the engine refused until the disaggregated handoff was ported:
# each case now runs
REFUSED = {
    "submit_prefilled": _prefilled,
}


def _manual(model, **kw):
    return InferenceEngine(model, EngineConfig(num_slots=1, slot_len=32, **kw),
                           auto_start=False)


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_unported_engine_branches_refuse_naming_their_item(lm, case):
    assert REFUSED[case](lm[2])


def _run(engine, prompt, **kw):
    stream = engine.submit(prompt, 3, **kw)
    while not engine.idle():
        engine.step()
    return stream.result(0)


def _adapter_engine(model):
    e = _manual(model, adapter_slots=2, adapter_rank=2)
    e.load_adapter("t", np.ones((CFG.d_model, 1), np.float32), np.ones((1, V), np.float32))
    return e


def _swapped(model):
    e = _manual(model)
    e.swap_params({k: v.clone() for k, v in model.state_dict().items()}, version=7)
    return e


def _preempted(model):
    e = _manual(model)
    e.preempt()
    with pytest.raises(EngineDrainingError):
        e.submit([1, 2])
    return e.preempting


def _migrated(model):
    src, dst = _manual(model), _manual(model)
    want = _run(_manual(model), [1, 2, 3])
    stream = src.submit([1, 2, 3], 3)
    src.step()
    moved = dst.submit_migrated(src.migrate_out()[0])
    while not dst.idle():
        dst.step()
    return moved.result(0) == want and not stream.done


NOW_WORK = {
    # what the engine refused before the live-weight plane was ported
    "adapter_slots": lambda m: tuple(_adapter_engine(m)._adapter_b.shape) == (3, 2, V),
    "adapter_id": lambda m: len(_run(_adapter_engine(m), [1, 2], adapter_id="t")) == 3,
    "load_adapter": lambda m: _adapter_engine(m).adapters() == {"t": 1},
    "unload_adapter": lambda m: _adapter_engine(m).unload_adapter("t") is True,
    "swap_params": lambda m: _swapped(m).weights_version() == 7,
    "rollback_params": lambda m: _swapped(m).rollback_params() >= 0.0,
    "preempt": _preempted,
    "migrate_out": lambda m: _manual(m).migrate_out() == [],
    "submit_migrated": _migrated,
}


@pytest.mark.parametrize("case", sorted(NOW_WORK))
def test_engine_branches_once_refused_now_work(lm, case):
    """Each branch the engine refused until the live-weight plane, adapters
    and migration were ported now runs on the LM engine."""
    assert NOW_WORK[case](lm[2])


# -- EngineDeployment over an LM checkpoint ----------------------------------------------------


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
    _, _, model = lm
    return Checkpoint.from_model(model_config=model.config, params=model.state_dict(),
                                 path=str(tmp_path_factory.mktemp("lm_serve")))


def _post(path, payload, headers=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{PORT}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", **(headers or {})}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.loads(resp.read()), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


SERVE_CFG = dict(num_slots=2, slot_len=64, max_new_tokens=6, page_len=8)


def test_engine_deployment_serves_the_lm_blocking_and_streams(lm, lm_ckpt, served):
    _, _, model = lm
    prompts = _prompts(71, 5)
    want = [_offline(model, p, 6) for p in prompts]
    h = serve.run(EngineDeployment.options(name="lm-engine", route_prefix="/lm")
                  .bind(lm_ckpt, EngineConfig(**SERVE_CFG), device="cpu"), port=PORT)
    assert tpu_air_torch.get(h.method("stats")()) == {}   # built at the first request
    status, out, _ = _post("/lm", {"prompts": prompts})
    assert status == 200, out
    assert [r["tokens"] for r in out["results"]] == want
    streams = []
    for p in prompts:
        status, sub, headers = _post("/lm", {"action": "submit", "prompt": p,
                                             "max_new_tokens": 6, "tenant": "t1"})
        assert status == 200, sub
        streams.append((sub["request_id"], headers["x-tpu-air-replica"]))
    got = []
    for rid, tag in streams:
        toks, deadline = [], time.time() + 60
        while time.time() < deadline:
            status, res, _ = _post("/lm", {"action": "poll", "request_id": rid,
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
    assert snap["kvpool"]["pages_total"] == 2 * 8      # paged, slab-equivalent pool
    assert snap["kernel_launches"] == {"flash_attention": 0, "decode_attention": 0}


def test_engine_deployment_default_config_and_overload_503(lm_ckpt, served):
    serve.run(EngineDeployment.options(name="lm-full", route_prefix="/lmfull")
              .bind(lm_ckpt, EngineConfig(max_queue=0, **SERVE_CFG), device="cpu"), port=PORT)
    status, out, _ = _post("/lmfull", {"prompts": [[5, 6, 7]]})
    assert status == 503 and "EngineOverloadedError" in out["error"]
    serve.shutdown()
    serve.run(EngineDeployment.options(name="lm-default", route_prefix="/lmdefault")
              .bind(lm_ckpt, device="cpu"), port=PORT)      # no config: EngineConfig()
    status, out, _ = _post("/lmdefault", {"prompt": [5, 6, 7], "max_new_tokens": 3})
    assert status == 200 and len(out["results"][0]["tokens"]) == 3
