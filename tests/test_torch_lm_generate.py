"""The port's LM decode path (``tpu_air_torch.models.lm``: the four decode
branches, ``generate``, the engines' entry points) and
``LMGenerativePredictor`` on the CPU against the JAX package's.

Weights: a Flax init of ``LMConfig.tiny()`` (2 layers, f32), carried into
the port with ``params_from_jax``; the token tests scale every parameter by
4, so that greedy decoding does not repeat one token (at the init's scale
it does).  Caches: seeded numpy
slabs and pools carried both ways with ``cache_from_jax`` /
``cache_to_jax``, so one step of each branch runs on both packages from one
state.  The JAX package's 1-token steps run ``flat_decode_attention`` (XLA,
as its own tests run it on the CPU); the port's run
``decode_attention_reference``, the decode kernel's plain version.
Tolerances, f32: logits to ``ATOL`` (1e-5: the two packages sum in another
order); K/V written by a step to ``ATOL`` and every other cache byte
exactly; tokens exactly.  The scaled model's K/V reach 8 in magnitude,
where f32 rounding alone is 1e-6: those are held to ``ATOL`` plus
``RTOL`` (1e-5) of their size.
"""

import importlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from tpu_air.models import lm as jlm  # noqa: E402
from tpu_air.ops.decode_attention import flat_decode_attention  # noqa: E402
from tpu_air.ops.decode_attention import gather_pages as jgather_pages  # noqa: E402
from tpu_air.predict.predictors import LMGenerativePredictor as JPredictor  # noqa: E402
from tpu_air.train.checkpoint import Checkpoint as JCheckpoint  # noqa: E402
from tpu_air_torch.models import lm as tlm  # noqa: E402
from tpu_air_torch.ops.decode_attention import (  # noqa: E402
    decode_attention,
    decode_attention_reference,
    gather_pages,
)
from tpu_air_torch.predict import LMGenerativePredictor  # noqa: E402
from tpu_air_torch.train import Checkpoint  # noqa: E402

# the module (tpu_air.models.lm's ``generate`` attribute is the function)
jgen = importlib.import_module("tpu_air.models.lm.generate")
ATOL = 1e-5
RTOL = 1e-5
CFG = jlm.LMConfig.tiny()
V, HD = CFG.vocab_size, CFG.n_heads * CFG.head_dim


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _init_params(scale):
    init = jlm.CausalLM(CFG).init(jax.random.PRNGKey(0), jnp.ones((1, 8), jnp.int32))["params"]
    return jax.tree_util.tree_map(lambda x: np.asarray(x) * np.float32(scale), init)


def _port(params):
    m = tlm.CausalLM(tlm.LMConfig.from_dict(CFG.to_dict()), device="cpu")
    m.load_state_dict(tlm.params_from_jax(params))
    return m


@pytest.fixture(scope="module")
def params():
    return _init_params(4)


@pytest.fixture(scope="module")
def model(params):
    return _port(params)


@pytest.fixture(scope="module")
def init_pair():
    """The init's own scale: the logits compared to ATOL."""
    p = _init_params(1)
    return p, _port(p)


def _ids(n, length, seed):
    return np.random.default_rng(seed).integers(1, V, (n, length)).astype(np.int32)


def _jmodel(max_seq_len=None):
    d = CFG.to_dict()
    if max_seq_len is not None:
        d["max_seq_len"] = max_seq_len
    return jlm.CausalLM(jlm.LMConfig.from_dict(d))


# -- one step of each decode branch from one cache -----------------------------------


def _layers(make):
    return {f"layer_{i}": {"attn": make(i)} for i in range(CFG.n_layers)}


def _random_kv(rng, shape):
    return {"cached_key": rng.standard_normal(shape).astype(np.float32),
            "cached_value": rng.standard_normal(shape).astype(np.float32)}


def _branch_case(name):
    """(cache, ids, positions, slab length for the JAX model): the state one
    call of branch ``name`` starts from, seeded numpy."""
    rng = np.random.default_rng(BRANCHES.index(name))
    if name == "a_prefill":          # offline prefill, scalar index 0
        cache = _layers(lambda i: {**_random_kv(rng, (2, 16, HD)),
                                   "cache_index": np.array(0, np.int32)})
        return cache, _ids(2, 8, 1), np.broadcast_to(np.arange(8), (2, 8)), 16
    if name == "a_step":             # offline 1-token step at index 8
        cache = _layers(lambda i: {**_random_kv(rng, (2, 16, HD)),
                                   "cache_index": np.array(8, np.int32)})
        return cache, _ids(2, 1, 2), np.full((2, 1), 8), 16
    if name == "b_per_row":          # slab engine: each row at its own index
        pos = np.array([5, 0, 11], np.int32)
        cache = _layers(lambda i: {**_random_kv(rng, (3, 16, HD)), "cache_index": pos})
        return cache, _ids(3, 1, 3), pos[:, None], 16
    table = np.array([[3, 7, 1, 0], [0, 0, 0, 0], [2, 5, 8, 6]], np.int32)
    if name == "c_paged":            # paged step; row 1 is free (null page, pos 0)
        pos = np.array([5, 0, 13], np.int32)
        cache = _layers(lambda i: {**_random_kv(rng, (9, 4, HD)), "cache_index": pos,
                                   "block_table": table})
        return cache, _ids(3, 1, 4), pos[:, None], None
    assert name == "d_chunk"         # paged chunk prefill of row 0 at p0 = 4
    cache = _layers(lambda i: {**_random_kv(rng, (9, 4, HD)),
                               "cache_index": np.full(3, 4, np.int32),
                               "block_table": np.broadcast_to(table[0], (3, 4)).copy()})
    return cache, _ids(1, 4, 5), (4 + np.arange(4))[None], None


BRANCHES = ("a_prefill", "a_step", "b_per_row", "c_paged", "d_chunk")


@pytest.mark.parametrize("name", BRANCHES)
def test_each_decode_branch_matches_jax_from_one_cache(init_pair, name):
    params, model = init_pair
    cache, ids, positions, slab_len = _branch_case(name)
    logits, out = _jmodel(slab_len).apply(
        {"params": params, "cache": jax.tree_util.tree_map(jnp.asarray, cache)}, jnp.asarray(ids), jnp.asarray(positions),
        decode=True, mutable=["cache"])
    want = jax.tree_util.tree_map(np.asarray, out["cache"])
    port = tlm.cache_from_jax(cache)
    with torch.no_grad():
        got = model(torch.from_numpy(ids).long(), torch.tensor(positions).long(),
                    decode=True, cache=port)
    np.testing.assert_allclose(got.numpy(), np.asarray(logits), atol=ATOL, rtol=0)
    back = tlm.cache_to_jax(port)
    for layer in want:
        w, g = want[layer]["attn"], back[layer]["attn"]
        before = cache[layer]["attn"]
        for leaf in ("cached_key", "cached_value"):
            written = w[leaf] != before[leaf]
            # the bytes the step wrote agree to ATOL; every other byte is
            # the one it started as, in both packages
            np.testing.assert_allclose(g[leaf][written], w[leaf][written], atol=ATOL, rtol=0)
            np.testing.assert_array_equal(g[leaf][~written], before[leaf][~written])
        if name == "d_chunk":        # the port's chunk call keeps one row (b = 1)
            assert int(g["cache_index"][0]) == int(w["cache_index"][0]) == 8
        else:
            np.testing.assert_array_equal(g["cache_index"], w["cache_index"])


def test_paged_chunk_prefill_keeps_the_jax_shape_error(model):
    cache = tlm.init_paged_cache(model, 2, 5, 4, 3)
    with pytest.raises(ValueError, match="paged chunk prefill wants b=1, l=page_len"):
        with torch.no_grad():
            model(torch.ones(1, 3, dtype=torch.long), torch.arange(3)[None], decode=True,
                  cache=cache)
    with pytest.raises(ValueError, match="per-row cache_index supports single-token"):
        with torch.no_grad():
            model(torch.ones(2, 2, dtype=torch.long), torch.zeros(2, 2, dtype=torch.long),
                  decode=True, cache=tlm.init_slot_cache(model, 2, 8))


# -- the ops the decode path adds ---------------------------------------------------


def test_gather_pages_matches_jax_exactly():
    rng = np.random.default_rng(11)
    pool = rng.standard_normal((7, 4, HD)).astype(np.float32)
    table = rng.integers(0, 7, (3, 5)).astype(np.int32)
    want = np.asarray(jgather_pages(jnp.asarray(pool), jnp.asarray(table)))
    got = gather_pages(torch.from_numpy(pool), torch.from_numpy(table).long())
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.shape == (3, 20, HD)


def test_decode_reference_with_a_per_row_mask_matches_flat_decode_attention():
    """The kernel's plain version with a per-row validity mask against the
    XLA path the JAX LM runs (f32); their floors differ (-1e20 against
    -1e9), which changes nothing where a row has a valid key."""
    rng = np.random.default_rng(12)
    b, L, h, d = 4, 24, CFG.n_heads, CFG.head_dim
    q = rng.standard_normal((b, 1, h, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, L, h * d)).astype(np.float32) for _ in range(2))
    pos = np.array([0, 5, 23, 11])
    mask = (np.arange(L)[None] <= pos[:, None])
    want = np.asarray(flat_decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                            None, jnp.asarray(mask), None, None, h,
                                            jnp.float32))
    got = decode_attention_reference(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v),
                                     kv_mask=torch.from_numpy(mask.astype(np.float32)))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


# -- generate --------------------------------------------------------------------------


def _eos_of(model, ids, new):
    """A token the greedy chain of row 0 emits mid-stream: a real EOS."""
    return int(tlm.generate(model, ids, max_new_tokens=new)[0, 2])


@pytest.mark.parametrize("case", ["greedy", "eos_early_stop", "eos_full_budget", "batch_of_3"])
def test_generate_matches_jax(params, model, case):
    n = 3 if case == "batch_of_3" else 4
    ids = _ids(n, 7, 21)
    new = 10
    eos = _eos_of(model, ids, new) if case.startswith("eos") else None
    early = case != "eos_full_budget"
    want = np.asarray(jgen.generate(jlm.CausalLM(CFG), params, ids, max_new_tokens=new,
                                    eos_token_id=eos, early_stop=early))
    before = decode_attention.launches
    got = tlm.generate(model, ids, max_new_tokens=new, eos_token_id=eos,
                       early_stop=early).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.shape == (n, new) and decode_attention.launches == before  # CPU: no kernel
    if eos is not None:
        assert (got == CFG.pad_token_id).any(), "EOS never retired a row"


def test_generate_live_mask_filler_rows_are_born_finished(params, model):
    ids = _ids(4, 6, 22)
    eos = _eos_of(model, ids, 8)
    live = np.array([True, True, False, False])
    want = np.asarray(jgen.make_lm_generate_fn(jlm.CausalLM(CFG), 8, eos_token_id=eos)(
        params, jnp.asarray(ids), jax.random.PRNGKey(0), jnp.asarray(live)))
    got = tlm.make_lm_generate_fn(model, 8, eos_token_id=eos)(ids, live_mask=live).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[2:] == CFG.pad_token_id).all()


def test_sampling_draws_from_the_generator(model):
    """Sampled tokens come from the torch.Generator (not JAX's stream): the
    same seed gives the same tokens, and they are in the vocabulary."""
    ids = _ids(2, 5, 23)

    def draw(seed):
        g = torch.Generator().manual_seed(seed)
        return tlm.generate(model, ids, max_new_tokens=6, do_sample=True, temperature=0.8,
                            top_k=20, generator=g)

    a, b = draw(1), draw(1)
    assert torch.equal(a, b) and int(a.min()) >= 0 and int(a.max()) < V


def test_generate_too_long_raises(model):
    with pytest.raises(ValueError, match="exceeds max_seq_len"):
        tlm.generate(model, _ids(1, CFG.max_seq_len - 2, 24), max_new_tokens=4)


# -- the engines' entry points -----------------------------------------------------------


def test_slot_prefill_and_decode_step_match_jax(params, model):
    """Bucketed prefill (head at ``last_index``), insertion into slab rows and
    three per-row decode steps, against the JAX entry points."""
    S, L, bucket = 3, 32, 8
    lens = [5, 8, 3]
    rng = np.random.default_rng(25)
    ids = np.zeros((S, bucket), np.int32)
    for r, n in enumerate(lens):
        ids[r, :n] = rng.integers(1, V, n)
    last = np.array(lens) - 1
    jmodel = jlm.CausalLM(CFG)
    jtok, jseg = jgen.make_lm_prefill_fn(jmodel, bucket)(params, jnp.asarray(ids),
                                                        jnp.asarray(last, jnp.int32))
    tok, seg = tlm.make_lm_prefill_fn(model, bucket)(torch.from_numpy(ids).long(),
                                                     torch.from_numpy(last))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    for i in range(CFG.n_layers):
        np.testing.assert_allclose(seg[i].cached_key.numpy(),
                                   np.asarray(jseg[f"layer_{i}"]["attn"]["cached_key"]),
                                   atol=ATOL, rtol=RTOL)

    from tpu_air.engine.slots import make_insert_fn as jmake_insert
    from tpu_air_torch.engine.slots import make_insert_fn

    jcache, cache = jgen.init_slot_cache(jmodel, S, L), tlm.init_slot_cache(model, S, L)
    for r in range(S):
        row = lambda t: t[r:r + 1] if t.ndim else t  # noqa: E731
        jcache = jmake_insert()(jcache, jax.tree_util.tree_map(row, jseg), r)
        cache = make_insert_fn()(cache, [tlm.AttnCache(row(c.cached_key), row(c.cached_value), 0)
                                         for c in seg], r)
    jstep, step = jgen.make_lm_decode_step_fn(jmodel, L), tlm.make_lm_decode_step_fn(model, L)
    pos = np.array(lens)
    jt, t = jnp.asarray(jtok), tok
    for _ in range(3):
        jcache, jt = jstep(params, jcache, jt, jnp.asarray(pos, jnp.int32))
        cache, t = step(cache, t, torch.from_numpy(pos))
        np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
        pos = pos + 1


def test_paged_chunk_prefill_decode_step_and_page_copy_match_jax(params, model):
    """One slot's prompt through page-sized chunks, a copy-on-write page
    copy, then paged decode steps beside a free row, against the JAX entry
    points: tokens equal, pools to ATOL and RTOL."""
    S, P, C, npg = 2, 12, 4, 4
    L = C * npg
    prompt = _ids(1, 10, 26)[0]
    table = np.zeros((S, npg), np.int32)
    table[0] = [3, 5, 7, 2]
    jmodel = jlm.CausalLM(CFG)
    jcache = jgen.init_paged_cache(jmodel, S, P, C, npg)
    cache = tlm.init_paged_cache(model, S, P, C, npg)
    jchunk = jgen.make_lm_prefill_chunk_fn(jmodel, C, L)
    chunk = tlm.make_lm_prefill_chunk_fn(model, C, L)
    for p0 in range(0, len(prompt), C):
        ids = np.zeros((1, C), np.int32)
        part = prompt[p0:p0 + C]
        ids[0, :len(part)] = part
        last = len(prompt) - 1 - p0 if p0 + C >= len(prompt) else C - 1
        jcache, jtok = jchunk(params, jcache, jnp.asarray(ids), jnp.int32(p0), jnp.int32(last),
                              jnp.asarray(table[0]))
        cache, tok = chunk(cache, torch.from_numpy(ids).long(), p0, last,
                           torch.from_numpy(table[0]).long())
    assert int(tok) == int(jtok)
    # copy-on-write: the tail page 7 onto page 9, and the table follows it
    jcache = jgen.make_page_copy_fn()(jcache, jnp.int32(9), jnp.int32(7))
    cache = tlm.page_copy(cache, 9, 7)
    table[0, 2] = 9
    jstep = jgen.make_lm_paged_decode_step_fn(jmodel, L)
    step = tlm.make_lm_paged_decode_step_fn(model, L)
    pos = np.array([len(prompt), 0])
    jt = jnp.asarray([int(jtok), 0], jnp.int32)
    t = torch.tensor([int(tok), 0])
    for _ in range(4):
        jcache, jt = jstep(params, jcache, jt, jnp.asarray(pos, jnp.int32), jnp.asarray(table))
        cache, t = step(cache, t, torch.from_numpy(pos), torch.from_numpy(table).long())
        assert int(t[0]) == int(jt[0])
        pos[0] += 1
    back = tlm.cache_to_jax(cache)
    for i in range(CFG.n_layers):
        for leaf in ("cached_key", "cached_value"):
            w = np.asarray(jcache[f"layer_{i}"]["attn"][leaf])
            g = back[f"layer_{i}"]["attn"][leaf]
            # page 0 takes the free row's ride-along writes: don't-care
            np.testing.assert_allclose(g[1:], w[1:], atol=ATOL, rtol=RTOL)
    # the LoRA banks (adapters=True): one more step, row 0 under the
    # tenant of bank row 1, row 1 under the zero row; then the prompt's
    # chunks again under row 1.  Tokens equal the JAX package's, and the
    # zero row's equal the base step's from the same state
    rng = np.random.default_rng(3)
    bank_a = np.zeros((3, CFG.d_model, 2), np.float32)
    bank_b = np.zeros((3, 2, V), np.float32)
    bank_a[1:] = rng.standard_normal((2, CFG.d_model, 2)) * 4
    bank_b[1:] = rng.standard_normal((2, 2, V)) * 4
    ids_ = np.array([1, 0])
    jastep = jgen.make_lm_paged_decode_step_fn(jmodel, L, adapters=True)
    astep = tlm.make_lm_paged_decode_step_fn(model, L, adapters=True)
    tb = torch.from_numpy(table).long()
    _, base = step(cache, t, torch.from_numpy(pos), tb)
    jcache, ja = jastep(params, jcache, jt, jnp.asarray(pos, jnp.int32), jnp.asarray(table),
                        jnp.asarray(bank_a), jnp.asarray(bank_b), jnp.asarray(ids_, jnp.int32))
    cache, a = astep(cache, t, torch.from_numpy(pos), tb, torch.from_numpy(bank_a),
                     torch.from_numpy(bank_b), torch.from_numpy(ids_))
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    assert int(a[1]) == int(base[1])
    jachunk = jgen.make_lm_prefill_chunk_fn(jmodel, C, L, adapters=True)
    achunk = tlm.make_lm_prefill_chunk_fn(model, C, L, adapters=True)
    for p0 in range(0, len(prompt), C):
        ids = np.zeros((1, C), np.int32)
        part = prompt[p0:p0 + C]
        ids[0, :len(part)] = part
        last = len(prompt) - 1 - p0 if p0 + C >= len(prompt) else C - 1
        jcache, jtok = jachunk(params, jcache, jnp.asarray(ids), jnp.int32(p0), jnp.int32(last),
                               jnp.asarray(table[0]), jnp.asarray(bank_a), jnp.asarray(bank_b),
                               jnp.int32(1))
        cache, tok = achunk(cache, torch.from_numpy(ids).long(), p0, last,
                            torch.from_numpy(table[0]).long(), torch.from_numpy(bank_a),
                            torch.from_numpy(bank_b), 1)
    assert int(tok) == int(jtok)


# -- LMGenerativePredictor ----------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_ckpt(params, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("lm_ckpt"))
    JCheckpoint.from_model(model_config=CFG, params=params, path=path)
    return path


def test_lm_predictor_matches_jax_on_a_jax_checkpoint(jax_ckpt):
    ids = _ids(3, 6, 27)
    batch = {"input_ids": ids}
    want = JPredictor.from_checkpoint(JCheckpoint.from_directory(jax_ckpt)).predict(
        batch, max_new_tokens=7)
    pred = LMGenerativePredictor.from_checkpoint(Checkpoint.from_directory(jax_ckpt),
                                                 device="cpu")
    got = pred.predict(batch, max_new_tokens=7)
    assert list(got["generated_output"]) == list(want["generated_output"])
    assert pred.model.device.type == "cpu" and pred.tokenizer is None


def test_lm_predictor_refuses_ragged_and_padded_prompts(jax_ckpt):
    pred = LMGenerativePredictor.from_checkpoint(Checkpoint.from_directory(jax_ckpt),
                                                 device="cpu")
    with pytest.raises(ValueError, match="EQUAL-LENGTH"):
        pred.predict({"input_ids": np.array([np.arange(1, 5), np.arange(1, 4)],
                                            dtype=object)})
    padded = _ids(2, 5, 28)
    padded[1, -1] = CFG.pad_token_id
    with pytest.raises(ValueError, match="un-padded"):
        pred.predict({"input_ids": padded})


def test_lm_predictor_folds_the_call_count_into_its_seed(jax_ckpt):
    """Each call draws from a generator seeded from (seed, calls): two
    predictors give the same sampled tokens call for call."""
    ids = {"input_ids": _ids(2, 5, 29)}

    def two_calls():
        p = LMGenerativePredictor.from_checkpoint(Checkpoint.from_directory(jax_ckpt),
                                                  device="cpu")
        return [list(p.predict(ids, max_new_tokens=5, do_sample=True)["generated_output"])
                for _ in range(2)]

    assert two_calls() == two_calls()


def test_entry_points_need_a_card_unless_told_cpu(jax_ckpt):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is the card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LMGenerativePredictor.from_checkpoint(Checkpoint.from_directory(jax_ckpt))
