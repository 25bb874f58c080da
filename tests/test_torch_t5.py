"""The port's T5 on the CPU against the JAX package's, on the same weights.

Weights come from a JAX init of ``T5Config.tiny()`` carried across with
``params_from_jax``, or from the vendored ``tests/assets/flan_t5_tiny``
safetensors (JAX side through ``convert_t5_state_dict``, port side through
its own reader).  Inputs come from numpy seeds.  Everything is float32:
float outputs agree to 1e-4 (summation order over a few layers), greedy
tokens exactly.  The JAX package runs its CPU paths (einsum attention at
-1e9 masks); the port runs its kernels' plain versions (-1e30 / -1e20
floors), which agree on every row with at least one valid key.
"""

import dataclasses
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from tpu_air.models.t5 import T5Config as JConfig  # noqa: E402
from tpu_air.models.t5 import T5ForConditionalGeneration as JT5  # noqa: E402
from tpu_air.models.t5 import convert_t5_state_dict as jconvert  # noqa: E402
from tpu_air.models.t5 import generate as jgenerate  # noqa: E402
from tpu_air.models.t5.modeling import relative_position_bucket as j_bucket  # noqa: E402
from tpu_air_torch.models.t5.config import T5Config  # noqa: E402
from tpu_air_torch.models.t5.convert import params_from_jax  # noqa: E402
from tpu_air_torch.models.t5.generate import generate  # noqa: E402
from tpu_air_torch.models.t5.hf_import import load_t5  # noqa: E402
from tpu_air_torch.models.t5.modeling import (  # noqa: E402
    T5ForConditionalGeneration,
    cross_entropy_loss,
    relative_position_bucket,
    shift_right,
)

ASSET = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets",
                     "flan_t5_tiny")
ATOL = 1e-4


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


def _batch(seed, n=3, L=12, vocab=384):
    rng = np.random.default_rng(seed)
    ids = rng.integers(2, vocab, (n, L)).astype(np.int32)
    lens = rng.integers(3, L + 1, n)
    lens[0] = L
    mask = (np.arange(L)[None] < lens[:, None]).astype(np.int32)
    return ids * mask, mask


def test_params_from_jax_covers_every_weight(pair):
    jmodel, params, model = pair
    sd = params_from_jax(jax.device_get(params), model.config)
    assert set(sd) == set(model.state_dict())
    n_jax = sum(np.asarray(x).size for x in jax.tree_util.tree_leaves(params))
    assert sum(t.numel() for t in sd.values()) == n_jax


def test_encoder_and_logits_match_jax(pair):
    jmodel, params, model = pair
    ids, mask = _batch(0)
    dec = np.random.default_rng(1).integers(2, 384, (3, 7)).astype(np.int32)
    want_enc = jmodel.apply({"params": params}, ids, mask, method=jmodel.encode)
    want = jmodel.apply({"params": params}, ids, mask, dec)
    with torch.no_grad():
        got_enc = model.encode(torch.from_numpy(ids).long(), torch.from_numpy(mask))
        got = model(torch.from_numpy(ids).long(), torch.from_numpy(mask),
                    torch.from_numpy(dec).long())
    np.testing.assert_allclose(got_enc.numpy(), np.asarray(want_enc), atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize("bidirectional", [True, False])
@pytest.mark.parametrize("num_buckets", [8, 32])
def test_relative_position_bucket_matches_jax(bidirectional, num_buckets):
    rel = np.arange(-700, 701, dtype=np.int32)
    want = j_bucket(jnp.asarray(rel), bidirectional, num_buckets, 128)
    got = relative_position_bucket(torch.from_numpy(rel).long(), bidirectional,
                                   num_buckets, 128)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("int8", [False, True])
def test_greedy_generate_token_identical_to_jax(pair, int8):
    """Full-width and int8 caches; a non-power-of-two batch (bucketed to 8)
    with an all-pad row that is born finished."""
    jmodel, params, model = pair
    ids, mask = _batch(2, n=5)
    ids[3], mask[3] = 0, 0
    if int8:
        jmodel = JT5(dataclasses.replace(jmodel.config, decode_cache_int8=True))
        m8 = T5ForConditionalGeneration(
            dataclasses.replace(model.config, decode_cache_int8=True), device="cpu")
        m8.load_state_dict(model.state_dict())
        model = m8
    want = np.asarray(jgenerate(jmodel, params, ids, mask, max_new_tokens=8))
    got = generate(model, ids, mask, max_new_tokens=8).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[3] == 0).all()


def test_int8_cache_is_int8_and_close_to_full_width(pair):
    from tpu_air_torch.models.t5.generate import init_cache

    _, _, model = pair
    m8 = T5ForConditionalGeneration(
        dataclasses.replace(model.config, decode_cache_int8=True), device="cpu")
    m8.load_state_dict(model.state_dict())
    ids, mask = _batch(3)
    tids, tmask = torch.from_numpy(ids).long(), torch.from_numpy(mask)
    with torch.no_grad():
        enc = model.encode(tids, tmask)
        ca = init_cache(model, 3, 8, enc, tmask)
        cb = init_cache(m8, 3, 8, enc, tmask)
        assert cb.cross_attn[0].k.dtype == torch.int8
        assert cb.self_attn[0].k.dtype == torch.int8
        assert cb.cross_attn[0].k_scale.shape == (3, 1, 64)
        assert cb.self_attn[0].k_scale.shape == (3, 8, 4)
        tok = torch.zeros(3, 1, dtype=torch.long)
        for _ in range(3):
            la = model.decode(tok, cache=ca)
            lb = m8.decode(tok, cache=cb)
            tok = la[:, -1:].argmax(-1)
    assert ca.pos == cb.pos == 3
    rel = (la - lb).abs().max() / la.abs().max()
    assert rel < 0.05, rel


def test_sampling_is_reproducible_from_a_generator(pair):
    _, _, model = pair
    ids, mask = _batch(4)

    def run(seed):
        g = torch.Generator().manual_seed(seed)
        return generate(model, ids, mask, max_new_tokens=6, do_sample=True,
                        temperature=0.8, top_k=10, generator=g)

    a, b = run(7), run(7)
    assert a.shape == (3, 6)
    torch.testing.assert_close(a, b)


def test_generate_early_stop_matches_full_budget(pair, monkeypatch):
    _, _, model = pair
    ids, mask = _batch(5)
    full = generate(model, ids, mask, max_new_tokens=10, early_stop=False)
    early = generate(model, ids, mask, max_new_tokens=10)
    torch.testing.assert_close(full, early)
    import tpu_air_torch.models.t5.generate as G

    calls = []

    def eos(logits, *a):
        calls.append(1)
        return torch.full((logits.shape[0],), model.config.eos_token_id)

    monkeypatch.setattr(G, "sample_token", eos)
    out = generate(model, ids, mask, max_new_tokens=10)
    assert len(calls) == 1                      # everyone finished on step one
    assert (out[:, 0] == 1).all() and (out[:, 1:] == 0).all()


def test_loss_helpers_match_jax():
    from tpu_air.models.t5 import cross_entropy_loss as jce
    from tpu_air.models.t5 import shift_right as jshift

    labels = np.array([[5, 6, 7, -100], [8, 9, 0, 0]], np.int32)
    got = shift_right(torch.from_numpy(labels).long(), 0, 0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jshift(jnp.asarray(labels), 0, 0)))
    logits = np.random.default_rng(6).standard_normal((2, 4, 11)).astype(np.float32)
    loss, n = cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(labels).long(), 0)
    jl, jn = jce(jnp.asarray(logits), jnp.asarray(labels), 0)
    assert int(n) == int(jn) == 5
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-6)


@pytest.fixture(scope="module")
def asset_pair():
    from safetensors.numpy import load_file

    from tpu_air.models.t5 import config_from_hf as jconfig_from_hf

    import json

    with open(os.path.join(ASSET, "config.json")) as f:
        hf = json.load(f)

    class _Cfg:
        def __init__(self, d):
            self.__dict__.update(d)

    jcfg = jconfig_from_hf(_Cfg(hf))
    sd = load_file(os.path.join(ASSET, "model.safetensors"))
    params = jax.tree_util.tree_map(jnp.asarray, jconvert(sd, jcfg))
    return JT5(jcfg), params, load_t5(ASSET, device="cpu")


def test_hf_asset_import_matches_jax(asset_pair):
    jmodel, params, model = asset_pair
    assert model.config.relative_attention_num_buckets == 8
    assert model.config.to_dict() == T5Config.from_dict(jmodel.config.to_dict()).to_dict()
    ids, mask = _batch(7, vocab=model.config.vocab_size)
    dec = np.random.default_rng(8).integers(2, 1000, (3, 5)).astype(np.int32)
    want = jmodel.apply({"params": params}, ids, mask, dec)
    with torch.no_grad():
        got = model(torch.from_numpy(ids).long(), torch.from_numpy(mask),
                    torch.from_numpy(dec).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=ATOL)


def test_predictor_output_matches_jax(asset_pair):
    """``T5GenerativePredictor.predict`` gives the JAX predictor's
    ``generated_output`` text, both with the asset's spiece.model tokenizer."""
    import pandas as pd

    from tpu_air.models.sentencepiece_unigram import T5SentencePieceTokenizer as JTok
    from tpu_air.predict.predictors import T5GenerativePredictor as JPred
    from tpu_air_torch.models.sentencepiece_unigram import T5SentencePieceTokenizer
    from tpu_air_torch.predict.predictors import T5GenerativePredictor

    jmodel, params, _ = asset_pair
    pred = T5GenerativePredictor.from_pretrained(
        ASSET, dtype="float32", device="cpu",
        tokenizer=T5SentencePieceTokenizer.from_pretrained(ASSET))
    jtok = JTok.from_pretrained(ASSET)
    texts = ["the framework trains the model", "summarize: the device mesh",
             "translate the data"]
    enc = jtok(texts, max_length=16, padding="max_length", truncation=True,
               return_tensors="np")
    df = pd.DataFrame({"input_ids": list(enc["input_ids"]),
                       "attention_mask": list(enc["attention_mask"])})
    want = JPred(jmodel, params, jtok).predict(df, max_new_tokens=6)
    got = pred.predict(df, max_new_tokens=6)
    assert list(got.columns) == ["generated_output"]
    assert list(got["generated_output"]) == list(want["generated_output"])
    assert all(isinstance(s, str) for s in got["generated_output"])


# -- the places where a port is likely to drift from the JAX package ---------


def test_gelu_is_jax_tanh_approximation():
    """jax.nn.gelu defaults to the tanh form; torch's default is exact erf."""
    from tpu_air_torch.models.t5.modeling import FeedForward

    x = np.linspace(-6, 6, 2001, dtype=np.float32)
    ff = FeedForward(T5Config.tiny())
    got = ff.act(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax.nn.gelu(jnp.asarray(x))), atol=2e-6)
    exact = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(got - exact).max() > 1e-4


def test_bf16_rmsnorm_and_position_bias_round_like_jax():
    """RMSNorm computes in f32 and casts after the weight; the position bias
    is cast to the model type where the table is read (so the kernels see
    a bf16-rounded bias widened to f32).  Both must round where JAX does."""
    from tpu_air.models.t5.modeling import RelativePositionBias as JBias
    from tpu_air.models.t5.modeling import RMSNorm as JNorm
    from tpu_air_torch.models.t5.modeling import RelativePositionBias, RMSNorm

    rng = np.random.default_rng(11)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32) * 3
    w = rng.standard_normal(64).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)                # bf16 activations
    want = JNorm(1e-6, jnp.bfloat16).apply({"params": {"weight": w}}, xb)
    norm = RMSNorm(64, 1e-6, torch.bfloat16)
    norm.weight.data = torch.from_numpy(w)
    with torch.no_grad():
        got = norm(torch.from_numpy(np.array(xb.astype(jnp.float32))).bfloat16())
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))

    jcfg = dataclasses.replace(JConfig.tiny(), dtype="bfloat16")
    table = rng.standard_normal((32, 4)).astype(np.float32)
    pos = jnp.arange(40)
    for bidirectional in (True, False):
        want = JBias(jcfg, bidirectional).apply({"params": {"embedding": table}}, pos, pos)
        rb = RelativePositionBias(T5Config.from_dict(jcfg.to_dict()), bidirectional)
        rb.embedding.data = torch.from_numpy(table)
        tpos = torch.arange(40)
        with torch.no_grad():
            got = rb(tpos, tpos)
        assert got.dtype == torch.bfloat16 and got.shape == (1, 4, 40, 40)
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want.astype(jnp.float32)))


def test_int8_cache_contents_match_jax(pair):
    """int8 quantization: pad positions zeroed before the per-channel amax,
    scale max(amax, 1e-8)/127, round half to even.  The port's cross cache
    and its per-position self slabs after three steps hold JAX's values."""
    from tpu_air.models.t5.generate import init_cache as jinit_cache
    from tpu_air_torch.models.t5.generate import init_cache

    jmodel, params, model = pair
    jm8 = JT5(dataclasses.replace(jmodel.config, decode_cache_int8=True))
    m8 = T5ForConditionalGeneration(
        dataclasses.replace(model.config, decode_cache_int8=True), device="cpu")
    m8.load_state_dict(model.state_dict())
    ids, mask = _batch(12)
    enc = jmodel.apply({"params": params}, ids, mask, method=jmodel.encode)
    jcache = jinit_cache(jm8, params, 3, 8, enc, jnp.asarray(mask))
    tok = jnp.zeros((3, 1), jnp.int32)
    for _ in range(3):
        _, v = jm8.apply({"params": params, "cache": jcache}, tok, enc, jnp.asarray(mask),
                         decode=True, mutable=["cache"], method=jm8.decode)
        jcache = v["cache"]
    with torch.no_grad():
        cache = init_cache(m8, 3, 8, torch.from_numpy(np.array(enc)), torch.from_numpy(mask))
        for _ in range(3):
            m8.decode(torch.zeros(3, 1, dtype=torch.long), cache=cache)
    for i in range(model.config.num_decoder_layers):
        jl = jcache["decoder"][f"layer_{i}"]
        for part, lc in (("cross_attn", cache.cross_attn[i]), ("self_attn", cache.self_attn[i])):
            jc = jl[part]
            np.testing.assert_allclose(lc.k_scale.numpy(), np.asarray(jc["cached_key_scale"]),
                                       rtol=1e-5, atol=0)
            np.testing.assert_allclose(lc.v_scale.numpy(), np.asarray(jc["cached_value_scale"]),
                                       rtol=1e-5, atol=0)
            for got, want in ((lc.k, jc["cached_key"]), (lc.v, jc["cached_value"])):
                diff = np.abs(got.numpy().astype(np.int32) - np.asarray(want).astype(np.int32))
                # f32 projections summed in another order may land on the
                # other side of a .5 rounding edge: one step, rarely
                assert diff.max() <= 1 and (diff == 0).mean() > 0.995, (part, diff.max())


@pytest.fixture(scope="module")
def f16_pair(pair):
    """The same weights, both models computing in float16 (the reference's
    W3 load type), f32 parameters cast per call."""
    jmodel, params, model = pair
    jm = JT5(dataclasses.replace(jmodel.config, dtype="float16"))
    m = T5ForConditionalGeneration(dataclasses.replace(model.config, dtype="float16"),
                                   device="cpu")
    m.load_state_dict(model.state_dict())
    return jm, params, m


def test_f16_logits_and_greedy_tokens_match_jax(f16_pair):
    """float16 T5 tiny: logits within 3e-2 of the JAX package's (f16
    activations through 2+2 layers, rounded at different points: a few f16
    ulps at the logits' |x| <= 8), greedy tokens identical, on a batch with
    an all-pad row.  On that row the two differ, and it is padding: the JAX
    package's dense -1e9 mask becomes -inf in f16 and its f32 softmax of an
    all -inf row is NaN, where the port's kernels keep their f32 floors and
    give finite values; generation never reads the row (born finished)."""
    jmodel, params, model = f16_pair
    ids, mask = _batch(2, n=5)
    ids[3], mask[3] = 0, 0
    dec = np.random.default_rng(1).integers(2, 384, (5, 7)).astype(np.int32)
    want = np.asarray(jmodel.apply({"params": params}, ids, mask, dec)).astype(np.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(ids).long(), torch.from_numpy(mask),
                    torch.from_numpy(dec).long())
    assert got.dtype == torch.float16
    got = got.float().numpy()
    assert np.isfinite(got).all()
    live = mask.sum(1) > 0
    assert np.isnan(want[~live]).all() and np.isfinite(want[live]).all()
    np.testing.assert_allclose(got[live], want[live], atol=3e-2, rtol=1e-2)
    want_toks = np.asarray(jgenerate(jmodel, params, ids, mask, max_new_tokens=8))
    got_toks = generate(model, ids, mask, max_new_tokens=8).numpy()
    np.testing.assert_array_equal(got_toks, want_toks)
    assert (got_toks[3] == 0).all()


def test_f16_rmsnorm_and_position_bias_round_like_jax():
    """In f16 as in bf16: RMSNorm computes in f32 and casts after the
    weight, the position bias is cast to f16 where the table is read."""
    from tpu_air.models.t5.modeling import RelativePositionBias as JBias
    from tpu_air.models.t5.modeling import RMSNorm as JNorm
    from tpu_air_torch.models.t5.modeling import RelativePositionBias, RMSNorm

    rng = np.random.default_rng(12)
    x = (rng.standard_normal((3, 5, 64)) * 3).astype(np.float16)
    w = rng.standard_normal(64).astype(np.float32)
    want = JNorm(1e-6, jnp.float16).apply({"params": {"weight": w}}, jnp.asarray(x))
    norm = RMSNorm(64, 1e-6, torch.float16)
    norm.weight.data = torch.from_numpy(w)
    with torch.no_grad():
        got = norm(torch.from_numpy(x))
    assert got.dtype == torch.float16 and want.dtype == jnp.float16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
    jcfg = dataclasses.replace(JConfig.tiny(), dtype="float16")
    table = rng.standard_normal((32, 4)).astype(np.float32)
    pos = jnp.arange(40)
    want = JBias(jcfg, True).apply({"params": {"embedding": table}}, pos, pos)
    rb = RelativePositionBias(T5Config.from_dict(jcfg.to_dict()), True)
    rb.embedding.data = torch.from_numpy(table)
    with torch.no_grad():
        got = rb(torch.arange(40), torch.arange(40))
    assert got.dtype == torch.float16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
