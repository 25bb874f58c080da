"""The port's checkpoints against the JAX package's, in both directions.

A checkpoint that ``tpu_air.train.checkpoint.Checkpoint.from_model`` writes
(``kind`` ``jax_model``, the Flax tree in ``params.msgpack``, a cloudpickled
preprocessor that names ``tpu_air`` classes) loads in the port without
flax, and one the port writes with ``format="jax"`` loads in ``tpu_air``.
Weights come from a Flax init of the tiny configs, prompts from numpy
seeds.  Greedy tokens must be identical; LM logits agree to 1e-4 (f32,
summation order over two layers).
"""

import json
import os
import pickle

import numpy as np
import pandas as pd
import pytest

jax = pytest.importorskip("jax")
import flax.serialization as fser  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from tpu_air.data.preprocessors import BatchMapper as JBatchMapper  # noqa: E402
from tpu_air.models import lm as jlm  # noqa: E402
from tpu_air.models.t5 import T5Config as JConfig  # noqa: E402
from tpu_air.models.t5 import T5ForConditionalGeneration as JT5  # noqa: E402
from tpu_air.models.tokenizer import ByteTokenizer as JByteTokenizer  # noqa: E402
from tpu_air.predict.predictors import T5GenerativePredictor as JPredictor  # noqa: E402
from tpu_air.train.checkpoint import Checkpoint as JCheckpoint  # noqa: E402
from tpu_air_torch.models import lm as tlm  # noqa: E402
from tpu_air_torch.models.t5.config import T5Config  # noqa: E402
from tpu_air_torch.models.t5.convert import params_from_jax  # noqa: E402
from tpu_air_torch.models.tokenizer import ByteTokenizer  # noqa: E402
from tpu_air_torch.predict.predictors import T5GenerativePredictor  # noqa: E402
from tpu_air_torch.train import Checkpoint, flax_msgpack  # noqa: E402

SEQ = 24
LM_TINY = dict(vocab_size=128, d_model=32, n_layers=2, n_heads=2, head_dim=16, d_ff=64,
               max_seq_len=64)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_t5_params(jcfg):
    enc = jnp.ones((2, 8), jnp.int32)
    return JT5(jcfg).init(jax.random.PRNGKey(0), enc, jnp.ones_like(enc),
                          jnp.ones((2, 6), jnp.int32))["params"]


def _preprocessor():
    """The t5_checkpoint fixture's pattern: a BatchMapper around a local
    function (so cloudpickle stores it by value) that tokenizes with the JAX
    package's ByteTokenizer."""
    def preprocess_function(df: pd.DataFrame) -> pd.DataFrame:
        t = JByteTokenizer(model_max_length=SEQ)
        enc = t(list(df["instruction"]), max_length=SEQ, padding="max_length",
                truncation=True, return_tensors="np")
        return pd.DataFrame({"input_ids": list(enc["input_ids"]),
                             "attention_mask": list(enc["attention_mask"])})

    return JBatchMapper(preprocess_function, batch_format="pandas", batch_size=4096)


def _prompts(n=6, seed=0):
    rng = np.random.default_rng(seed)
    words = ["alpha", "beta", "gamma", "delta", "eps", "zeta"]
    rows = [" ".join(rng.choice(words, rng.integers(1, 5))) for _ in range(n)]
    rows[2] = ""                                    # an all-pad prompt
    return pd.DataFrame({"instruction": rows})


@pytest.fixture(scope="module")
def jax_t5_checkpoint(tmp_path_factory):
    jcfg = JConfig.tiny(vocab_size=384)
    params = _jax_t5_params(jcfg)
    path = str(tmp_path_factory.mktemp("jax_ckpt"))
    JCheckpoint.from_model(model_config=jcfg, params=params,
                           tokenizer=JByteTokenizer(model_max_length=SEQ),
                           preprocessor=_preprocessor(), path=path)
    return path


def test_jax_written_t5_checkpoint_gives_identical_tokens(jax_t5_checkpoint):
    """tpu_air writes, the port loads (params.msgpack without flax, the
    preprocessor through the port's copies): greedy tokens identical to
    tpu_air's predictor on the same rows."""
    df = _prompts()
    want = JPredictor.from_checkpoint(JCheckpoint.from_directory(jax_t5_checkpoint)).predict(
        df, max_new_tokens=8)
    ckpt = Checkpoint.from_directory(jax_t5_checkpoint)
    pred = T5GenerativePredictor.from_checkpoint(ckpt, dtype=None, device="cpu")
    assert type(pred._preprocessor).__module__ == "tpu_air_torch.data.preprocessors"
    got = pred.predict(df, max_new_tokens=8)
    assert list(got["generated_output"]) == list(want["generated_output"])
    params = ckpt.get_params()
    assert all(v.dtype == torch.float32 for v in params.values())


def test_port_written_jax_format_loads_in_tpu_air(tmp_path):
    """The port writes (format="jax"), tpu_air loads: the same tokens."""
    jcfg = JConfig.tiny(vocab_size=384)
    cfg = T5Config.from_dict(jcfg.to_dict())
    sd = params_from_jax(jax.device_get(_jax_t5_params(jcfg)), cfg)
    path = str(tmp_path / "port_ckpt")
    Checkpoint.from_model(model_config=cfg, params=sd, format="jax",
                          tokenizer=ByteTokenizer(model_max_length=SEQ), path=path)
    with open(os.path.join(path, "kind.json")) as f:
        assert json.load(f)["kind"] == "jax_model"
    ids = np.random.default_rng(3).integers(2, 384, (4, 10)).astype(np.int32)
    df = pd.DataFrame({"input_ids": list(ids), "attention_mask": list(np.ones_like(ids))})
    want = JPredictor.from_checkpoint(JCheckpoint.from_directory(path)).predict(
        df, max_new_tokens=8)
    got = T5GenerativePredictor.from_checkpoint(
        Checkpoint.from_directory(path), dtype=None, device="cpu").predict(
        df, max_new_tokens=8)
    assert list(got["generated_output"]) == list(want["generated_output"])
    # and the trees agree leaf for leaf
    jtree = JCheckpoint.from_directory(path).get_params()
    back = Checkpoint.from_directory(path).get_params()
    assert set(back) == set(sd)
    for k in sd:
        np.testing.assert_array_equal(back[k].numpy(), sd[k].numpy())
    assert jax.tree_util.tree_structure(jtree) == jax.tree_util.tree_structure(
        _jax_t5_params(jcfg))


def _leaves_equal(a, b):
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b)
        for k in a:
            _leaves_equal(a[k], b[k])
    elif isinstance(a, (np.ndarray, np.generic)):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    else:
        assert a == b


@pytest.mark.parametrize("chunk", [None, 64])
def test_flax_msgpack_round_trip_matches_flax(chunk, monkeypatch):
    """The port's reader equals flax's on flax's bytes, and flax reads the
    port's bytes back leaf for leaf; with a small chunk size, arrays split
    into flax's chunked form both ways."""
    rng = np.random.default_rng(0)
    tree = {"layer": {"kernel": rng.standard_normal((3, 40)).astype(np.float32),
                      "idx": np.arange(7, dtype=np.int32),
                      "h": rng.standard_normal((2, 5)).astype(np.float16)},
            "step": 12, "neg": -70000, "rate": 0.5, "name": "t" * 40, "none": None,
            "flag": True, "empty": {}, "scalar": np.float32(2.5),
            "wide": {str(i): np.full(i, i, np.int64) for i in range(20)}}
    if chunk:
        monkeypatch.setattr(fser, "MAX_CHUNK_SIZE", chunk)
        monkeypatch.setattr(flax_msgpack, "MAX_CHUNK_SIZE", chunk)
    _leaves_equal(fser.msgpack_restore(fser.msgpack_serialize(tree)),
                  flax_msgpack.loads(fser.msgpack_serialize(tree)))
    _leaves_equal(tree, fser.msgpack_restore(flax_msgpack.dumps(tree)))
    _leaves_equal(tree, flax_msgpack.loads(flax_msgpack.dumps(tree)))
    bf = np.asarray(jnp.asarray([1.5, -2.25, 3e-3], jnp.bfloat16))
    got = flax_msgpack.loads(fser.msgpack_serialize({"bf": bf}))["bf"]
    np.testing.assert_array_equal(got, bf.astype(np.float32))


def test_jax_written_lm_checkpoint_loads_and_round_trips(tmp_path):
    """An LM checkpoint tpu_air writes loads in the port: the logits agree
    and the greedy next tokens are identical; the port's JAX-format write
    loads back in tpu_air with the same tree."""
    jcfg = jlm.LMConfig(**LM_TINY)
    jparams = jlm.CausalLM(jcfg).init(jax.random.PRNGKey(0),
                                      jnp.ones((1, 8), jnp.int32))["params"]
    path = str(tmp_path / "lm")
    JCheckpoint.from_model(model_config=jcfg, params=jparams, path=path)
    ids = np.random.default_rng(1).integers(1, 128, (2, 20)).astype(np.int32)
    want = np.asarray(jlm.CausalLM(jcfg).apply({"params": jparams}, jnp.asarray(ids)))
    model = Checkpoint.from_directory(path).get_model(device="cpu")
    assert isinstance(model, tlm.CausalLM)
    with torch.no_grad():
        got = model(torch.from_numpy(ids).long()).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))

    back = str(tmp_path / "lm_port")
    Checkpoint.from_model(model_config=model.config, params=model.state_dict(),
                          format="jax", path=back)
    _leaves_equal(jax.tree_util.tree_map(np.asarray, jparams),
                  jax.tree_util.tree_map(np.asarray,
                                         JCheckpoint.from_directory(back).get_params()))


def test_unreadable_checkpoints_raise(jax_t5_checkpoint, tmp_path):
    """An unknown kind, an unknown dtype, a layout that does not convert,
    and a preprocessor naming an uncopied tpu_air module each raise, naming
    what could not be read; a checkpoint without parameters gives None."""
    import shutil

    def copy(name):
        dst = str(tmp_path / name)
        shutil.copytree(jax_t5_checkpoint, dst)
        return dst

    bad_kind = copy("kind")
    with open(os.path.join(bad_kind, "kind.json"), "w") as f:
        json.dump({"kind": "sklearn"}, f)
    with pytest.raises(ValueError, match="'sklearn'"):
        Checkpoint.from_directory(bad_kind).get_params()

    bad_dtype = copy("dtype")
    tree = flax_msgpack.loads(open(os.path.join(bad_dtype, "params.msgpack"), "rb").read())
    tree["shared"]["embedding"] = tree["shared"]["embedding"].astype(np.complex64)
    with open(os.path.join(bad_dtype, "params.msgpack"), "wb") as f:
        f.write(fser.msgpack_serialize(tree))
    with pytest.raises(ValueError, match="complex64"):
        Checkpoint.from_directory(bad_dtype).get_params()

    bad_layout = copy("layout")
    tree = flax_msgpack.loads(open(os.path.join(bad_layout, "params.msgpack"), "rb").read())
    del tree["decoder"]
    with open(os.path.join(bad_layout, "params.msgpack"), "wb") as f:
        f.write(flax_msgpack.dumps(tree))
    with pytest.raises(ValueError, match="does not convert"):
        Checkpoint.from_directory(bad_layout).get_params()

    bad_pp = copy("pp")
    from tpu_air.data import block as jblock

    def uses_block(df):
        return jblock.block_to_pandas(df)

    import cloudpickle

    with open(os.path.join(bad_pp, "preprocessor.pkl"), "wb") as f:
        cloudpickle.dump(JBatchMapper(uses_block), f)
    with pytest.raises(pickle.UnpicklingError, match="tpu_air.data.block"):
        Checkpoint.from_directory(bad_pp).get_preprocessor()

    no_params = copy("none")
    os.remove(os.path.join(no_params, "params.msgpack"))
    assert Checkpoint.from_directory(no_params).get_params() is None
    with pytest.raises(ValueError, match="no parameters"):
        Checkpoint.from_directory(no_params).get_model(device="cpu")
