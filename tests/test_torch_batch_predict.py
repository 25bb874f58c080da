"""W3 through the port's runtime, data layer and ``BatchPredictor`` on the
CPU, held against the JAX package's ``BatchPredictor`` on one checkpoint.

The checkpoint is one that ``tpu_air`` writes (T5 ``tiny`` from a Flax init,
its ByteTokenizer and a cloudpickled tokenizing preprocessor).  Both
``BatchPredictor``s score the same rows with 2 workers, each leasing one
chip (the port's with ``device="cpu"`` in its predictor kwargs), in float32;
the ``generated_output`` columns must be identical row for row (rows
matched by ``keep_columns=["idx"]``).  ``tpu_air`` runs on the session
``air`` fixture; the port on a runtime of its own, started and shut down
here.
"""

import os

import numpy as np
import pandas as pd
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import tpu_air  # noqa: E402
import tpu_air_torch  # noqa: E402
from tpu_air import data as jdata  # noqa: E402
from tpu_air.data.preprocessors import BatchMapper as JBatchMapper  # noqa: E402
from tpu_air.models.t5 import T5Config as JConfig  # noqa: E402
from tpu_air.models.t5 import T5ForConditionalGeneration as JT5  # noqa: E402
from tpu_air.models.tokenizer import ByteTokenizer as JByteTokenizer  # noqa: E402
from tpu_air.predict import BatchPredictor as JBatchPredictor  # noqa: E402
from tpu_air.predict import T5GenerativePredictor as JPredictor  # noqa: E402
from tpu_air.train.checkpoint import Checkpoint as JCheckpoint  # noqa: E402
from tpu_air_torch import data as tdata  # noqa: E402
from tpu_air_torch.core import runtime as trt  # noqa: E402
from tpu_air_torch.models.tokenizer import ByteTokenizer  # noqa: E402
from tpu_air_torch.predict import BatchPredictor, T5GenerativePredictor  # noqa: E402
from tpu_air_torch.train import Checkpoint  # noqa: E402

SEQ = 24
NEW = 8


@pytest.fixture(scope="module")
def tair():
    tpu_air_torch.init(num_cpus=4, num_chips=2)
    yield tpu_air_torch
    tpu_air_torch.shutdown()


@pytest.fixture(scope="module")
def checkpoint_path(tmp_path_factory):
    jcfg = JConfig.tiny(vocab_size=384)
    enc = jnp.ones((2, 8), jnp.int32)
    params = JT5(jcfg).init(jax.random.PRNGKey(0), enc, jnp.ones_like(enc),
                            jnp.ones((2, 6), jnp.int32))["params"]

    def preprocess_function(df: pd.DataFrame) -> pd.DataFrame:
        t = JByteTokenizer(model_max_length=SEQ)
        enc = t(list(df["instruction"]), max_length=SEQ, padding="max_length",
                truncation=True, return_tensors="np")
        return pd.DataFrame({"input_ids": list(enc["input_ids"]),
                             "attention_mask": list(enc["attention_mask"])})

    path = str(tmp_path_factory.mktemp("w3_ckpt"))
    JCheckpoint.from_model(model_config=jcfg, params=params,
                           tokenizer=JByteTokenizer(model_max_length=SEQ),
                           preprocessor=JBatchMapper(preprocess_function), path=path)
    return path


def _rows(n=12, seed=0):
    rng = np.random.default_rng(seed)
    words = ["summarize", "the", "cat", "sat", "on", "mat", "translate", "dog"]
    rows = [{"instruction": " ".join(rng.choice(words, rng.integers(1, 6))), "idx": i}
            for i in range(n)]
    rows[min(5, n - 1)]["instruction"] = ""         # an all-pad prompt
    return rows


PREDICT = dict(feature_columns=["input_ids", "attention_mask"], keep_columns=["idx"],
               batch_size=3, min_scoring_workers=2, max_scoring_workers=2,
               num_chips_per_worker=1, max_new_tokens=NEW)


def test_batch_predictor_matches_tpu_air(air, tair, checkpoint_path):
    """The headline parity: the port's BatchPredictor over its runtime and
    data layer, 2 leased scoring workers on the CPU, gives the same
    generated_output column as tpu_air's, row for row."""
    want = JBatchPredictor.from_checkpoint(
        JCheckpoint.from_directory(checkpoint_path), JPredictor,
        tokenizer=JByteTokenizer).predict(jdata.from_items(_rows(), parallelism=4),
                                          **PREDICT).to_pandas()
    got = BatchPredictor.from_checkpoint(
        Checkpoint.from_directory(checkpoint_path), T5GenerativePredictor,
        tokenizer=ByteTokenizer, dtype=None, device="cpu").predict(
        tdata.from_items(_rows(), parallelism=4), **PREDICT).to_pandas()
    want = want.sort_values("idx").reset_index(drop=True)
    got = got.sort_values("idx").reset_index(drop=True)
    assert got["idx"].tolist() == list(range(12))
    assert got["generated_output"].tolist() == want["generated_output"].tolist()
    # and the in-process predictor of the port agrees with its batch path
    single = T5GenerativePredictor.from_checkpoint(
        Checkpoint.from_directory(checkpoint_path), dtype=None, device="cpu",
        tokenizer=ByteTokenizer).predict(pd.DataFrame(_rows()), max_new_tokens=NEW)
    assert single["generated_output"].tolist() == got["generated_output"].tolist()


def test_batch_predictor_without_device_refuses_on_a_machine_without_cuda(
        tair, checkpoint_path):
    """With no device in its predictor kwargs, a scoring actor places the
    model on its leased card; without CUDA that raises (through the actor)
    rather than fall back to the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the refusal applies where it has none")
    bp = BatchPredictor.from_checkpoint(Checkpoint.from_directory(checkpoint_path),
                                        T5GenerativePredictor, tokenizer=ByteTokenizer)
    with pytest.raises(tpu_air_torch.RemoteError, match="device='cpu'"):
        bp.predict(tdata.from_items(_rows(2), parallelism=1), **{
            **PREDICT, "min_scoring_workers": 1, "max_scoring_workers": 1})


def test_both_runtimes_share_no_store_or_lease(air, tair):
    """A tpu_air runtime and a port runtime in one process: separate store
    directories (each with its own prefix), each leased actor sees only its
    own runtime's lease, and the driver's environ holds no lease."""
    jroot = tpu_air.core.runtime.get_runtime().store_root
    troot = trt.get_runtime().store_root
    assert os.path.basename(jroot).startswith("tpu_air-")
    assert os.path.basename(troot).startswith("tpu_air_torch-")
    assert os.path.dirname(jroot) == os.path.dirname(troot) and jroot != troot
    driver_lease = os.environ.get("TPU_AIR_CHIP_IDS")

    def probe():
        return os.getpid(), os.environ.get("TPU_AIR_CHIP_IDS")

    JLeased = tpu_air.remote(num_chips=2)(type("JLeased", (), {"probe": lambda self: probe()}))
    TLeased = tpu_air_torch.remote(num_chips=2)(
        type("TLeased", (), {"probe": lambda self: probe()}))
    ja, ta = JLeased.remote(), TLeased.remote()
    (jpid, jlease), (tpid, tlease) = tpu_air.get(ja.probe.remote()), tpu_air_torch.get(
        ta.probe.remote())
    assert jpid != tpid and os.getpid() not in (jpid, tpid)
    assert tlease == "0,1"                          # the port's 2 chips
    assert jlease is not None and len(jlease.split(",")) == 2
    assert trt.get_runtime().free_chips == []
    tpu_air.kill(ja)
    tpu_air_torch.kill(ta)
    assert sorted(trt.get_runtime().free_chips) == [0, 1]
    assert os.environ.get("TPU_AIR_CHIP_IDS") == driver_lease
    assert not any(n.startswith("tpu_air_torch-") for n in os.listdir(jroot))
