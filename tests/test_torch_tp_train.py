"""The port's tensor-parallel trainers on the CPU against the JAX package's.

``LMTrainer`` and ``T5Trainer`` with ``ScalingConfig(model_parallel=N)``
split the model over a worker's ``(data, model)`` mesh of CPU devices (one
controller a worker; ``num_workers`` gloo ranks for the data axis), and the
JAX package's ``_lm_tp_loop`` and ``t5_train_loop`` run in this process on
the host devices ``TPU_AIR_CHIP_IDS`` names, from the same weights (a
checkpoint both packages read, or the T5's ``pretrained_params``) and the
same rows, made from numpy seeds:

* tp 2 at dp 1, and 2 gloo workers x tp 2 against the JAX (2, 2) mesh;
* tp 3 on 4 heads and d_ff 128: the divisibility drop keeps those whole
  (the T5's vocab of 384 still splits in 3);
* Adafactor at tp 2, on widths where optax factors the split kernels'
  second moments;
* a ``max_grad_norm`` small enough that the global-norm clip bites.

Everything is float32.  Tolerances: the epoch losses and eval losses within
1e-5 relative; each final logical parameter tensor within 1e-5 relative in
norm (``|got - want| / |want|``): AdamW's step is lr * g / (|g| + 1e-8) per
element, so where a gradient nearly cancels, to within f32 rounding, the
two computations move that element by different fractions of a step (as
``tests/test_torch_t5_train.py`` notes), and a few elements of a tensor
may differ by half a step (lr 1e-3, 5e-4 for the LM); the ``mesh_*`` and ``params_bytes_*``
metrics equal.
T5 with dropout at tp 2 against the port's tp 1 under the same generators:
1e-6 (the packages' generators differ, so JAX is no yardstick there).
SegFormer with ``num_chips_per_worker=2`` against the JAX loop on two host
devices: losses and batch-norm statistics, to the bounds of
``tests/test_torch_segformer_train.py``.  A tp checkpoint holds the logical
parameters: at tp 1 it gives the fit's eval loss, its greedy tokens equal
JAX's, and the JAX package reads it.
"""

import numpy as np
import pandas as pd
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from tpu_air.models.t5 import T5Config as JT5Config  # noqa: E402
from tpu_air.models.t5 import T5ForConditionalGeneration as JT5  # noqa: E402
from tpu_air.models.t5 import generate as jgenerate  # noqa: E402
from tpu_air.train import lm_trainer as jlm_trainer  # noqa: E402
from tpu_air.train import t5_trainer as jt5_trainer  # noqa: E402
from tpu_air.train.config import ScalingConfig as JScalingConfig  # noqa: E402
from tpu_air_torch.models import lm as tlm  # noqa: E402
from tpu_air_torch.models.t5.config import T5Config  # noqa: E402
from tpu_air_torch.models.t5.convert import params_from_jax as t5_from_jax  # noqa: E402
from tpu_air_torch.models.t5.generate import generate  # noqa: E402
from tpu_air_torch.models.t5.modeling import T5ForConditionalGeneration  # noqa: E402
from tpu_air_torch.models.tokenizer import ByteTokenizer  # noqa: E402
from tpu_air_torch.parallel import mesh as tmesh  # noqa: E402
from tpu_air_torch.parallel.sharding import gather_state_dict, shard_module  # noqa: E402
from tpu_air_torch.predict.predictors import T5GenerativePredictor  # noqa: E402
from tpu_air_torch.train import (  # noqa: E402
    Checkpoint,
    LMTrainer,
    RunConfig,
    ScalingConfig,
    T5Trainer,
    TrainingArguments,
)
from tpu_air_torch.train.t5_trainer import t5_local_sums  # noqa: E402

SEQ = 16
VOCAB = 384
EPOCHS = 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_session(monkeypatch, run_dir, chips, datasets, loop, config):
    """``loop(config)`` of the JAX package in this process, on the host
    devices ``chips`` names: its reported history."""
    from tpu_air.train import session as jsession
    from tpu_air.train.config import CheckpointConfig as JCheckpointConfig
    from tpu_air.train.trainer import _BroadcastDataset

    monkeypatch.setenv("TPU_AIR_CHIP_IDS", chips)
    sess = jsession.Session(run_dir=run_dir, checkpoint_config=JCheckpointConfig(num_to_keep=1),
                            datasets={k: _BroadcastDataset(v) for k, v in datasets.items()})
    jsession._set_active(sess)
    try:
        loop(config)
    finally:
        jsession._set_active(None)
    return sess.history, sess.latest_checkpoint()[0]


def _check_fit(result, jhist, jparams, keys):
    """The port's fit against the JAX loop's: every epoch's metrics in
    ``keys`` equal, its losses and final logical parameters within 1e-5
    relative (the module docstring)."""
    assert result.error is None, result.error
    assert len(result.metrics_history) == len(jhist) == EPOCHS
    for got, want in zip(result.metrics_history, jhist):
        for key in keys:
            assert got[key] == want[key], (key, got[key], want[key])
        for key in ("loss", "eval_loss"):
            np.testing.assert_allclose(got[key], want[key], rtol=1e-5, err_msg=key)
    got = result.checkpoint.get_params()
    assert set(got) == set(jparams)
    for name, want in jparams.items():
        want = want.numpy()
        assert _rel(got[name].numpy(), want) <= 1e-5, (name, _rel(got[name].numpy(), want))


def _rel(got, want) -> float:
    """A tensor's relative error: the norm of the difference over the norm
    of the reference."""
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


# -- LMTrainer ---------------------------------------------------------------------------

LM_CASES = {
    # case: (port ScalingConfig kwargs, JAX chip ids, model_parallel, args, LM config)
    "tp2": (dict(model_parallel=2), "0,1", 2, {}, "tiny"),
    "dp2_tp2": (dict(num_workers=2, model_parallel=2), "0,1,2,3", 2, {}, "tiny"),
    "tp3_drops": (dict(model_parallel=3), "0,1,2", 3, {}, "tiny"),
    "adafactor": (dict(model_parallel=2), "0,1", 2, {"optimizer": "adafactor"}, "wide"),
    "clip": (dict(model_parallel=2), "0,1", 2, {"max_grad_norm": 0.05}, "tiny"),
}


def _lm_config(kind):
    if kind == "tiny":
        return tlm.LMConfig.tiny()
    # widths where optax factors the split kernels' second moments (both
    # dims of q/k/v/o and gate/up/down at least 128)
    return tlm.LMConfig(vocab_size=VOCAB, d_model=128, n_layers=1, n_heads=4, head_dim=32,
                        d_ff=256, max_seq_len=64)


def _lm_rows(n, seed):
    return pd.DataFrame({"input_ids": list(
        np.random.default_rng(seed).integers(1, VOCAB, (n, SEQ)).astype(np.int32))})


@pytest.mark.parametrize("case", sorted(LM_CASES))
def test_lm_trainer_tp_matches_the_jax_tp_loop(case, tmp_path):
    """``LMTrainer`` with ``model_parallel`` against the JAX package's
    ``_lm_tp_loop`` from one checkpoint of the same weights."""
    from tpu_air.train.checkpoint import Checkpoint as JCheckpoint

    sc, chips, mp, extra, kind = LM_CASES[case]
    cfg = _lm_config(kind)
    start = Checkpoint.from_model(
        model_config=cfg, params=tlm.CausalLM(cfg, device="cpu").init_weights(7).state_dict(),
        format="jax", path=str(tmp_path / "start"))
    args = TrainingArguments(learning_rate=5e-4, per_device_train_batch_size=2,
                             num_train_epochs=EPOCHS, seed=3, **extra)
    train, evaluation = _lm_rows(8, 1), _lm_rows(3, 2)
    result = LMTrainer(model_config=cfg, training_args=args,
                       scaling_config=ScalingConfig(**sc),
                       datasets={"train": train, "evaluation": evaluation},
                       resume_from_checkpoint=start,
                       run_config=RunConfig(storage_path=str(tmp_path / "port")),
                       device="cpu").fit()
    from tpu_air.models.lm import LMConfig as JLMConfig

    with pytest.MonkeyPatch.context() as monkeypatch:
        jhist, jpath = _jax_session(
            monkeypatch, str(tmp_path / "jax"), chips,
            {"train": train, "evaluation": evaluation}, jlm_trainer.lm_train_loop,
            {"model_config": JLMConfig.from_dict(cfg.to_dict()),
             "training_args": jt5_trainer.TrainingArguments(**vars(args)),
             "_scaling_config": JScalingConfig(model_parallel=mp),
             "resume_from_checkpoint": start.path})
    jparams = tlm.params_from_jax(jax.tree_util.tree_map(
        np.asarray, JCheckpoint.from_directory(jpath).get_params()))
    _check_fit(result, jhist, jparams, ("epoch", "steps", "mesh_data", "mesh_model",
                                        "mesh_sequence", "params_bytes_total",
                                        "params_bytes_per_device"))
    m = result.metrics
    assert (m["mesh_data"], m["mesh_model"]) == (sc.get("num_workers", 1), mp)
    assert (m["params_bytes_per_device"] < m["params_bytes_total"]) == (case != "tp3_drops")


# -- T5Trainer ---------------------------------------------------------------------------

T5_CASES = {
    "tp2": (dict(model_parallel=2), "0,1", 2, {}, "tiny"),
    "dp2_tp2": (dict(num_workers=2, model_parallel=2), "0,1,2,3", 2, {}, "tiny"),
    "tp3_drops": (dict(model_parallel=3), "0,1,2", 3, {}, "tiny"),
    "adafactor": (dict(model_parallel=2), "0,1", 2, {"optimizer": "adafactor"}, "wide"),
    "clip": (dict(model_parallel=2), "0,1", 2, {"max_grad_norm": 0.05}, "tiny"),
}


def _t5_config(kind):
    cfg = T5Config.tiny()
    if kind == "wide":
        # wi/wo and the vocab-split lm_head get factored second moments
        cfg = T5Config(vocab_size=VOCAB, d_model=128, d_kv=32, d_ff=256, num_layers=1,
                       num_heads=4, dropout_rate=0.0)
    return cfg


def _t5_rows(n, seed):
    """Pre-tokenized rows: ragged source lengths and mostly-pad labels."""
    rng = np.random.default_rng(seed)
    ids, masks, labels = [], [], []
    for _ in range(n):
        s, t = int(rng.integers(3, SEQ + 1)), int(rng.integers(2, SEQ // 2))
        src = np.zeros(SEQ, np.int32)
        src[:s] = rng.integers(3, VOCAB, s)
        lab = np.zeros(SEQ, np.int32)
        lab[:t] = rng.integers(3, VOCAB, t)
        ids.append(src)
        masks.append((src != 0).astype(np.int32))
        labels.append(lab)
    return pd.DataFrame({"input_ids": ids, "attention_mask": masks, "labels": labels})


def _jax_t5_params(cfg):
    enc = jnp.ones((2, 8), jnp.int32)
    params = JT5(JT5Config.from_dict(cfg.to_dict())).init(
        jax.random.PRNGKey(0), enc, jnp.ones_like(enc), jnp.ones((2, 6), jnp.int32))["params"]
    return jax.tree_util.tree_map(np.asarray, params)


T5_KEYS = ("epoch", "steps", "mesh_data", "mesh_model", "mesh_num_hosts",
           "params_bytes_total", "params_bytes_per_device")


def _t5_fit(cfg, jparams, sc, args, tmp, **kw):
    return T5Trainer(model_config=cfg, training_args=args, scaling_config=ScalingConfig(**sc),
                     pretrained_params=t5_from_jax(jparams, cfg),
                     datasets={"train": _t5_rows(8, 1), "evaluation": _t5_rows(3, 2)},
                     run_config=RunConfig(storage_path=str(tmp)), device="cpu", **kw).fit()


def _jax_t5_fit(cfg, jparams, chips, mp, args, tmp):
    from tpu_air.train.checkpoint import Checkpoint as JCheckpoint

    with pytest.MonkeyPatch.context() as monkeypatch:
        jhist, jpath = _jax_session(
            monkeypatch, str(tmp), chips,
            {"train": _t5_rows(8, 1), "evaluation": _t5_rows(3, 2)}, jt5_trainer.t5_train_loop,
            {"model_config": JT5Config.from_dict(cfg.to_dict()),
             "training_args": jt5_trainer.TrainingArguments(**vars(args)),
             "_scaling_config": JScalingConfig(model_parallel=mp),
             "pretrained_params": jax.tree_util.tree_map(jnp.asarray, jparams)})
    jfinal = jax.tree_util.tree_map(np.asarray, JCheckpoint.from_directory(jpath).get_params())
    return jhist, jfinal


@pytest.fixture(scope="module")
def t5_tp2(tmp_path_factory):
    """The tp 2 fit of both packages, kept for the checkpoint tests."""
    tmp = tmp_path_factory.mktemp("t5_tp2")
    cfg = _t5_config("tiny")
    jparams = _jax_t5_params(cfg)
    args = TrainingArguments(learning_rate=1e-3, per_device_train_batch_size=2,
                             num_train_epochs=EPOCHS, seed=3)
    result = _t5_fit(cfg, jparams, dict(model_parallel=2), args, tmp / "port")
    jhist, jfinal = _jax_t5_fit(cfg, jparams, "0,1", 2, args, tmp / "jax")
    return cfg, result, jhist, jfinal


@pytest.mark.parametrize("case", sorted(T5_CASES))
def test_t5_trainer_tp_matches_the_jax_loop(case, t5_tp2, tmp_path):
    """``T5Trainer`` with ``model_parallel`` against the JAX package's
    ``t5_train_loop`` on a ``(data, model)`` mesh, from the same weights."""
    sc, chips, mp, extra, kind = T5_CASES[case]
    if case == "tp2":
        cfg, result, jhist, jfinal = t5_tp2
    else:
        cfg = _t5_config(kind)
        jparams = _jax_t5_params(cfg)
        args = TrainingArguments(learning_rate=1e-3, per_device_train_batch_size=2,
                                 num_train_epochs=EPOCHS, seed=3, **extra)
        result = _t5_fit(cfg, jparams, sc, args, tmp_path / "port")
        jhist, jfinal = _jax_t5_fit(cfg, jparams, chips, mp, args, tmp_path / "jax")
    _check_fit(result, jhist, t5_from_jax(jfinal, cfg), T5_KEYS)
    m = result.metrics
    assert (m["mesh_data"], m["mesh_model"]) == (sc.get("num_workers", 1), mp)
    assert m["params_bytes_per_device"] < m["params_bytes_total"]


def test_t5_tensor_parallelism_argument_and_in_worker_data_axis(t5_tp2, tmp_path):
    """``TrainingArguments(tensor_parallelism=2)`` over a worker of 2 devices
    is ``model_parallel=2``; a worker of 4 devices at tp 2 is a (2, 2) mesh
    in one controller, equal to 2 gloo workers x tp 2 and to JAX's."""
    cfg, tp2, _, _ = t5_tp2
    jparams = _jax_t5_params(cfg)
    args = TrainingArguments(learning_rate=1e-3, per_device_train_batch_size=2,
                             num_train_epochs=EPOCHS, seed=3, tensor_parallelism=2)
    by_args = _t5_fit(cfg, jparams, dict(num_chips_per_worker=2), args, tmp_path / "a")
    assert by_args.error is None, by_args.error
    for got, want in zip(by_args.metrics_history, tp2.metrics_history):
        assert {k: got[k] for k in T5_KEYS} == {k: want[k] for k in T5_KEYS}
        assert got["loss"] == want["loss"] and got["eval_loss"] == want["eval_loss"]
    args.tensor_parallelism = 1
    in_worker = _t5_fit(cfg, jparams, dict(num_chips_per_worker=4, model_parallel=2), args,
                        tmp_path / "b")
    jhist, jfinal = _jax_t5_fit(cfg, jparams, "0,1,2,3", 2, args, tmp_path / "jax")
    _check_fit(in_worker, jhist, t5_from_jax(jfinal, cfg), T5_KEYS)
    assert in_worker.metrics["mesh_data"] == 2


def test_t5_tp_dropout_masks_are_the_single_device_ones(tmp_path):
    """Dropout 0.1: the tp 2 fit equals the tp 1 fit of the port under the
    same generators (masks drawn at the logical shape and sliced)."""
    cfg = T5Config.tiny()
    cfg.dropout_rate = 0.1
    jparams = _jax_t5_params(T5Config.tiny())
    args = TrainingArguments(learning_rate=1e-3, per_device_train_batch_size=2,
                             num_train_epochs=EPOCHS, seed=3)
    runs = [_t5_fit(cfg, jparams, dict(model_parallel=tp), args, tmp_path / str(tp))
            for tp in (1, 2)]
    one, two = runs
    assert one.error is None and two.error is None, (one.error, two.error)
    for a, b in zip(one.metrics_history, two.metrics_history):
        np.testing.assert_allclose(b["loss"], a["loss"], rtol=1e-6)
        np.testing.assert_allclose(b["eval_loss"], a["eval_loss"], rtol=1e-6)
    # dropout moved the loss: it is not the deterministic fit's
    plain = _t5_fit(T5Config.tiny(), jparams, dict(model_parallel=2), args, tmp_path / "p")
    assert abs(plain.metrics_history[0]["loss"] - one.metrics_history[0]["loss"]) > 1e-3
    want = one.checkpoint.get_params()
    for name, p in two.checkpoint.get_params().items():
        assert _rel(p.numpy(), want[name].numpy()) <= 1e-6, name


def test_tp_checkpoint_loads_at_tp1_and_generates_the_jax_tokens(t5_tp2, tmp_path):
    """The tp 2 fit's checkpoint holds the logical parameters: a tp 1 model
    loads it and gives the fit's last eval loss, ``T5GenerativePredictor``
    generates from it the greedy tokens JAX generates from the JAX fit, and
    the JAX package reads the same model written in its layout."""
    from tpu_air.train.checkpoint import Checkpoint as JCheckpoint

    cfg, result, _, jfinal = t5_tp2
    ckpt = result.checkpoint
    model = T5ForConditionalGeneration(cfg, device="cpu")
    model.load_state_dict(ckpt.get_params())
    evaluation = _t5_rows(3, 2)
    batch = {k: torch.from_numpy(np.stack(evaluation[k])).long() for k in evaluation}
    with torch.no_grad():
        total, count = t5_local_sums(model, batch)
    np.testing.assert_allclose(float(total / count), result.metrics["eval_loss"], rtol=1e-5)

    pred = T5GenerativePredictor.from_checkpoint(ckpt, dtype="float32", device="cpu",
                                                 tokenizer=ByteTokenizer(SEQ))
    got = generate(pred.model, batch["input_ids"], batch["attention_mask"],
                   max_new_tokens=6).numpy()
    want = np.asarray(jgenerate(JT5(JT5Config.from_dict(cfg.to_dict())), jfinal,
                                batch["input_ids"].numpy(), batch["attention_mask"].numpy(),
                                max_new_tokens=6))
    np.testing.assert_array_equal(got, want)

    sharded = T5ForConditionalGeneration(cfg, device="cpu")
    sharded.load_state_dict(ckpt.get_params())
    from tpu_air_torch.models.t5.convert import tp_split_dims

    shard_module(sharded, [torch.device("cpu")] * 2, tp_split_dims(cfg, 2))
    assert any(".shards." in n for n, _ in sharded.named_parameters())
    path = str(tmp_path / "jax_layout")
    Checkpoint.from_model(model_config=cfg, params=sharded, format="jax", path=path)
    jread = JCheckpoint.from_directory(path).get_params()
    want = np.asarray(jgenerate(JT5(JT5Config.from_dict(cfg.to_dict())), jread,
                                batch["input_ids"].numpy(), batch["attention_mask"].numpy(),
                                max_new_tokens=6))
    np.testing.assert_array_equal(got, want)
    for name, t in gather_state_dict(sharded).items():
        assert torch.equal(t, model.state_dict()[name]), name


# -- the mesh helpers -----------------------------------------------------------------------


def test_worker_mesh_batch_and_replicated_sharding(monkeypatch):
    """A worker's devices are its consecutive leased ids, wrapped onto the
    cards; tp beyond them raises the JAX loops' text; a batch's rows split
    over the data axis onto each replica's first device; a replicated
    tensor sits once on each device."""
    cpu = torch.device("cpu")
    assert tmesh.worker_devices(1, 2, cpu) == [cpu, cpu]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setenv("TPU_AIR_CHIP_IDS", "0,1,2,3")
    cuda0 = torch.device("cuda", 0)
    assert tmesh.worker_devices(1, 2, torch.device("cuda")) == [cuda0, cuda0]
    monkeypatch.delenv("TPU_AIR_CHIP_IDS")
    devs = tmesh.worker_devices(0, 2, torch.device("cuda"))
    with pytest.raises(ValueError, match="model_parallel=2 exceeds the 1 visible devices "
                                         "of this run's chip lease"):
        tmesh.worker_mesh(devs, 2)
    mesh = tmesh.worker_mesh([cpu] * 6, 2)
    assert dict(mesh.shape) == {"data": 3, "model": 2}
    x = torch.arange(12).reshape(6, 2)
    parts = tmesh.batch_sharding({"ids": x}, mesh)
    assert [torch.equal(p["ids"], x[2 * r:2 * r + 2]) for r, p in enumerate(parts)] == [True] * 3
    rep = tmesh.replicated_sharding(x, mesh)
    assert rep.shape == (3, 2) and all(t is x for t in rep.flat)
    with pytest.raises(ValueError, match="does not split over data=3"):
        tmesh.batch_sharding(x[:4], mesh)


# -- SegFormer over a worker's devices ---------------------------------------------------------


def test_segformer_over_two_devices_of_a_worker_matches_the_jax_loop(tmp_path):
    """``num_chips_per_worker=2``: one controller, a replica on each device,
    the batch norm's moments over both; two epochs' losses, parameters and
    running stats against the JAX loop on 2 host devices."""
    import test_torch_segformer_train as seg

    v = jax.jit(seg.J.SegformerForSemanticSegmentation(seg.JCFG).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, seg.SIZE, seg.SIZE, 3)))
    jvars = seg._tree_map(np.asarray, {"params": v["params"], "batch_stats": v["batch_stats"]})
    raw = seg._ade_like(8, 6)
    raw.loc[4:, "image"] = [np.clip(im.astype(np.int32) + 90, 0, 255).astype(np.uint8)
                            for im in raw["image"][4:]]
    rows = seg._preprocess(raw)
    args = TrainingArguments(learning_rate=seg.LR, weight_decay=0.0,
                             per_device_train_batch_size=2, num_train_epochs=EPOCHS, seed=3)
    datasets = {"train": rows, "evaluation": rows.iloc[:4]}
    from tpu_air_torch.train import SegformerTrainer

    result = SegformerTrainer(
        model_config=seg.PCFG, training_args=args, pretrained_variables=jvars,
        datasets=datasets, scaling_config=ScalingConfig(num_chips_per_worker=2),
        run_config=RunConfig(storage_path=str(tmp_path / "port")), device="cpu").fit()
    assert result.error is None, result.error
    with pytest.MonkeyPatch.context() as monkeypatch:
        jhist, jbest = seg._jax_fit(monkeypatch, str(tmp_path / "jax"), "0,1", datasets, args,
                                    jvars)
    assert [m["steps"] for m in result.metrics_history] == [m["steps"] for m in jhist] == [2, 2]
    for got, want in zip(result.metrics_history, jhist):
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        np.testing.assert_allclose(got["eval_loss"], want["eval_loss"], rtol=2e-4)
    from tpu_air.train import Checkpoint as JCheckpoint

    jc = JCheckpoint.from_directory(jbest)
    jstats = seg._tree_map(np.asarray, jc._load_extras()["batch_stats"])
    want = seg._flat(seg.params_from_jax(seg._tree_map(np.asarray, jc.get_params()), jstats,
                                         seg.PCFG))
    got = seg._flat(result.checkpoint.get_params())
    steps = sum(m["steps"] for m in jhist)
    seg._check_params(got, want, steps=steps)
    seg._check_stats(got, want, steps=steps, var_atol=1e-5)


# -- Tune: a tp trial meshes its lease in its actor --------------------------------------------


def test_a_tp_trial_meshes_its_lease_in_its_actor(tmp_path):
    """``Tuner(T5Trainer(model_parallel=2))`` with one worker starts no
    process: its trial actor trains at tp 2 (on the CPU named twice: a
    trainer on the CPU leases no chip slot)."""
    import tpu_air_torch
    from tpu_air_torch import tune
    from tpu_air_torch.core import runtime as rt

    saved = rt._runtime
    rt._runtime = None
    tpu_air_torch.init(num_cpus=2, num_chips=2)
    try:
        trainer = T5Trainer(model_config=T5Config.tiny(),
                            training_args=TrainingArguments(num_train_epochs=1,
                                                            per_device_train_batch_size=2),
                            datasets={"train": _t5_rows(4, 5)},
                            scaling_config=ScalingConfig(model_parallel=2), device="cpu")
        grid = tune.Tuner(trainer, param_space={"trainer_init_config": {
            "learning_rate": tune.grid_search([1e-3])}},
            run_config=RunConfig(storage_path=str(tmp_path))).fit()
        assert grid.num_errors == 0, grid.errors
        m = grid[0].metrics
        assert (m["mesh_model"], m["mesh_data"]) == (2, 1) and np.isfinite(m["loss"])
        assert m["params_bytes_per_device"] < m["params_bytes_total"]
    finally:
        tpu_air_torch.shutdown()
        rt._runtime = saved
