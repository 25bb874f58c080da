"""The port's W6/W7 slice (SegFormer fine-tuning and prediction) on the CPU
against the JAX package's.

The same weights (a Flax init of ``SegformerConfig.tiny()`` with dropout
off, carried across by ``params_from_jax``) and the same synthetic
ADE-like images, made from numpy seeds, go through the JAX package's step
and ``segformer_train_loop`` (run in this process on conftest's host
devices) and through the port's ``make_segformer_train_step`` and
``SegformerTrainer(device="cpu").fit()``.

Tolerances: f32 losses 1e-5 relative (two worker processes against one:
1e-6).  Parameters after AdamW steps of lr 1e-4: AdamW's step is
``lr * g / (|g| + 1e-8)`` per element, so where a gradient nearly cancels,
to within f32 rounding, the two computations' steps of that element differ
by up to a whole step (as in tests/test_torch_t5_train.py).  After n steps
every element is held to n steps, and all but a thousandth of them to 3%
of n steps.  The decode head's ``linear_c`` biases are held to twice that:
they feed the batch norm, whose batch mean cancels them, so their gradient
is 0 in exact arithmetic and rounding noise in practice, and each moves a
whole step either way.  That drift reaches what does not cancel them: the
running mean (bounded in ``_check_stats``) and, through the running stats,
a fit's eval losses, held to 2e-4 relative (8 steps here: they differ by
6e-5).  The running variance does not see it: 1e-5 after one step or a
fit, 1e-6 between worker counts.  Predicted masks are equal except at
pixels whose top two logits lie within 5e-4 of each other.
"""

import numpy as np
import pandas as pd
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

import tpu_air_torch  # noqa: E402
from tpu_air.models import segformer as J  # noqa: E402
from tpu_air.train import segformer_trainer as jseg  # noqa: E402
from tpu_air.train import t5_trainer as jt5  # noqa: E402
from tpu_air_torch import data as tdata  # noqa: E402
from tpu_air_torch.data.preprocessors import BatchMapper  # noqa: E402
from tpu_air_torch.models import segformer as P  # noqa: E402
from tpu_air_torch.models.segformer.convert import params_from_jax  # noqa: E402
from tpu_air_torch.predict import BatchPredictor, SemanticSegmentationPredictor  # noqa: E402
from tpu_air_torch.predict import TorchPredictor  # noqa: E402
from tpu_air_torch.train import (  # noqa: E402
    Checkpoint,
    CheckpointConfig,
    RunConfig,
    ScalingConfig,
    SegformerTrainer,
    TrainingArguments,
)
from tpu_air_torch.train import segformer_trainer as tseg  # noqa: E402

SIZE = 32
LR = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: one torch thread (and one per worker process), so these
    tests add little CPU load beside the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


JCFG = J.SegformerConfig.tiny(classifier_dropout_prob=0.0)
PCFG = P.SegformerConfig.from_json(JCFG.to_json())


@pytest.fixture(scope="module")
def jax_vars():
    """A Flax init of the tiny SegFormer (dropout off), as numpy leaves, with
    running stats moved off their init so the momentum shows."""
    model = J.SegformerForSemanticSegmentation(JCFG)
    v = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)))
    params = _tree_map(np.asarray, v["params"])
    stats = _tree_map(np.asarray, v["batch_stats"])
    rng = np.random.default_rng(1)
    bn = stats["decode_head"]["batch_norm"]
    bn["mean"] = rng.normal(size=bn["mean"].shape).astype(np.float32)
    bn["var"] = rng.uniform(0.5, 2.0, size=bn["var"].shape).astype(np.float32)
    return {"params": params, "batch_stats": stats}


def _port_sd(jax_vars):
    return params_from_jax(jax_vars["params"], jax_vars["batch_stats"], PCFG)


def _ade_like(n, seed, hw=(40, 48)):
    """(image, annotation) rows: the reference's from_items ingest shape
    (Scaling_model_training.ipynb:cc-24,33); annotations 0-8, 0 = unlabeled."""
    rng = np.random.default_rng(seed)
    return pd.DataFrame({
        "image": [rng.integers(0, 256, size=(*hw, 3)).astype(np.uint8) for _ in range(n)],
        "annotation": [rng.integers(0, 9, size=hw).astype(np.uint8) for _ in range(n)]})


def _preprocess(df: pd.DataFrame) -> pd.DataFrame:
    proc = P.SegformerImageProcessor(size=SIZE, do_reduce_labels=True)
    out = proc(list(df["image"]), segmentation_maps=list(df["annotation"]))
    return pd.DataFrame({"pixel_values": list(out["pixel_values"]),
                         "labels": list(out["labels"])})


def _flat(sd):
    return {k: v.detach().float().numpy().copy() for k, v in sd.items()}


def _check_params(got, want, steps=1):
    """The parameters' bounds of the module docstring after ``steps``
    AdamW steps (the running stats are checked on their own)."""
    rest = []
    for k in want:
        if "running" in k:
            continue
        cancelled = ".linear_c_" in k and k.endswith(".bias")
        err = np.abs(got[k] - want[k])
        assert err.max() <= (2 if cancelled else 1) * steps * LR, (k, err.max())
        if not cancelled:
            rest.append(err.ravel())
    assert np.quantile(np.concatenate(rest), 0.999) < 0.03 * steps * LR


def _check_stats(got, want, steps, var_atol):
    """The batch norm's running stats after ``steps`` train steps.  The
    running mean sees the linear_c biases through the 1x1 fuse conv: its
    batch mean shifts by W_fuse @ db (a bilinear upsample keeps a
    constant).  After k steps |db| <= 2 k lr, and the steps' EMA weights sum
    to 1 - 0.9^steps: a bound on how far two running means may part.  The
    variance does not see a shift."""
    w_fuse = np.abs(want["decode_head.linear_fuse.weight"][:, :, 0, 0]).sum(1)
    bound = (1 - 0.9 ** steps) * w_fuse * 2 * steps * LR
    name = "decode_head.batch_norm.running_mean"
    assert (np.abs(got[name] - want[name]) <= bound).all()
    name = "decode_head.batch_norm.running_var"
    np.testing.assert_allclose(got[name], want[name], atol=var_atol, rtol=0)


# -- one step against the JAX step ---------------------------------------------


def test_one_adamw_step_matches_the_jax_step(jax_vars):
    """One train-mode step (clipping on): loss, every parameter after the
    AdamW update, and the batch norm's running stats."""
    batch = _preprocess(_ade_like(3, 2))
    px = np.stack(batch["pixel_values"]).astype(np.float32)
    labels = np.stack(batch["labels"]).astype(np.int32)
    args = TrainingArguments(learning_rate=LR, weight_decay=0.01, max_grad_norm=1.0)

    jmodel = J.SegformerForSemanticSegmentation(JCFG)
    tx = jt5._make_optimizer(jt5.TrainingArguments(**vars(args)), 1)
    params = _tree_map(jnp.asarray, jax_vars["params"])

    def lf(p):
        logits, upd = jmodel.apply({"params": p, "batch_stats": jax_vars["batch_stats"]},
                                   jnp.asarray(px), deterministic=False,
                                   rngs={"dropout": jax.random.PRNGKey(0)},
                                   mutable=["batch_stats"])
        return J.segmentation_loss(logits, jnp.asarray(labels)), upd["batch_stats"]

    @jax.jit
    def jax_step(p):
        (loss, stats), grads = jax.value_and_grad(lf, has_aux=True)(p)
        updates, _ = tx.update(grads, tx.init(p), p)
        return loss, stats, optax.apply_updates(p, updates)

    want_loss, new_stats, new = jax_step(params)
    new = _tree_map(np.asarray, new)
    want = _flat(params_from_jax(new, _tree_map(np.asarray, new_stats), PCFG))

    model = P.SegformerForSemanticSegmentation(PCFG, device="cpu")
    model.load_state_dict(_port_sd(jax_vars))
    model.train()
    opt = tseg._make_optimizer(args, 1, model.parameters())
    loss = tseg.make_segformer_train_step(model, opt)(torch.from_numpy(px),
                                                      torch.from_numpy(labels))
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    got = _flat(model.state_dict())
    _check_params(got, want)
    start = _flat(_port_sd(jax_vars))
    moved = np.concatenate([np.abs(want[k] - start[k]).ravel() for k in want
                            if "running" not in k])
    assert np.median(moved) > 0.5 * LR        # the step is not lost in the bound
    for k in ("running_mean", "running_var"):
        name = f"decode_head.batch_norm.{k}"
        np.testing.assert_allclose(got[name], want[name], atol=1e-5, rtol=0)
        assert np.abs(got[name] - start[name]).max() > 1e-3


# -- fit() against the JAX loop ---------------------------------------------------


def _jax_fit(monkeypatch, run_dir, chips, datasets, args, jax_vars):
    """The JAX package's ``segformer_train_loop`` in this process on the host
    devices ``chips`` names: (history, best checkpoint path)."""
    from tpu_air.train import session as jsession
    from tpu_air.train.config import CheckpointConfig as JCheckpointConfig
    from tpu_air.train.trainer import _BroadcastDataset

    monkeypatch.setenv("TPU_AIR_CHIP_IDS", chips)
    sess = jsession.Session(
        run_dir=run_dir, checkpoint_config=JCheckpointConfig(
            num_to_keep=1, checkpoint_score_attribute="loss", checkpoint_score_order="min"),
        datasets={k: _BroadcastDataset(v) for k, v in datasets.items()})
    jsession._set_active(sess)
    try:
        jseg.segformer_train_loop({
            "model_config": JCFG, "training_args": jt5.TrainingArguments(**vars(args)),
            "pretrained_variables": jax_vars})
    finally:
        jsession._set_active(None)
    return sess.history, sess.best_checkpoint()[0]


@pytest.fixture(scope="module")
def w6_runs(jax_vars, tmp_path_factory):
    """Two epochs of W6 at test dials through the port's ``SegformerTrainer``
    (raw rows and the ``images_preprocessor`` BatchMapper) and through the
    JAX loop on the same preprocessed rows, from the same weights."""
    tmp = tmp_path_factory.mktemp("w6")
    train, evaluation = _ade_like(8, 3), _ade_like(4, 4)
    args = TrainingArguments(learning_rate=LR, weight_decay=0.0,
                             per_device_train_batch_size=2, num_train_epochs=2, seed=3)
    result = SegformerTrainer(
        model_config=PCFG, training_args=args, pretrained_variables=jax_vars,
        feature_extractor=P.SegformerImageProcessor(size=SIZE),
        datasets={"train": train, "evaluation": evaluation},
        preprocessor=BatchMapper(_preprocess, batch_format="pandas"),
        run_config=RunConfig(storage_path=str(tmp), checkpoint_config=CheckpointConfig(
            num_to_keep=1, checkpoint_score_attribute="loss", checkpoint_score_order="min")),
        device="cpu").fit()
    with pytest.MonkeyPatch.context() as mp:
        datasets = {"train": _preprocess(train), "evaluation": _preprocess(evaluation)}
        jhist, jbest = _jax_fit(mp, str(tmp / "jax"), "0", datasets, args, jax_vars)
    return result, jhist, jbest


def test_segformer_trainer_matches_the_jax_loop(w6_runs):
    result, jhist, jbest = w6_runs
    assert result.error is None, result.error
    assert len(result.metrics_history) == len(jhist) == 2
    for got, want in zip(result.metrics_history, jhist):
        assert {"epoch", "loss", "steps", "train_images_per_sec", "eval_loss"} <= set(got)
        assert got["steps"] == want["steps"] == 4
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        np.testing.assert_allclose(got["eval_loss"], want["eval_loss"], rtol=2e-4)
    from tpu_air.train import Checkpoint as JCheckpoint

    jc = JCheckpoint.from_directory(jbest)
    jstats = _tree_map(np.asarray, jc._load_extras()["batch_stats"])
    want = _flat(params_from_jax(_tree_map(np.asarray, jc.get_params()), jstats, PCFG))
    got = _flat(result.checkpoint.get_params())
    _check_params(got, want, steps=8)
    _check_stats(got, want, steps=8, var_atol=1e-5)


def test_checkpoint_is_in_the_jax_layout_with_stats_and_feature_extractor(w6_runs):
    result = w6_runs[0]
    ckpt = result.checkpoint
    assert ckpt.get_metrics()["loss"] == min(m["loss"] for m in result.metrics_history)
    extras = ckpt._load_extras()
    assert set(extras) == {"batch_stats", "feature_extractor"}
    assert extras["feature_extractor"].size == (SIZE, SIZE)
    assert set(extras["batch_stats"]["decode_head"]["batch_norm"]) == {"mean", "var"}
    import json
    import os

    with open(os.path.join(ckpt.path, "kind.json")) as f:
        assert json.load(f)["kind"] == "jax_model"
    assert isinstance(ckpt.get_model_config(), P.SegformerConfig)


def test_resume_and_tune_style_overrides(jax_vars, tmp_path):
    """Training resumed from a port checkpoint of the weights equals training
    from ``pretrained_variables`` given as the port's state dict or as the
    JAX package's Flax variables; Tune-style keys of ``trainer_init_config``
    (``epochs``, ``learning_rate``) override the TrainingArguments."""
    rows = _preprocess(_ade_like(4, 5))
    args = TrainingArguments(learning_rate=1.0, num_train_epochs=5, weight_decay=0.0,
                             per_device_train_batch_size=2, evaluation_strategy="no")
    tune = {"epochs": 1, "learning_rate": LR}
    start = Checkpoint.from_model(model_config=PCFG, params=_port_sd(jax_vars),
                                  path=str(tmp_path / "start"))
    losses = []
    for kw in ({"pretrained_variables": jax_vars},
               {"pretrained_variables": _port_sd(jax_vars)},
               {"resume_from_checkpoint": start}):
        result = SegformerTrainer(
            model_config=PCFG, training_args=args, trainer_init_config=tune,
            datasets={"train": rows}, run_config=RunConfig(storage_path=str(tmp_path)),
            device="cpu", **kw).fit()
        assert result.error is None, result.error
        assert len(result.metrics_history) == 1 and "eval_loss" not in result.metrics
        losses.append(result.metrics["loss"])
    assert losses[0] == losses[1] == losses[2]
    fresh = SegformerTrainer(model_config=PCFG, training_args=args, trainer_init_config=tune,
                             datasets={"train": rows},
                             run_config=RunConfig(storage_path=str(tmp_path)),
                             device="cpu").fit()
    assert fresh.error is None and np.isfinite(fresh.metrics["loss"])
    assert fresh.metrics["loss"] != losses[0]      # numpy-seeded init, not the given weights


# -- data parallelism: cross-replica batch norm ----------------------------------


def test_two_workers_match_one_with_cross_replica_batch_norm(jax_vars, tmp_path):
    """``num_workers=2`` (two spawned processes over gloo), each taking its
    half of a global batch of 4 whose halves differ in their statistics:
    two steps' losses, parameters and batch-norm stats equal one worker's on
    the same global batch.  A per-replica batch norm fails this: the stats of
    either half alone are far from the global batch's (checked below)."""
    raw = _ade_like(4, 6)
    raw.loc[2:, "image"] = [np.clip(im.astype(np.int32) + 90, 0, 255).astype(np.uint8)
                            for im in raw["image"][2:]]
    rows = _preprocess(raw)
    args = dict(learning_rate=LR, num_train_epochs=2, evaluation_strategy="no",
                max_grad_norm=1.0, weight_decay=0.01)
    runs = {}
    for workers in (2, 1):
        result = SegformerTrainer(
            model_config=PCFG,
            training_args=TrainingArguments(per_device_train_batch_size=4 // workers, **args),
            pretrained_variables=_port_sd(jax_vars), datasets={"train": rows},
            scaling_config=ScalingConfig(num_workers=workers),
            run_config=RunConfig(storage_path=str(tmp_path / f"w{workers}")), device="cpu",
        ).fit()
        assert result.error is None, result.error
        assert [m["steps"] for m in result.metrics_history] == [1, 1]
        runs[workers] = ([m["loss"] for m in result.metrics_history],
                         _flat(result.checkpoint.get_params()))
    (l2, p2), (l1, p1) = runs[2], runs[1]
    np.testing.assert_allclose(l2, l1, rtol=1e-6)
    _check_params(p2, p1, steps=2)
    _check_stats(p2, p1, steps=2, var_atol=1e-6)
    names = ("decode_head.batch_norm.running_mean", "decode_head.batch_norm.running_var")

    # what a per-replica batch norm would have kept: rank 0's half alone
    model = P.SegformerForSemanticSegmentation(PCFG, device="cpu")
    model.load_state_dict(_port_sd(jax_vars))
    model.train()
    px = torch.from_numpy(np.stack(rows["pixel_values"][:2]).astype(np.float32))
    with torch.no_grad():
        model(px)
    start = _flat(_port_sd(jax_vars))
    half = _flat(model.state_dict())
    moved = np.abs(p1[names[0]] - start[names[0]]).max()
    assert np.abs(half[names[0]] - p1[names[0]]).max() > 0.1 * moved


# -- prediction and checkpoints across the packages ---------------------------------


def _images(n, seed):
    rng = np.random.default_rng(seed)
    sizes = [(40, 48), (37, 52), (48, 40)]
    return [rng.integers(0, 256, size=(*sizes[i % 3], 3)).astype(np.uint8) for i in range(n)]


def _pixels(images, fe):
    """One ``pixel_values`` column for both packages' predictors, so that
    their masks differ only by the forward and the post-processing resize."""
    return pd.DataFrame({"pixel_values": list(fe(images)["pixel_values"])})


def _assert_masks_agree(got, want, model, px):
    """Equal masks, except where the top two of the port's upsampled logits
    lie within 5e-4: each logit of the two forwards may differ by the 2e-4
    of tests/test_torch_segformer.py, and the two resizes by 3.2e-5."""
    from tpu_air_torch.models.segformer.image_processor import _resize

    with torch.no_grad():
        logits = model(torch.from_numpy(np.stack(px["pixel_values"]))).numpy()
    for g, w, lg, x in zip(got, want, logits, px["pixel_values"]):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape == x.shape[:2]
        up = np.sort(_resize(lg, *x.shape[:2], nearest=False), axis=-1)
        assert ((g == w) | (up[..., -1] - up[..., -2] < 5e-4)).all()
        assert (g == w).mean() > 0.99


def test_jax_checkpoint_with_a_pickled_feature_extractor_predicts_in_the_port(jax_vars,
                                                                               tmp_path):
    """A checkpoint the JAX package writes (its image processor pickled in
    the extras) loads into the port's predictor: the extras' processor comes
    back as the port's copy, raw images give masks of their own sizes, and
    the masks equal the JAX predictor's on the same pixels."""
    from tpu_air.models.segformer.image_processor import SegformerImageProcessor as JProc
    from tpu_air.predict import SemanticSegmentationPredictor as JPredictor
    from tpu_air.train import Checkpoint as JCheckpoint

    path = str(tmp_path / "jax")
    JCheckpoint.from_model(model_config=JCFG, params=jax_vars["params"], path=path, extras={
        "batch_stats": jax_vars["batch_stats"], "feature_extractor": JProc(size=SIZE)})
    images = _images(5, 7)
    pred = SemanticSegmentationPredictor.from_checkpoint(Checkpoint.from_directory(path),
                                                         device="cpu")
    assert type(pred.feature_extractor).__module__ == \
        "tpu_air_torch.models.segformer.image_processor"
    assert pred.feature_extractor.size == (SIZE, SIZE)
    masks = pred.predict(pd.DataFrame({"image": images}))["predicted_mask"]
    assert [np.asarray(m).shape for m in masks] == [im.shape[:2] for im in images]
    px = _pixels(images, pred.feature_extractor)
    want = JPredictor.from_checkpoint(JCheckpoint.from_directory(path)).predict(px)
    _assert_masks_agree(pred.predict(px)["predicted_mask"], want["predicted_mask"],
                        pred.model, px)


def test_port_checkpoint_predicts_in_the_jax_package(w6_runs):
    from tpu_air.predict import SemanticSegmentationPredictor as JPredictor
    from tpu_air.train import Checkpoint as JCheckpoint

    ckpt = w6_runs[0].checkpoint
    images = _images(4, 8)
    pred = SemanticSegmentationPredictor.from_checkpoint(ckpt, device="cpu")
    jpred = JPredictor.from_checkpoint(JCheckpoint.from_directory(ckpt.path))
    assert jpred.batch_stats
    px = _pixels(images, pred.feature_extractor)
    got = pred.predict(px)
    _assert_masks_agree(got["predicted_mask"], jpred.predict(px)["predicted_mask"],
                        pred.model, px)
    # a torch-format checkpoint of the same model predicts the same masks
    again = Checkpoint.from_model(model_config=PCFG, params=pred.model.state_dict())
    same = SemanticSegmentationPredictor.from_checkpoint(
        again, device="cpu", feature_extractor=pred.feature_extractor).predict(px)
    for a, b in zip(same["predicted_mask"], got["predicted_mask"]):
        np.testing.assert_array_equal(a, b)


def test_torch_predictor_applies_a_function_of_the_state_dict(jax_vars, tmp_path):
    ckpt = Checkpoint.from_model(model_config=PCFG, params=_port_sd(jax_vars),
                                 path=str(tmp_path / "c"))

    def apply_fn(params, x):
        return x.float() @ params["decode_head.classifier.bias"][:1]

    out = TorchPredictor.from_checkpoint(ckpt, apply_fn=apply_fn, device="cpu").predict(
        {"x": np.ones((3, 1), np.float32)})
    bias = float(_port_sd(jax_vars)["decode_head.classifier.bias"][0])
    np.testing.assert_allclose(out["predictions"].to_numpy(), [bias] * 3, rtol=1e-6)


@pytest.fixture(scope="module")
def tair():
    tpu_air_torch.init(num_cpus=2, num_chips=1)
    yield tpu_air_torch
    tpu_air_torch.shutdown()


def test_batch_predictor_over_the_runtime_gives_the_in_process_masks(tair, jax_vars,
                                                                      tmp_path):
    ckpt = Checkpoint.from_model(model_config=PCFG, params=_port_sd(jax_vars), format="jax",
                                 path=str(tmp_path / "c"))
    images = _images(6, 9)
    fe = P.SegformerImageProcessor(size=SIZE)
    want = SemanticSegmentationPredictor.from_checkpoint(ckpt, device="cpu",
                                                         feature_extractor=fe).predict(
        pd.DataFrame({"image": images}))["predicted_mask"]
    bp = BatchPredictor.from_checkpoint(ckpt, SemanticSegmentationPredictor, device="cpu",
                                        feature_extractor=fe)
    ds = tdata.from_items([{"image": im, "idx": i} for i, im in enumerate(images)])
    out = bp.predict(ds, batch_size=3, num_gpus_per_worker=1,
                     keep_columns=["idx"]).to_pandas().sort_values("idx")
    assert out["idx"].tolist() == list(range(6))
    for a, b in zip(out["predicted_mask"], want):
        np.testing.assert_array_equal(np.asarray(a), b)


# -- what the port refuses -----------------------------------------------------------


@pytest.mark.parametrize("what", ["model_parallel", "sequence_parallel",
                                  "workers_beyond_the_cards", "use_gpu_on_cpu",
                                  "no_train_dataset", "stats_missing_from_a_jax_checkpoint"])
def test_segformer_paths_not_ported_are_refused(what, jax_vars, tmp_path, monkeypatch):
    """N workers on CUDA with fewer than N cards raise before any starts; a
    ``use_gpu`` that disagrees with the device raises; a JAX checkpoint
    whose extras lack the batch norm's stats is refused, naming them.  A
    tensor or sequence degree, which this test once refused, gives a worker
    that many devices, which it trains data-parallel as the JAX loop does."""
    if what == "use_gpu_on_cpu":
        with pytest.raises(ValueError, match="use_gpu"):
            SegformerTrainer(model_config=PCFG, scaling_config=ScalingConfig(use_gpu=True),
                             device="cpu")
        assert SegformerTrainer(model_config=PCFG, scaling_config=ScalingConfig(
            use_gpu=False)).device.type == "cpu"
        return
    if what == "stats_missing_from_a_jax_checkpoint":
        path = str(tmp_path / "c")
        Checkpoint.from_model(model_config=PCFG, params=_port_sd(jax_vars), format="jax",
                              path=path)
        import os

        os.remove(os.path.join(path, "extras.pkl"))
        with pytest.raises(ValueError, match="batch_stats"):
            Checkpoint.from_directory(path).get_params()
        return
    kw = dict(model_config=PCFG, pretrained_variables=_port_sd(jax_vars),
              training_args=TrainingArguments(num_train_epochs=1, per_device_train_batch_size=2),
              datasets={"train": _preprocess(_ade_like(2, 10))},
              run_config=RunConfig(storage_path=str(tmp_path)))
    if what == "workers_beyond_the_cards":
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
        with pytest.raises(ValueError, match="needs 2 cards"):
            SegformerTrainer(scaling_config=ScalingConfig(num_workers=2), device="cuda",
                             **kw).fit()
        return
    if what == "no_train_dataset":
        kw["datasets"] = {"evaluation": kw["datasets"]["train"]}
        result = SegformerTrainer(device="cpu", **kw).fit()
        assert "requires a 'train' dataset" in str(result.error)
        return
    # SegFormer has no model or sequence axis: either degree is a worker over
    # 2 devices, a data replica on each, one row each
    kw["training_args"] = TrainingArguments(num_train_epochs=1, per_device_train_batch_size=1)
    result = SegformerTrainer(scaling_config=ScalingConfig(**{what: 2}), device="cpu",
                              **kw).fit()
    assert result.error is None, result.error
    assert result.metrics["steps"] == 1 and np.isfinite(result.metrics["loss"])

