"""The port's W1 slice (FLAN-T5 fine-tuning) on the CPU against the JAX
package's.

The same weights (a Flax init of ``T5Config.tiny()`` carried across by
``params_from_jax``) and the same rows, made from numpy seeds, go through
the JAX package's T5 step and ``t5_train_loop`` (run in this process on one
or two of conftest's host devices) and through the port's model,
``_make_optimizer`` and ``T5Trainer(device="cpu").fit()``, where attention
takes the kernels' plain versions.  Tolerances: f32 losses 1e-5 relative,
f32 parameters 1e-5 absolute; one bf16 step, loss 2e-2 relative and
parameters 1e-3 absolute (bf16 keeps 8 bits of mantissa); Adafactor 1e-6
relative against optax; two worker processes against one, 1e-6.
"""

import dataclasses

import numpy as np
import pandas as pd
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

from tpu_air.models.t5 import T5Config as JConfig  # noqa: E402
from tpu_air.models.t5 import T5ForConditionalGeneration as JT5  # noqa: E402
from tpu_air.models.t5 import cross_entropy_loss as jce  # noqa: E402
from tpu_air.models.t5 import generate as jgenerate  # noqa: E402
from tpu_air.models.t5 import shift_right as jshift  # noqa: E402
from tpu_air.train import t5_trainer as jtrain  # noqa: E402
from tpu_air_torch.data.preprocessors import BatchMapper  # noqa: E402
from tpu_air_torch.models.t5 import modeling as tmodeling  # noqa: E402
from tpu_air_torch.models.t5.config import T5Config  # noqa: E402
from tpu_air_torch.models.t5.convert import jax_layouts, params_from_jax  # noqa: E402
from tpu_air_torch.models.t5.generate import generate  # noqa: E402
from tpu_air_torch.models.t5.modeling import T5ForConditionalGeneration  # noqa: E402
from tpu_air_torch.models.tokenizer import ByteTokenizer  # noqa: E402
from tpu_air_torch.ops import flash_attention as tflash  # noqa: E402
from tpu_air_torch.predict.predictors import T5GenerativePredictor  # noqa: E402
from tpu_air_torch.train import (  # noqa: E402
    CheckpointConfig,
    RunConfig,
    ScalingConfig,
    T5Trainer,
    TrainingArguments,
)
from tpu_air_torch.train import t5_trainer as ttrain  # noqa: E402

SEQ = 16          # source and label length of every row
VOCAB = 384       # T5Config.tiny's


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: one torch thread (and one per worker process), so these
    tests add little CPU load beside the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_params():
    """A Flax init of the tiny T5, as numpy leaves."""
    enc = jnp.ones((2, 8), jnp.int32)
    params = JT5(JConfig.tiny()).init(jax.random.PRNGKey(0), enc, jnp.ones_like(enc),
                                      jnp.ones((2, 6), jnp.int32))["params"]
    return jax.tree_util.tree_map(np.asarray, params)


def _port_params(jax_params):
    return params_from_jax(jax_params, T5Config.tiny())


def _rows(n, seed, src_lens=None, label_lens=None):
    """Pre-tokenized rows: ragged source lengths and mostly-pad labels."""
    rng = np.random.default_rng(seed)
    src = rng.integers(3, SEQ + 1, n) if src_lens is None else np.asarray(src_lens)
    lab = rng.integers(2, SEQ // 2, n) if label_lens is None else np.asarray(label_lens)
    pos = np.arange(SEQ)[None]
    mask = (pos < src[:, None]).astype(np.int32)
    ids = rng.integers(2, VOCAB, (n, SEQ)).astype(np.int32) * mask
    labels = rng.integers(2, VOCAB, (n, SEQ)).astype(np.int32) * (pos < lab[:, None])
    return pd.DataFrame({"input_ids": list(ids), "attention_mask": list(mask),
                         "labels": list(labels)})


def _batch(df):
    return {k: np.stack(df[k].to_list()) for k in ("input_ids", "attention_mask", "labels")}


def _flat(params):
    return {k: v.detach().float().numpy() for k, v in params.items()}


def _max_param_diff(got, want):
    return max(float(np.abs(got[k] - want[k]).max()) for k in want)


# -- (a) f32 parameters under bf16 compute, and one step against JAX ----------


def test_bf16_model_holds_f32_parameters_and_casts_per_call():
    """A bf16 config computes in bf16 on f32 parameters (the JAX package's
    ``nn.Dense(dtype=...)``); cast once at load, the per-call cast is a
    no-op that returns the weight itself."""
    cfg = dataclasses.replace(T5Config.tiny(), dtype="bfloat16")
    model = T5ForConditionalGeneration(cfg, device="cpu").init_weights(0)
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    ids = torch.from_numpy(_batch(_rows(2, 0))["input_ids"]).long()
    with torch.no_grad():
        logits = model(ids, (ids != 0).long(), ids[:, :5])
        assert logits.dtype == torch.bfloat16
        assert model.encode(ids, (ids != 0).long()).dtype == torch.bfloat16
    model.to(torch.bfloat16)
    w = model.shared.weight
    q = model.encoder.layers[0].self_attn.q
    assert q.weight.to(q.compute_dtype) is q.weight and w.to(torch.bfloat16) is w


def _jax_step(jax_params, cfg, args, batch):
    """One step of the JAX package's T5 loss and optax chain."""
    model = JT5(cfg)
    tx = jtrain._make_optimizer(jtrain.TrainingArguments(**vars(args)), 1)
    params = jax.tree_util.tree_map(jnp.asarray, jax_params)
    labels = jnp.asarray(batch["labels"])
    dec_in = jshift(labels, cfg.decoder_start_token_id, cfg.pad_token_id)
    dec_mask = (dec_in != cfg.pad_token_id).astype(jnp.int32).at[:, 0].set(1)

    def lf(p):
        logits = model.apply({"params": p}, jnp.asarray(batch["input_ids"]),
                             jnp.asarray(batch["attention_mask"]), dec_in,
                             decoder_attention_mask=dec_mask)
        return jce(logits, labels, cfg.pad_token_id)[0]

    loss, grads = jax.value_and_grad(lf)(params)
    updates, _ = tx.update(grads, tx.init(params), params)
    new = optax.apply_updates(params, updates)
    return float(loss), _flat(params_from_jax(jax.tree_util.tree_map(np.asarray, new), cfg))


def _port_step(model, args, batch):
    """One step of the port's T5 train step (one worker, dropout 0)."""
    opt = ttrain._make_optimizer(args, 1, model.parameters())
    model.train()
    step = ttrain.make_t5_train_step(model, opt)
    loss = step({k: torch.from_numpy(v).long() for k, v in batch.items()})
    return float(loss), _flat(dict(model.named_parameters()))


@pytest.mark.parametrize("dtype, lr, loss_rtol, param_atol", [
    ("float32", 1e-5, 1e-5, 1e-5), ("bfloat16", 1e-4, 2e-2, 1e-3)])
def test_one_adamw_step_matches_jax_train_step(jax_params, dtype, lr, loss_rtol, param_atol):
    """One AdamW step (clipping and weight decay on) from shared weights
    moves the port's f32 parameters as the JAX step moves its own.

    AdamW's first step is lr * g / (|g| + 1e-8) per element: where a
    gradient nearly cancels, to within f32 rounding, the two packages' steps
    of that element differ by up to a whole step, so in f32 the step is 1e-5
    and the bound 1e-5; all but a thousandth of the elements must agree to
    3% of a step (f32's resolution at 1.0 is 1.2% of it).  In bf16 the parameters the port held before this slice
    (cast to bf16 with the model) miss the JAX step by more than the bound:
    bf16 cannot hold a 1e-4 step on an O(1) weight."""
    jcfg = dataclasses.replace(JConfig.tiny(), dtype=dtype)
    cfg = T5Config.from_dict(jcfg.to_dict())
    args = TrainingArguments(learning_rate=lr, weight_decay=0.01, max_grad_norm=1.0)
    batch = _batch(_rows(3, 1))
    want_loss, want = _jax_step(jax_params, jcfg, args, batch)

    model = T5ForConditionalGeneration(cfg, device="cpu")
    model.load_state_dict(_port_params(jax_params))
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    got_loss, got = _port_step(model, args, batch)
    np.testing.assert_allclose(got_loss, want_loss, rtol=loss_rtol)
    assert _max_param_diff(got, want) < param_atol, _max_param_diff(got, want)
    start = _flat(_port_params(jax_params))
    moved = np.concatenate([np.abs(want[k] - start[k]).ravel() for k in want])
    assert np.median(moved) > 0.5 * lr        # the step is not lost in the bound
    if dtype == "float32":
        diffs = np.concatenate([np.abs(got[k] - want[k]).ravel() for k in want])
        assert np.quantile(diffs, 0.999) < 0.03 * lr, np.quantile(diffs, 0.999)
    else:                       # the fault this slice repairs
        old = T5ForConditionalGeneration(cfg, device="cpu")
        old.load_state_dict(_port_params(jax_params))
        old.to(torch.bfloat16)
        _, old_params = _port_step(old, args, batch)
        assert _max_param_diff(old_params, want) > param_atol


# -- (b) Adafactor against optax ----------------------------------------------


@pytest.mark.parametrize("grad_scale", [1e-3, 10.0])
def test_adafactor_matches_optax(grad_scale):
    """Five updates of the port's Adafactor against the JAX package's chain
    (clip_by_global_norm, then optax.adafactor with a warmup and linear
    schedule): a factored (>= 128 x >= 128) matrix, an unfactored matrix and
    vector, and a weight whose JAX kernel is 3-D ([128, 2, 64], the layout
    of T5's q projection: unfactored there though its torch weight is
    128 x 128).  ``grad_scale`` 10 also clips the global norm and the
    update's RMS."""
    rng = np.random.default_rng(5)
    jshapes = {"fact": (256, 160), "small": (64, 3), "vec": (200,), "q": (128, 2, 64)}
    p0 = {k: rng.standard_normal(s).astype(np.float32) * 0.05 for k, s in jshapes.items()}
    grads = [{k: (rng.standard_normal(s) * grad_scale).astype(np.float32)
              for k, s in jshapes.items()} for _ in range(5)]
    args = TrainingArguments(learning_rate=1e-2, warmup_steps=2, lr_scheduler_type="linear",
                             max_grad_norm=1.0, optimizer="adafactor")
    tx = jtrain._make_optimizer(jtrain.TrainingArguments(**vars(args)), 6)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(jp)

    def to_port(k, x):          # the port holds the q kernel as a torch Linear weight
        return (x.reshape(128, 128).T if k == "q" else x.T if k == "fact" else x).copy()

    params = {k: torch.nn.Parameter(torch.from_numpy(to_port(k, v))) for k, v in p0.items()}
    layouts = [(True, jshapes["fact"]), None, None, (True, jshapes["q"])]
    opt = ttrain._make_optimizer(args, 6, params.values(), layouts)
    for g in grads:
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in params.items():
            p.grad = torch.from_numpy(to_port(k, g[k]))
        opt.step()
    for k, p in params.items():
        want = to_port(k, np.asarray(jp[k]))
        moved = np.abs(want - to_port(k, p0[k])).max()
        assert moved > 1e-4, (k, moved)     # the updates are not vanishingly small
        np.testing.assert_allclose(p.detach().numpy(), want, rtol=1e-6, atol=1e-6 * moved)


def test_t5_layouts_cover_every_parameter_in_the_jax_shapes(jax_params):
    """``jax_layouts`` names every parameter of the port's T5 with the
    shape of the JAX kernel ``params_from_jax`` maps onto it."""
    cfg = T5Config.tiny()
    sd = _port_params(jax_params)
    layouts = jax_layouts(cfg)
    assert set(layouts) == set(T5ForConditionalGeneration(cfg, device="cpu").state_dict())
    leaves = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(x)
              for path, x in jax.tree_util.tree_flatten_with_path(jax_params)[0]}
    q = leaves["encoder/layer_0/self_attn/q/kernel"]
    assert layouts["encoder.layers.0.self_attn.q.weight"] == (True, q.shape)
    np.testing.assert_array_equal(sd["encoder.layers.0.self_attn.q.weight"].numpy().T.reshape(q.shape), q)
    o = leaves["decoder/layer_1/cross_attn/o/kernel"]
    assert layouts["decoder.layers.1.cross_attn.o.weight"] == (True, o.shape)
    np.testing.assert_array_equal(sd["decoder.layers.1.cross_attn.o.weight"].numpy().T.reshape(o.shape), o)
    for name, (_, shape) in layouts.items():
        assert int(np.prod(shape)) == sd[name].numel(), name


# -- (c) T5Trainer.fit against the JAX package's t5_train_loop ---------------

TEXTS = ["repeat the word alpha", "sum two and three", "name a colour", "count to four",
         "say hello", "spell cat", "one more row"]
ANSWERS = ["alpha", "five", "red", "1 2 3 4", "hello", "c a t", "row"]


def tokenize(df: pd.DataFrame) -> pd.DataFrame:
    """The W1 preprocessor's shape: sources and labels padded to max_length."""
    tok = ByteTokenizer(model_max_length=SEQ)
    enc = tok(list(df["instruction"]), max_length=SEQ, padding="max_length", truncation=True,
              return_tensors="np")
    lab = tok(list(df["output"]), max_length=SEQ, padding="max_length", truncation=True,
              return_tensors="np")
    return pd.DataFrame({"input_ids": list(enc["input_ids"]),
                         "attention_mask": list(enc["attention_mask"]),
                         "labels": list(lab["input_ids"])})


def _jax_fit(monkeypatch, run_dir, chips, datasets, args, jax_params, checkpoint_config=None):
    """The JAX package's ``t5_train_loop`` in this process, on the host
    devices ``chips`` names, from ``jax_params``: (history, best checkpoint)."""
    from tpu_air.train import session as jsession
    from tpu_air.train.config import CheckpointConfig as JCheckpointConfig
    from tpu_air.train.trainer import _BroadcastDataset

    monkeypatch.setenv("TPU_AIR_CHIP_IDS", chips)
    sess = jsession.Session(
        run_dir=run_dir, checkpoint_config=JCheckpointConfig(**vars(checkpoint_config or
                                                                   CheckpointConfig())),
        datasets={k: _BroadcastDataset(v) for k, v in datasets.items()})
    jsession._set_active(sess)
    try:
        jtrain.t5_train_loop({
            "model_config": JConfig.tiny(),
            "training_args": jtrain.TrainingArguments(**vars(args)),
            "pretrained_params": jax.tree_util.tree_map(jnp.asarray, jax_params)})
    finally:
        jsession._set_active(None)
    return sess.history, sess.best_checkpoint()


BEST = CheckpointConfig(num_to_keep=1, checkpoint_score_attribute="eval_loss",
                        checkpoint_score_order="min")


@pytest.fixture(scope="module")
def w1_runs(jax_params, tmp_path_factory):
    """Two epochs of W1 at test dials through the port's ``T5Trainer`` (text
    rows, a tokenizing ``BatchMapper`` and a tokenizer) and through the JAX
    loop on the same pre-tokenized rows, from the same weights."""
    tmp = tmp_path_factory.mktemp("w1")
    train = pd.DataFrame({"instruction": TEXTS[:4], "output": ANSWERS[:4]})
    evaluation = pd.DataFrame({"instruction": TEXTS[4:], "output": ANSWERS[4:]})
    args = TrainingArguments(learning_rate=1e-3, per_device_train_batch_size=2,
                             num_train_epochs=2, warmup_steps=1, lr_scheduler_type="linear",
                             weight_decay=0.01, max_grad_norm=1.0, seed=3)
    result = T5Trainer(
        model_config=T5Config.tiny(), training_args=args,
        tokenizer=ByteTokenizer(model_max_length=SEQ),
        pretrained_params=_port_params(jax_params),
        datasets={"train": train, "evaluation": evaluation},
        preprocessor=BatchMapper(tokenize, batch_format="pandas"),
        run_config=RunConfig(storage_path=str(tmp), checkpoint_config=BEST),
        device="cpu",
    ).fit()
    with pytest.MonkeyPatch.context() as mp:
        jhist, jbest = _jax_fit(mp, str(tmp / "jax"), "0",
                                {"train": tokenize(train), "evaluation": tokenize(evaluation)},
                                args, jax_params, BEST)
    return result, jhist, jbest, evaluation


def test_t5_trainer_reports_the_jax_loops_metrics(w1_runs):
    result, jhist, _, _ = w1_runs
    assert result.error is None
    assert len(result.metrics_history) == len(jhist) == 2
    for got, want in zip(result.metrics_history, jhist):
        assert set(got) == set(want)
        for key in ("epoch", "steps", "mesh_data", "mesh_model", "mesh_num_hosts",
                    "params_bytes_total", "params_bytes_per_device"):
            assert got[key] == want[key], key


def test_t5_trainer_losses_match_the_jax_loop(w1_runs):
    """Epoch losses (two steps each: warmup, then linear decay) and the
    token-weighted eval loss over a padded last batch, to 1e-5."""
    result, jhist, _, _ = w1_runs
    for key in ("loss", "eval_loss"):
        got = [m[key] for m in result.metrics_history]
        want = [m[key] for m in jhist]
        np.testing.assert_allclose(got, want, rtol=1e-5)
    assert result.metrics_history[1]["loss"] < result.metrics_history[0]["loss"]


def test_best_checkpoint_is_the_min_eval_loss(w1_runs):
    result, jhist, jbest, _ = w1_runs
    evals = [m["eval_loss"] for m in result.metrics_history]
    assert result.checkpoint.get_metrics()["eval_loss"] == min(evals)
    assert len(result.best_checkpoints) == 1
    assert result.checkpoint.get_metrics()["epoch"] == jbest[1]["epoch"]


def test_from_checkpoint_generates_the_jax_tokens(w1_runs):
    """The best checkpoint carries the tokenizer and the fitted
    ``BatchMapper``: ``from_checkpoint`` predicts from raw text, and its
    greedy tokens equal the JAX ``generate`` from the JAX loop's best
    parameters."""
    from tpu_air.train import Checkpoint as JCheckpoint

    result, _, jbest, evaluation = w1_runs
    pred = T5GenerativePredictor.from_checkpoint(result.checkpoint, dtype="float32",
                                                 device="cpu", tokenizer=ByteTokenizer)
    assert isinstance(pred.get_preprocessor(), BatchMapper)
    assert pred.tokenizer.model_max_length == SEQ
    assert isinstance(result.checkpoint.get_tokenizer(), ByteTokenizer)
    batch = _batch(tokenize(evaluation))
    got = generate(pred.model, batch["input_ids"], batch["attention_mask"],
                   max_new_tokens=6).numpy()
    jparams = JCheckpoint.from_directory(jbest[0]).get_params()
    want = np.asarray(jgenerate(JT5(JConfig.tiny()), jparams, batch["input_ids"],
                                batch["attention_mask"], max_new_tokens=6))
    np.testing.assert_array_equal(got, want)
    texts = pred.predict(evaluation, max_new_tokens=6)["generated_output"]
    assert list(texts) == ByteTokenizer().batch_decode(want)


def test_from_checkpoint_casts_to_bf16_once_at_load(w1_runs):
    result = w1_runs[0]
    pred = T5GenerativePredictor.from_checkpoint(result.checkpoint, device="cpu",
                                                 tokenizer=ByteTokenizer(SEQ))
    assert pred.model.config.dtype == "bfloat16"
    assert {p.dtype for p in pred.model.parameters()} == {torch.bfloat16}
    assert {v.dtype for v in result.checkpoint.get_params().values()} == {torch.float32}
    assert {v.dtype for v in result.checkpoint.get_params("bfloat16").values()} == \
        {torch.bfloat16}
    out = pred.predict(w1_runs[3], max_new_tokens=4)
    assert len(out) == len(w1_runs[3])


@pytest.mark.parametrize("pad_id", [0, 1])
def test_partial_eval_batch_is_topped_up_with_masked_pad_rows(pad_id):
    """The rows that fill a short last eval batch hold pad ids and pad
    labels under an attention mask of 0, whatever the pad id."""
    batch = {k: np.where(v == 0, pad_id, v) if k != "attention_mask" else v
             for k, v in _batch(_rows(3, 9)).items()}
    got = ttrain._pad_rows(batch, 5, pad_id)
    for k, v in batch.items():
        assert got[k].shape == (5, SEQ) and got[k].dtype == v.dtype
        np.testing.assert_array_equal(got[k][:3], v)
    assert (got["attention_mask"][3:] == 0).all()
    assert (got["input_ids"][3:] == pad_id).all() and (got["labels"][3:] == pad_id).all()


def test_eval_loss_over_a_partial_last_batch_is_token_weighted(jax_params, tmp_path):
    """Five eval rows in batches of 2 (the last one padded) give the eval
    loss of one batch of 5: the loss is weighted by tokens, and the pad
    rows add none."""
    losses = []
    for ebs in (2, 5):
        result = T5Trainer(
            model_config=T5Config.tiny(), datasets={"train": _rows(2, 10),
                                                    "evaluation": _rows(5, 11)},
            training_args=TrainingArguments(num_train_epochs=1, learning_rate=1e-3,
                                            per_device_train_batch_size=2,
                                            per_device_eval_batch_size=ebs),
            pretrained_params=_port_params(jax_params),
            run_config=RunConfig(storage_path=str(tmp_path / f"e{ebs}")), device="cpu",
        ).fit()
        assert result.error is None, result.error
        losses.append(result.metrics["eval_loss"])
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-6)


# -- (d) data parallelism over two worker processes ---------------------------


def test_two_workers_match_one_and_the_jax_dp2_step(jax_params, tmp_path, monkeypatch):
    """``num_workers=2`` (two spawned processes over gloo), each taking its
    contiguous half of the global batch, whose halves hold 5 and 14 label
    tokens: two steps' losses and parameters equal one worker's on the same
    global batch and the JAX loop's on a two-device ``data`` mesh."""
    rows = _rows(4, 7, label_lens=[2, 3, 7, 7])
    args = dict(learning_rate=1e-4, num_train_epochs=2, evaluation_strategy="no",
                max_grad_norm=1.0, weight_decay=0.01)
    runs = {}
    for workers in (2, 1):
        result = T5Trainer(
            model_config=T5Config.tiny(),
            training_args=TrainingArguments(per_device_train_batch_size=4 // workers, **args),
            pretrained_params=_port_params(jax_params), datasets={"train": rows},
            scaling_config=ScalingConfig(num_workers=workers),
            run_config=RunConfig(storage_path=str(tmp_path / f"w{workers}")), device="cpu",
        ).fit()
        assert result.error is None, result.error
        assert [m["steps"] for m in result.metrics_history] == [1, 1]
        assert result.metrics["mesh_data"] == workers
        runs[workers] = ([m["loss"] for m in result.metrics_history],
                         _flat(result.checkpoint.get_params()))
    jhist, jbest = _jax_fit(monkeypatch, str(tmp_path / "jax"), "0,1", {"train": rows},
                            TrainingArguments(per_device_train_batch_size=2, **args),
                            jax_params)
    assert jhist[0]["mesh_data"] == 2
    from tpu_air.train import Checkpoint as JCheckpoint

    jparams = _flat(params_from_jax(
        jax.tree_util.tree_map(np.asarray, JCheckpoint.from_directory(jbest[0]).get_params()),
        T5Config.tiny()))
    (l2, p2), (l1, p1) = runs[2], runs[1]
    np.testing.assert_allclose(l2, l1, rtol=1e-6)
    np.testing.assert_allclose(l2, [m["loss"] for m in jhist], rtol=1e-5)
    # AdamW's step is lr * g / (|g| + 1e-8): where a gradient nearly
    # cancels, its element moves by the rounding of that cancellation, so the
    # step is 1e-4 against bounds of 1e-6 and 1e-5
    start = _flat(_port_params(jax_params))
    moved = np.concatenate([np.abs(p2[k] - start[k]).ravel() for k in start])
    assert np.median(moved) > 1e-4
    assert _max_param_diff(p2, p1) < 1e-6, _max_param_diff(p2, p1)
    assert _max_param_diff(p2, jparams) < 1e-5, _max_param_diff(p2, jparams)


# -- (e) dropout ------------------------------------------------------------


def _dropout_fit(jax_params, tmp_path, seed):
    cfg = dataclasses.replace(T5Config.tiny(), dropout_rate=0.1)
    result = T5Trainer(
        model_config=cfg, pretrained_params=_port_params(jax_params),
        training_args=TrainingArguments(per_device_train_batch_size=2, num_train_epochs=1,
                                        evaluation_strategy="no", save_strategy="no",
                                        seed=seed),
        datasets={"train": _rows(2, 9)},
        run_config=RunConfig(storage_path=str(tmp_path)), device="cpu").fit()
    assert result.error is None, result.error
    return result.metrics["loss"]


def test_dropout_masks_follow_the_seed(jax_params, tmp_path):
    """From the same weights, the same seed gives the same loss twice and
    another seed another loss: the masks come from the loop's seeded
    generator, not from torch's global one."""
    first = _dropout_fit(jax_params, tmp_path, 3)
    torch.manual_seed(123)                  # the global generator plays no part
    assert _dropout_fit(jax_params, tmp_path, 3) == first
    assert _dropout_fit(jax_params, tmp_path, 4) != first


@pytest.mark.parametrize("rate, train, flash_calls", [
    (0.1, True, 0), (0.1, False, 6), (0.0, True, 6)])
def test_active_dropout_takes_the_dense_path(jax_params, monkeypatch, rate, train,
                                             flash_calls):
    """With dropout active (``train()`` and a rate above 0) every attention
    call of the tiny T5 (2 encoder self, 2 decoder self, 2 cross) takes the
    dense path and no flash launch is counted; without, all six go to
    ``flash_attention``.  An inactive rate or ``eval()`` gives the logits of
    the dropout-free model."""
    calls = []

    def counting(*a, **kw):
        calls.append(1)
        return tflash.flash_attention(*a, **kw)

    monkeypatch.setattr(tmodeling, "flash_attention", counting)
    cfg = dataclasses.replace(T5Config.tiny(), dropout_rate=rate)
    model = T5ForConditionalGeneration(cfg, device="cpu")
    model.load_state_dict(_port_params(jax_params))
    model.train(train)
    b = {k: torch.from_numpy(v).long() for k, v in _batch(_rows(2, 10)).items()}
    launches = tflash.flash_attention.launches
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        out = model(b["input_ids"], b["attention_mask"], b["labels"], generator=gen)
    assert len(calls) == flash_calls
    assert tflash.flash_attention.launches == launches
    plain = T5ForConditionalGeneration(T5Config.tiny(), device="cpu")
    plain.load_state_dict(_port_params(jax_params))
    with torch.no_grad():
        want = plain(b["input_ids"], b["attention_mask"], b["labels"])
        if flash_calls:
            torch.testing.assert_close(out, want)
        else:
            again = model(b["input_ids"], b["attention_mask"], b["labels"],
                          generator=torch.Generator().manual_seed(0))
            other = model(b["input_ids"], b["attention_mask"], b["labels"],
                          generator=torch.Generator().manual_seed(1))
            torch.testing.assert_close(again, out, rtol=0, atol=0)
            assert (other - out).abs().max() > 1e-3 and (out - want).abs().max() > 1e-3


def test_dropout_keeps_and_scales_like_flax():
    """Flax's ``nn.Dropout``: an element is kept with probability 1 - rate
    and scaled by 1 / (1 - rate), the rest are 0."""
    x = torch.ones(200_000, dtype=torch.bfloat16)
    y = tmodeling.dropout(x, 0.1, torch.Generator().manual_seed(0))
    assert y.dtype == torch.bfloat16
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.9) < 5e-3
    assert torch.equal(y[kept], torch.full_like(y[kept], 1 / 0.9))


# -- (f) what the port refuses ------------------------------------------------


@pytest.mark.parametrize("what", ["num_chips_per_worker", "model_parallel", "remat",
                                  "logging_strategy", "disable_tqdm", "tensor_parallelism",
                                  "workers_beyond_the_cards", "use_gpu_on_cpu"])
def test_t5_paths_not_ported_or_not_read_are_refused(what, jax_params, tmp_path, monkeypatch):
    """TrainingArguments fields nothing reads are refused; N workers on CUDA
    with fewer than N cards raise before any starts; a ``use_gpu`` that
    disagrees with the device raises.  The paths this test once refused run
    now: a worker over 2 devices trains them as its data axis, and
    ``model_parallel=2`` or ``tensor_parallelism=2`` split the model over
    them (beyond the worker's devices, with the JAX loop's text)."""
    fields = {"remat": True, "logging_strategy": "steps", "disable_tqdm": False}
    if what in fields:
        with pytest.raises(TypeError, match=what):
            TrainingArguments(**{what: fields[what]})
        return
    if what == "use_gpu_on_cpu":
        with pytest.raises(ValueError, match="use_gpu"):
            T5Trainer(model_config=T5Config.tiny(), scaling_config=ScalingConfig(use_gpu=True),
                      device="cpu")
        assert T5Trainer(model_config=T5Config.tiny(),
                         scaling_config=ScalingConfig(use_gpu=False)).device.type == "cpu"
        return
    kw = dict(model_config=T5Config.tiny(), pretrained_params=_port_params(jax_params),
              training_args=TrainingArguments(num_train_epochs=1),
              datasets={"train": _rows(2, 11)}, run_config=RunConfig(storage_path=str(tmp_path)))
    if what == "workers_beyond_the_cards":
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
        with pytest.raises(ValueError, match="needs 2 cards"):
            T5Trainer(scaling_config=ScalingConfig(num_workers=2), device="cuda", **kw).fit()
        return
    if what == "tensor_parallelism":
        kw["training_args"] = TrainingArguments(num_train_epochs=1, tensor_parallelism=2)
        result = T5Trainer(device="cpu", **kw).fit()
        assert "model_parallel=2 exceeds the 1 visible devices of this run's chip lease" in \
            str(result.error)
        sc, mesh = ScalingConfig(num_chips_per_worker=2), (1, 2)
    elif what == "num_chips_per_worker":
        kw["training_args"] = TrainingArguments(num_train_epochs=1, per_device_train_batch_size=1)
        sc, mesh = ScalingConfig(num_chips_per_worker=2), (2, 1)
    else:
        sc, mesh = ScalingConfig(model_parallel=2), (1, 2)
    result = T5Trainer(scaling_config=sc, device="cpu", **kw).fit()
    assert result.error is None, result.error
    m = result.metrics
    assert (m["mesh_data"], m["mesh_model"]) == mesh and m["steps"] == 1
    assert np.isfinite(m["loss"])
    assert (m["params_bytes_per_device"] < m["params_bytes_total"]) == (mesh[1] == 2)


def test_resume_and_tune_style_overrides(jax_params, tmp_path):
    """Training resumed from a port checkpoint of the weights equals
    training from ``pretrained_params``; Tune-style keys of
    ``trainer_init_config`` (``epochs``, ``learning_rate``) override the
    TrainingArguments, as the JAX loop reads them."""
    from tpu_air_torch.train import Checkpoint

    start = Checkpoint.from_model(model_config=T5Config.tiny(),
                                  params=_port_params(jax_params), path=str(tmp_path / "start"))
    runs = []
    for source in ("resume", "pretrained"):
        kw = ({"resume_from_checkpoint": start} if source == "resume"
              else {"pretrained_params": _port_params(jax_params)})
        result = T5Trainer(
            model_config=T5Config.tiny(), datasets={"train": _rows(2, 12)},
            training_args=TrainingArguments(num_train_epochs=5, learning_rate=1e-9,
                                            evaluation_strategy="no"),
            trainer_init_config={"epochs": 2, "learning_rate": 1e-3},
            run_config=RunConfig(storage_path=str(tmp_path / source)), device="cpu", **kw,
        ).fit()
        assert result.error is None, result.error
        runs.append([m["loss"] for m in result.metrics_history])
    assert len(runs[0]) == 2 and runs[0] == runs[1]
    assert runs[0][1] < runs[0][0] - 1e-3          # lr 1e-3, not 1e-9, took the step
