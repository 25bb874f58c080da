"""The port's long-context LM slice on the CPU against the JAX package's.

The same weights (a Flax init carried over by ``params_from_jax``) and the
same token rows, made from a numpy seed, go through the JAX ``CausalLM`` and
``make_sp_train_step`` on a one-device (data, sequence) mesh, where ring
attention runs the Pallas flash kernels in interpret mode, and through the
port's ``CausalLM`` and ``LMTrainer(device="cpu").fit()``, where attention
takes the kernels' plain versions.  Everything is float32.
"""

import dataclasses

import numpy as np
import pandas as pd
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from tpu_air.models import lm as jlm  # noqa: E402
from tpu_air.parallel.sequence_parallel import make_sp_train_step, shard_batch  # noqa: E402
from tpu_air.train import t5_trainer as jtrain  # noqa: E402
from tpu_air_torch.models import lm as tlm  # noqa: E402
from tpu_air_torch.ops import flash_attention as tflash  # noqa: E402
from tpu_air_torch.parallel import sequence_parallel as tsp  # noqa: E402
from tpu_air_torch.train import (  # noqa: E402
    Checkpoint,
    CheckpointConfig,
    LMTrainer,
    RunConfig,
    ScalingConfig,
    TrainingArguments,
)
from tpu_air_torch.train import t5_trainer as ttrain  # noqa: E402

V, L = 128, 40
TINY = dict(vocab_size=V, d_model=32, n_layers=2, n_heads=2, head_dim=16, d_ff=64,
            max_seq_len=64)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_params():
    """A Flax init of the tiny LM, as numpy leaves."""
    params = jlm.CausalLM(jlm.LMConfig(**TINY)).init(
        jax.random.PRNGKey(0), jnp.ones((1, 8), jnp.int32))["params"]
    return jax.tree_util.tree_map(np.asarray, params)


def _rows(n, seed, length=L):
    return np.random.default_rng(seed).integers(1, V, (n, length)).astype(np.int32)


def _port_model(jax_params):
    model = tlm.CausalLM(tlm.LMConfig(**TINY), device="cpu")
    model.load_state_dict(tlm.params_from_jax(jax_params))
    return model


def test_lm_logits_and_chunked_loss_match_jax(jax_params):
    """Logits of the port's CausalLM equal the JAX model's on the same
    weights; the chunked lm-head CE, with L not a multiple of the chunk
    (padded with pad targets), equals the JAX one and the dense loss."""
    ids = _rows(2, seed=1)
    ids[1, -5:] = 0                                 # pad targets are not scored
    jmodel = jlm.CausalLM(jlm.LMConfig(**TINY))
    want = np.asarray(jmodel.apply({"params": jax_params}, jnp.asarray(ids)))
    model = _port_model(jax_params)
    tids = torch.from_numpy(ids).long()
    with torch.no_grad():
        got = model(tids)
        hidden = model(tids, return_hidden=True)
        tgt = tsp.shift_targets(tids, 0)
        s, c = tlm.lm_chunked_loss_with_targets(hidden, tlm.head_weight(model), tgt, 0,
                                                chunk_size=16)
        dense_s, dense_c = tlm.lm_loss_with_targets(got, tgt, 0)
    # f32, differing only in summation order through two layers
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)
    jhidden = jmodel.apply({"params": jax_params}, jnp.asarray(ids), return_hidden=True)
    js, jc = jlm.lm_chunked_loss_with_targets(
        jhidden, jlm.head_weight(jax_params, jmodel.config),
        jnp.asarray(tgt.numpy()), 0, chunk_size=16)
    assert float(c) == float(jc) == float(dense_c) == 2 * (L - 1) - 5
    np.testing.assert_allclose(float(s), float(js), rtol=1e-5)
    np.testing.assert_allclose(float(s), float(dense_s), rtol=1e-5)


def test_lm_is_causal(jax_params):
    model = _port_model(jax_params)
    ids = torch.from_numpy(_rows(2, seed=2)).long()
    mutated = ids.clone()
    mutated[:, L // 2:] = 7
    with torch.no_grad():
        a, b = model(ids), model(mutated)
    torch.testing.assert_close(a[:, : L // 2], b[:, : L // 2], atol=0, rtol=0)


@pytest.mark.parametrize("kind", ["constant", "linear", "cosine"])
def test_schedule_matches_optax(kind):
    """The port's learning rate at each 0-based update count equals the
    optax schedule _make_optimizer builds (warmup then decay)."""
    args = TrainingArguments(learning_rate=3e-3, warmup_steps=3, lr_scheduler_type=kind)
    total = 10
    decay = {"constant": optax.constant_schedule(3e-3),
             "linear": optax.linear_schedule(3e-3, 0.0, total - 3),
             "cosine": optax.cosine_decay_schedule(3e-3, total - 3)}[kind]
    want = optax.join_schedules([optax.linear_schedule(0.0, 3e-3, 3), decay], [3])
    got = ttrain._make_schedule(args, total)
    for count in range(total + 2):
        np.testing.assert_allclose(got(count), float(want(count)), rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("grad_scale", [1e-3, 10.0])
def test_optimizer_update_matches_optax(grad_scale):
    """Two updates of the port's optimizer equal the JAX package's optax
    chain (clip_by_global_norm, then adamw): below the clip norm, and above
    it, where the gradients are scaled by max_norm / norm."""
    rng = np.random.default_rng(3)
    p0 = {"a": rng.standard_normal((4, 3)).astype(np.float32),
          "b": rng.standard_normal((5,)).astype(np.float32)}
    grads = [{k: (rng.standard_normal(v.shape) * grad_scale).astype(np.float32)
              for k, v in p0.items()} for _ in range(2)]
    args = TrainingArguments(learning_rate=1e-2, warmup_steps=1, lr_scheduler_type="linear",
                             max_grad_norm=1.0, weight_decay=0.1)
    tx = jtrain._make_optimizer(jtrain.TrainingArguments(**vars(args)), 4)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(jp)
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
    opt = ttrain._make_optimizer(args, 4, params.values())
    for g in grads:
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in params.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
    for k, p in params.items():
        # f32 with the learning rate as a double in torch: rounding only
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), atol=1e-7, rtol=1e-6)


def test_lm_trainer_fit_matches_jax_sp_step(jax_params, tmp_path):
    """The slice end to end: ``LMTrainer(device="cpu").fit()``, resumed from
    a port checkpoint of the JAX weights, against the JAX package's
    ``make_sp_train_step`` + ``_make_optimizer`` driven by hand on a
    one-device mesh over the same rows: 3 epochs of one step each (warmup,
    linear decay, clipping, weight decay), per-step losses and final
    parameters compared."""
    rows = _rows(2, seed=4)
    args = TrainingArguments(learning_rate=1e-2, per_device_train_batch_size=2,
                             num_train_epochs=3, warmup_steps=1, lr_scheduler_type="linear",
                             max_grad_norm=0.5, evaluation_strategy="no")

    cfg = jlm.LMConfig(**TINY)
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "sequence"))
    tx = jtrain._make_optimizer(jtrain.TrainingArguments(**vars(args)), 3)
    step, _ = make_sp_train_step(cfg, mesh, tx)
    params = jax.tree_util.tree_map(jnp.array, jax_params)
    opt_state = tx.init(params)
    tgt = np.concatenate([rows[:, 1:], np.zeros((2, 1), np.int32)], axis=1)
    want_losses = []
    for _ in range(3):
        params, opt_state, loss = step(params, opt_state, *shard_batch(mesh, rows, tgt))
        want_losses.append(float(loss))
    want_params = tlm.params_from_jax(jax.tree_util.tree_map(np.asarray, params))

    start = Checkpoint.from_model(model_config=tlm.LMConfig(**TINY),
                                  params=tlm.params_from_jax(jax_params),
                                  path=str(tmp_path / "start"))
    result = LMTrainer(
        model_config=tlm.LMConfig(**TINY), training_args=args,
        datasets={"train": pd.DataFrame({"input_ids": list(rows)})},
        run_config=RunConfig(storage_path=str(tmp_path)),
        resume_from_checkpoint=start, device="cpu",
    ).fit()
    assert result.error is None
    got_losses = [m["loss"] for m in result.metrics_history]
    assert [m["steps"] for m in result.metrics_history] == [1, 1, 1]
    # the first loss is the same f32 function of the same weights; later
    # ones follow AdamW updates of size ~lr that agree to f32 rounding
    np.testing.assert_allclose(got_losses, want_losses, rtol=2e-5)
    got_params = result.checkpoint.get_params()
    assert result.checkpoint.get_model_config() == tlm.LMConfig(**TINY)
    assert set(got_params) == set(want_params)
    diffs = np.concatenate([np.abs(got_params[n].numpy() - w.numpy()).ravel()
                            for n, w in want_params.items()])
    # Two nonzero updates of lr = 1e-2 (the warmup's first is 0).  The
    # gradients agree to f32 rounding, and so do almost all parameters;
    # AdamW's normalized step amplifies that rounding where two successive
    # gradients of an element nearly cancel, so a rare element may differ
    # by up to 1% of one step.
    assert np.quantile(diffs, 0.999) < 2e-6, np.quantile(diffs, 0.999)
    assert diffs.max() < 1e-4, diffs.max()


def test_lm_trainer_reports_eval_and_retries_from_checkpoint(tmp_path):
    """Eval over a partial last batch (padded with all-pad rows), metric
    keys, and FailureConfig: a failed attempt resumes from its latest
    checkpoint."""
    calls = []

    def flaky(config):
        calls.append(config.get("resume_from_checkpoint"))
        from tpu_air_torch.train.lm_trainer import lm_train_loop

        lm_train_loop(config)
        if len(calls) == 1:
            raise RuntimeError("injected failure after epoch reports")

    from tpu_air_torch.train import FailureConfig

    rows = _rows(5, seed=5)
    trainer = LMTrainer(
        model_config=tlm.LMConfig(**TINY),
        training_args=TrainingArguments(num_train_epochs=2, learning_rate=1e-3),
        datasets={"train": pd.DataFrame({"input_ids": list(rows)}),
                  "eval": pd.DataFrame({"input_ids": list(rows[:3])})},
        run_config=RunConfig(storage_path=str(tmp_path),
                             checkpoint_config=CheckpointConfig(num_to_keep=1),
                             failure_config=FailureConfig(max_failures=1)),
        device="cpu",
    )
    trainer._training_fn = lambda: flaky
    result = trainer.fit()
    assert result.error is None
    assert calls[0] is None and calls[1].endswith("checkpoint_000002")
    m = result.metrics
    for key in ("loss", "steps", "train_tokens_per_sec", "train_tokens_per_sec_per_chip",
                "mesh_data", "mesh_sequence", "eval_loss"):
        assert key in m, key
    assert m["steps"] == 2 and m["mesh_data"] == m["mesh_sequence"] == 1
    assert np.isfinite(m["eval_loss"]) and 0 < m["eval_loss"] < 2 * np.log(V)
    assert len(result.best_checkpoints) == 1


@pytest.mark.parametrize("what", ["sequence_parallel", "model_parallel", "num_workers",
                                  "adafactor"])
def test_lm_paths_not_ported_yet_raise(what, tmp_path):
    """The paths this test once refused run now: the sequence split over 2
    gloo ranks, tensor parallelism over a worker's 2 devices, 2
    data-parallel workers and Adafactor each train one epoch with a finite
    loss and report their mesh."""
    sc = {"sequence_parallel": ScalingConfig(sequence_parallel=2),
          "model_parallel": ScalingConfig(model_parallel=2),
          "num_workers": ScalingConfig(num_workers=2)}.get(what)
    args = TrainingArguments(num_train_epochs=1, per_device_train_batch_size=1,
                             optimizer="adafactor" if what == "adafactor" else "adamw")
    result = LMTrainer(
        model_config=tlm.LMConfig(**TINY), training_args=args, scaling_config=sc,
        datasets={"train": pd.DataFrame({"input_ids": list(_rows(2, seed=6))})},
        run_config=RunConfig(storage_path=str(tmp_path)), device="cpu",
    ).fit()
    assert result.error is None, result.error
    m = result.metrics
    assert np.isfinite(m["loss"])
    if what == "model_parallel":
        assert (m["mesh_model"], m["mesh_sequence"]) == (2, 1)
        assert m["params_bytes_per_device"] < m["params_bytes_total"]
    mesh = {"sequence_parallel": (1, 2), "num_workers": (2, 1)}.get(what, (1, 1))
    assert (m["mesh_data"], m["mesh_sequence"]) == mesh
    assert m["steps"] == 2 // mesh[0]


def test_decode_runs_a_one_token_step(jax_params):
    """``decode=True`` (once refused here) runs: a prefill then a 1-token
    step over the cache give the full forward's last logits, and each moves
    the cache index on by the tokens it wrote."""
    from tpu_air_torch.models.lm.generate import init_cache

    model = _port_model(jax_params)
    ids = torch.from_numpy(_rows(2, seed=8, length=9)).long()
    cache = init_cache(model, 2, 16)
    with torch.no_grad():
        full = model(ids)
        model(ids[:, :8], decode=True, cache=cache)
        assert all(c.cache_index == 8 for c in cache)
        step = model(ids[:, 8:], torch.full((2, 1), 8), decode=True, cache=cache)
    assert all(c.cache_index == 9 for c in cache)
    np.testing.assert_allclose(step[:, 0].numpy(), full[:, -1].numpy(), atol=1e-5)


@pytest.mark.parametrize("cls, field, value", [
    (TrainingArguments, "tensor_parallelism", 2), (TrainingArguments, "remat", True),
    (TrainingArguments, "logging_strategy", "steps"), (TrainingArguments, "disable_tqdm", False),
    (ScalingConfig, "use_tpu", False), (ScalingConfig, "topology", "2x2"),
    (ScalingConfig, "resources_per_worker", {"CPU": 1.0}), (RunConfig, "verbose", 0),
])
def test_config_fields_the_port_does_not_read_are_refused(cls, field, value):
    """A JAX-package config field that nothing in the port reads is refused at
    construction rather than accepted and ignored (``tensor_parallelism``,
    which the T5 loop now reads, is accepted); the fields the port keeps are
    all fields of the JAX package's class of the same name."""
    from tpu_air.train import config as jconfig

    if field == "tensor_parallelism":
        # read now: the T5 loop's tensor-parallel degree, with the JAX default
        assert cls(**{field: value}).tensor_parallelism == value
        assert cls().tensor_parallelism == jtrain.TrainingArguments().tensor_parallelism == 1
    else:
        with pytest.raises(TypeError, match=field):
            cls(**{field: value})
    jcls = jtrain.TrainingArguments if cls is TrainingArguments else getattr(jconfig, cls.__name__)
    assert {f.name for f in dataclasses.fields(cls)} <= {f.name for f in dataclasses.fields(jcls)}


def test_training_step_never_launches_kernels_on_cpu(jax_params):
    """On CPU tensors the step takes the plain versions: no launch counted."""
    before = (tflash.flash_attention.launches, tflash.flash_attention_backward.dq_launches,
              tflash.flash_attention_backward.dkv_launches)
    model = _port_model(jax_params)
    opt = ttrain._make_optimizer(TrainingArguments(), 1, model.parameters())
    ids = torch.from_numpy(_rows(1, seed=7)).long()
    loss = tsp.make_sp_train_step(model, opt)(ids, tsp.shift_targets(ids, 0))
    assert torch.isfinite(loss)
    assert (tflash.flash_attention.launches, tflash.flash_attention_backward.dq_launches,
            tflash.flash_attention_backward.dkv_launches) == before


def test_checkpoint_dict_and_directory_round_trip(tmp_path):
    """A dict checkpoint written to a directory and a model checkpoint read
    back give the same params, config and metrics."""
    cfg = tlm.LMConfig(**TINY)
    params = tlm.CausalLM(cfg, device="cpu").init_weights(1).state_dict()
    from_dict = Checkpoint.from_dict({"params": params, "metrics": {"loss": 1.5}})
    back = Checkpoint.from_directory(from_dict.to_directory(str(tmp_path / "d")))
    model_ckpt = Checkpoint.from_model(model_config=cfg, params=params, metrics={"loss": 2.0},
                                       path=str(tmp_path / "m"))
    for ckpt, loss in ((back, 1.5), (model_ckpt, 2.0)):
        got = ckpt.get_params()
        assert set(got) == set(params)
        assert all(torch.equal(got[k], params[k]) for k in params)
        assert ckpt.get_metrics() == {"loss": loss}
    assert model_ckpt.get_model_config() == cfg
    assert set(model_ckpt.to_dict()) == {"model_config", "params", "metrics"}


def test_lm_f16_builds_and_matches_jax(jax_params):
    """LMConfig(dtype="float16") builds and runs in the port: its logits
    against the JAX LM's in f16 on the same weights (f16 activations over
    two layers: a few f16 ulps at |logit| <= 4), greedy next tokens equal."""
    ids = _rows(2, seed=7)
    jmodel = jlm.CausalLM(jlm.LMConfig(**TINY, dtype="float16"))
    want = np.asarray(jmodel.apply({"params": jax_params}, jnp.asarray(ids)), np.float32)
    model = tlm.CausalLM(tlm.LMConfig(**TINY, dtype="float16"), device="cpu")
    model.load_state_dict(tlm.params_from_jax(jax_params))
    with torch.no_grad():
        got = model(torch.from_numpy(ids).long())
    assert model.layers[0].attn.q(torch.zeros(1, TINY["d_model"])).dtype == torch.float16
    got = got.float().numpy()
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=1e-2)
    agree = (got.argmax(-1) == want.argmax(-1)).mean()
    assert agree == 1.0, agree
