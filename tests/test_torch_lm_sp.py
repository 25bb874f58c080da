"""The port's sequence- and data-parallel LM training on the CPU against the
JAX package's.

* ``ScalingConfig``: a grid of configs through both packages gives the same
  ``num_chips_per_worker`` and ``total_chips``, or the same refusal.
* The train step: the same weights (a Flax init carried over by
  ``params_from_jax``) and token rows go through the JAX package's
  ``make_sp_train_step`` on ``make_sp_mesh(4, dp, sp)`` (ring attention on
  the Pallas kernels in interpret mode) and through the port's step in four
  gloo worker processes (ring attention on the kernels' plain versions),
  both with SGD(1.0), so the parameter deltas are the gradients.
* LM Adafactor against ``optax.adafactor`` on the LM's parameter tree.
* ``LMTrainer.fit()`` with ``sequence_parallel=2`` and ``num_workers=2``
  against the same runs without the sequence axis, and the twin of
  ``examples/long_context_lm.py``.

Everything is float32.
"""

import os
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

from tpu_air.models import lm as jlm  # noqa: E402
from tpu_air.parallel import sequence_parallel as jsp  # noqa: E402
from tpu_air.train import config as jconfig  # noqa: E402
from tpu_air.train import t5_trainer as jtrain  # noqa: E402
from tpu_air_torch.models import lm as tlm  # noqa: E402
from tpu_air_torch.models.lm.convert import jax_layouts  # noqa: E402
from tpu_air_torch.parallel import sequence_parallel as tsp  # noqa: E402
from tpu_air_torch.train import (  # noqa: E402
    LMTrainer,
    RunConfig,
    ScalingConfig,
    TrainingArguments,
)
from tpu_air_torch.train import t5_trainer as ttrain  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V, L = 128, 48
TINY = dict(vocab_size=V, d_model=32, n_layers=2, n_heads=2, head_dim=16, d_ff=64,
            max_seq_len=64)
GRIDS = [(2, 2), (1, 4)]


@pytest.fixture(scope="module")
def jax_params():
    params = jlm.CausalLM(jlm.LMConfig(**TINY)).init(
        jax.random.PRNGKey(0), jnp.ones((1, 8), jnp.int32))["params"]
    return jax.tree_util.tree_map(np.asarray, params)


def _rows(n, seed, length=L):
    return np.random.default_rng(seed).integers(1, V, (n, length)).astype(np.int32)


# -- ScalingConfig ------------------------------------------------------------------


def _sizing(cls, **kw):
    try:
        c = cls(**kw)
    except (ValueError, NotImplementedError) as e:
        return type(e).__name__, str(e)
    return c.num_chips_per_worker, c.total_chips


@pytest.mark.parametrize("model_parallel", [None, 0, 1, 2])
@pytest.mark.parametrize("sequence_parallel", [None, 1, 2, 4])
def test_scaling_config_sizes_runs_as_jax_does(model_parallel, sequence_parallel):
    """Over workers, chips a worker and ``use_gpu``: a worker's chips cover
    model_parallel x sequence_parallel, and a trial leases
    num_workers x num_chips_per_worker, as in the JAX package; its
    refusals (a zero degree, chips a worker not a multiple of the axes) are
    the port's too, with the same text.  A worker over more chips than its
    axes is accepted, as the JAX package accepts it: the extra chips are a
    data axis."""
    for workers in (1, 2, 3):
        for chips in (1, 2, 3, 4, 8):
            for use_gpu in (None, False):
                kw = dict(num_workers=workers, num_chips_per_worker=chips, use_gpu=use_gpu,
                          model_parallel=model_parallel,
                          sequence_parallel=sequence_parallel)
                want = _sizing(jconfig.ScalingConfig, **kw)
                got = _sizing(ScalingConfig, **kw)
                assert got == want, kw
    sc = ScalingConfig(num_workers=2, sequence_parallel=2)
    assert (sc.num_chips_per_worker, sc.total_chips) == (2, 4)


# -- the mesh and the train step ---------------------------------------------------


def test_mesh_and_shards_outside_a_group():
    """One rank outside a group: a (1, 1) grid with no sequence group, and
    JAX's refusal of an sp that does not divide the devices; a batch's
    block is its data row's rows and its sequence column's tokens."""
    mesh = tsp.make_sp_mesh()
    assert (mesh.dp, mesh.sp, mesh.data_index, mesh.seq_index, mesh.group) == (1, 1, 0, 0, None)
    with pytest.raises(ValueError, match="sp=2 does not divide 1 devices"):
        tsp.make_sp_mesh(sp=2)
    ids = torch.arange(4 * 8).reshape(4, 8)
    got, tgt = tsp.shard_batch(tsp.SPMesh(dp=2, sp=4, data_index=1, seq_index=2), ids, ids + 1)
    assert torch.equal(got, ids[2:4, 4:6]) and torch.equal(tgt, got + 1)


@pytest.fixture(scope="module")
def port_steps(jax_params):
    """One SGD(1.0) step of the port's dp x sp step per grid, in one group
    of 4 gloo worker processes."""
    from _ring_workers import sp_step_rank
    from tpu_air_torch.parallel.distributed import run_workers

    outs = run_workers(sp_step_rank, (tlm.LMConfig(**TINY), tlm.params_from_jax(jax_params),
                                      _rows(2, seed=3), GRIDS), 4, torch.device("cpu"))
    errors = [o["error"] for o in outs if o.get("error")]
    assert not errors, errors
    return [o["grids"] for o in outs]


@pytest.mark.parametrize("dp, sp", GRIDS)
def test_sp_step_matches_jax(jax_params, port_steps, dp, sp):
    """Loss and parameter deltas (the gradient summed over every rank over
    the global token count) of the port's step on each rank equal one step
    of the JAX ``make_sp_train_step`` on the same (data, sequence) grid;
    rank r holds block (r // sp, r % sp) of L/sp tokens."""
    ids = _rows(2, seed=3)
    cfg = jlm.LMConfig(**TINY)
    mesh = jsp.make_sp_mesh(4, dp=dp, sp=sp)
    tx = optax.sgd(1.0)
    step, _ = jsp.make_sp_train_step(cfg, mesh, tx)
    params = jax.tree_util.tree_map(jnp.array, jax_params)
    tgt = np.asarray(jsp.shift_targets(jnp.asarray(ids), cfg.pad_token_id))
    new, _, loss = step(params, tx.init(params), *jsp.shard_batch(mesh, ids, tgt))
    want = tlm.params_from_jax(jax.tree_util.tree_map(
        lambda a, b: np.asarray(a) - np.asarray(b), jax.device_get(new), jax_params))
    for r, rank in enumerate(port_steps):
        got = rank[(dp, sp)]
        assert got["mesh"] == (r // sp, r % sp)
        assert got["local_shape"] == (2 // dp, L // sp)
        np.testing.assert_allclose(got["loss"], float(loss), rtol=1e-5)
        for name, w in want.items():
            np.testing.assert_allclose(got["delta"][name], w.numpy(), atol=2e-6, rtol=1e-4,
                                       err_msg=f"rank {r} {name}")


# -- Adafactor ---------------------------------------------------------------------


def test_lm_adafactor_matches_optax():
    """Two updates of the port's Adafactor over the LM's parameters, read
    in the JAX layouts ``jax_layouts`` reports, against the JAX package's
    ``_make_optimizer`` chain (clip_by_global_norm, optax.adafactor) over
    the Flax tree.  Widths of 128 and more, so the embedding, every dense
    kernel and the head are factored; the norms are not."""
    cfg = dict(vocab_size=256, d_model=128, n_layers=1, n_heads=2, head_dim=64, d_ff=256,
               max_seq_len=64, tie_embeddings=False)
    p0 = jax.tree_util.tree_map(np.asarray, jlm.CausalLM(jlm.LMConfig(**cfg)).init(
        jax.random.PRNGKey(1), jnp.ones((1, 8), jnp.int32))["params"])
    rng = np.random.default_rng(7)
    grads = [jax.tree_util.tree_map(
        lambda x: (rng.standard_normal(x.shape) * 0.1).astype(np.float32), p0)
        for _ in range(2)]
    args = TrainingArguments(learning_rate=1e-2, warmup_steps=1, lr_scheduler_type="linear",
                             max_grad_norm=1.0, optimizer="adafactor")
    tx = jtrain._make_optimizer(jtrain.TrainingArguments(**vars(args)), 3)
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    state = tx.init(jp)

    model = tlm.CausalLM(tlm.LMConfig(**cfg), device="cpu")
    model.load_state_dict(tlm.params_from_jax(p0))
    layouts = jax_layouts(tlm.LMConfig(**cfg))
    assert set(layouts) == set(model.state_dict())
    names = [n for n, _ in model.named_parameters()]
    opt = ttrain._make_optimizer(args, 3, [p for _, p in model.named_parameters()],
                                 [layouts[n] for n in names])
    assert layouts["lm_head.weight"] == (True, (128, 256))
    assert layouts["layers.0.mlp.down.weight"] == (True, (256, 128))
    for g in grads:
        updates, state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, updates)
        port_g = tlm.params_from_jax(g)
        for n, p in model.named_parameters():
            p.grad = port_g[n].clone()
        opt.step()
    want = tlm.params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    start = tlm.params_from_jax(p0)
    for n, p in model.named_parameters():
        moved = (want[n] - start[n]).abs().max().item()
        assert moved > 1e-5, n
        np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(), rtol=1e-6,
                                   atol=1e-5 * moved, err_msg=n)


# -- LMTrainer ---------------------------------------------------------------------


def _fit(tmp_path, sc, per_device, **args):
    rows = _rows(4, seed=5)
    return LMTrainer(
        model_config=tlm.LMConfig(**TINY),
        training_args=TrainingArguments(num_train_epochs=2, learning_rate=1e-2,
                                        per_device_train_batch_size=per_device,
                                        per_device_eval_batch_size=per_device, **args),
        scaling_config=sc,
        datasets={"train": pd.DataFrame({"input_ids": list(rows)}),
                  "evaluation": pd.DataFrame({"input_ids": list(rows[:3])})},
        run_config=RunConfig(storage_path=str(tmp_path)), device="cpu",
    ).fit()


@pytest.fixture(scope="module")
def sp1_fit(tmp_path_factory):
    return _fit(tmp_path_factory.mktemp("sp1"), None, 2)


@pytest.fixture(scope="module")
def dp2_fit(tmp_path_factory):
    return _fit(tmp_path_factory.mktemp("dp2"), ScalingConfig(num_workers=2), 1)


@pytest.mark.parametrize("what", ["sp2_vs_sp1", "dp2sp2_vs_dp2"])
def test_lm_trainer_fit_over_the_sequence_axis(what, sp1_fit, dp2_fit, tmp_path):
    """The same rows and seed: ``sequence_parallel=2`` (2 ranks) against one
    rank, and ``num_workers=2, sequence_parallel=2`` (4 ranks) against two
    workers: per-epoch losses and eval losses within 1e-4, the mesh in the
    metrics, and a checkpoint that ``CausalLM.load_state_dict`` reads."""
    if what == "sp2_vs_sp1":
        got, base = _fit(tmp_path, ScalingConfig(sequence_parallel=2), 2), sp1_fit
        mesh = (1, 2)
    else:
        got = _fit(tmp_path, ScalingConfig(num_workers=2, sequence_parallel=2), 1)
        base, mesh = dp2_fit, (2, 2)
    assert got.error is None and base.error is None, (got.error, base.error)
    assert len(got.metrics_history) == len(base.metrics_history) == 2
    for m, b in zip(got.metrics_history, base.metrics_history):
        assert (m["mesh_data"], m["mesh_sequence"]) == mesh
        assert (b["mesh_data"], b["mesh_sequence"]) == (mesh[0], 1)
        assert m["steps"] == b["steps"] == 2
        np.testing.assert_allclose(m["loss"], b["loss"], atol=1e-4)
        assert np.isfinite(m["eval_loss"])
        np.testing.assert_allclose(m["eval_loss"], b["eval_loss"], atol=1e-4)
        per_chip = m["train_tokens_per_sec"] / (mesh[0] * mesh[1])
        np.testing.assert_allclose(m["train_tokens_per_sec_per_chip"], per_chip, rtol=1e-9)
    assert got.metrics_history[-1]["loss"] < got.metrics_history[0]["loss"]
    model = tlm.CausalLM(tlm.LMConfig(**TINY), device="cpu")
    model.load_state_dict(got.checkpoint.get_params())
    want = base.checkpoint.get_params()
    for n, p in model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[n].numpy(), atol=1e-4, err_msg=n)


@pytest.mark.parametrize("what", ["combined_axes", "sequence_not_divisible"])
def test_lm_trainer_refusals_keep_the_jax_text(what, tmp_path, monkeypatch):
    """model_parallel with sequence_parallel, and a sequence length sp does
    not divide, raise with the JAX package's text (in one rank, before any
    group starts)."""
    monkeypatch.setattr(LMTrainer, "_num_ranks", lambda self: 1)
    if what == "combined_axes":
        result = _fit(tmp_path, ScalingConfig(model_parallel=2, sequence_parallel=2), 2)
        assert "model_parallel and sequence_parallel cannot be combined yet" in str(
            result.error)
        return
    rows = _rows(2, seed=6, length=41)
    result = LMTrainer(
        model_config=tlm.LMConfig(**TINY),
        training_args=TrainingArguments(num_train_epochs=1),
        scaling_config=ScalingConfig(sequence_parallel=2),
        datasets={"train": pd.DataFrame({"input_ids": list(rows)})},
        run_config=RunConfig(storage_path=str(tmp_path)), device="cpu").fit()
    assert "ValueError" in str(result.error)
    assert "should be divisible by 2, but it is equal to 41" in str(result.error)


def test_long_context_example_over_gloo():
    """``examples/torch_long_context_lm.py --device cpu --sp 2``: two gloo
    ranks train the synthetic periodic corpus and the loss falls."""
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "examples", "torch_long_context_lm.py"),
         "--device", "cpu", "--seq-len", "64", "--sp", "2", "--steps", "6",
         "--d-model", "32"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": REPO})
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert "mesh: dp=1 x sp=2 over 2 ranks on cpu; global seq 64 -> 32 tokens/rank" in proc.stdout
    assert "sequence-parallel training OK" in proc.stdout
