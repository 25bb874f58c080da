"""The port's Tune (``tpu_air_torch.tune``) on the CPU against the JAX
package's ``tpu_air.tune``.

* Search spaces: the same spaces and seed give identical trial configs.
* Schedulers: ``ASHAScheduler`` and ``FIFOScheduler`` give identical
  decisions on the same seeded report streams (one holds a NaN).
* Sweeps: the port's ``Tuner`` over a function trainable gives the JAX
  ``Tuner``'s ResultGrid on the same function (histories, which trials were
  pruned, the best result), both run one trial at a time so that ASHA sees
  the reports in one order.  ``tpu_air`` runs on the session ``air``
  fixture; the port on a runtime of its own with ONE lease slot
  (``init(num_chips=1)``), so its trials queue on the lease in order.
* W2 at tiny width: ``Tuner`` over ``T5Trainer(T5Config.tiny(),
  device="cpu")`` from a Flax init, W2's search space, 4 samples, ASHA
  (max_t 4): each trial's loss and eval_loss history equals the JAX
  package's ``t5_train_loop`` run with that trial's merged config, to 1e-5
  relative (a stopped trial's history is a prefix of it), and the best
  checkpoint generates.
* Failures: a retry resumes from the trial's latest checkpoint (after an
  exception, and after the runner's process died); a trial that calls
  ``os._exit`` is an error in the grid while the others finish; trials
  that would spawn worker processes are refused.
"""

import dataclasses
import os

import numpy as np
import pandas as pd
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import tpu_air_torch  # noqa: E402
from tpu_air import tune as jtune  # noqa: E402
from tpu_air.models.t5 import T5Config as JConfig  # noqa: E402
from tpu_air.models.t5 import T5ForConditionalGeneration as JT5  # noqa: E402
from tpu_air.train import JaxTrainer  # noqa: E402
from tpu_air.train import RunConfig as JRunConfig  # noqa: E402
from tpu_air.train import session as jsession  # noqa: E402
from tpu_air_torch import tune  # noqa: E402
from tpu_air_torch.core import runtime as trt  # noqa: E402
from tpu_air_torch.models.t5.config import T5Config  # noqa: E402
from tpu_air_torch.models.t5.convert import params_from_jax  # noqa: E402
from tpu_air_torch.models.tokenizer import ByteTokenizer  # noqa: E402
from tpu_air_torch.predict.predictors import T5GenerativePredictor  # noqa: E402
from tpu_air_torch.train import (  # noqa: E402
    Checkpoint,
    CheckpointConfig,
    FailureConfig,
    RunConfig,
    ScalingConfig,
    T5Trainer,
    TorchTrainer,
    TrainingArguments,
    session,
)

SEQ = 16
VOCAB = 384
W2_SPACE = {"trainer_init_config": {
    "learning_rate": ("choice", [2e-5, 2e-4, 2e-3, 2e-2]),
    "epochs": ("choice", [2, 4, 8, 16]),
    "weight_decay": ("choice", [0.01, 0.1, 1, 10]),
}}


@pytest.fixture(scope="module")
def tair():
    tpu_air_torch.init(num_cpus=4, num_chips=1)
    yield tpu_air_torch
    tpu_air_torch.shutdown()


def _space(mod, spec):
    """A search space of ``mod`` (the port's ``tune`` or the JAX package's)
    from a spec of (primitive name, args) leaves."""
    if isinstance(spec, dict):
        return {k: _space(mod, v) for k, v in spec.items()}
    if isinstance(spec, tuple) and spec and isinstance(spec[0], str) and \
            hasattr(mod, spec[0]):
        return getattr(mod, spec[0])(*spec[1:])
    return spec


def _times_ten(spec):
    return spec["x"] * 10


SPACES = {
    "choice": ({"lr": ("choice", [1e-3, 1e-2, 1e-1])}, 5),
    "uniform": ({"wd": ("uniform", 0.0, 1.0)}, 4),
    "loguniform": ({"lr": ("loguniform", 1e-5, 1e-1)}, 4),
    "quniform": ({"q": ("quniform", 0.0, 10.0, 0.5)}, 4),
    "randint": ({"n": ("randint", 1, 9)}, 4),
    "grid_x_samples": ({"a": ("grid_search", [1, 2, 3]), "b": ("uniform", 0, 1)}, 2),
    "sample_from": ({"x": ("grid_search", [1, 2]), "y": ("sample_from", _times_ten),
                     "fn": abs}, 1),
    "nested": ({"trainer_init_config": {"lr": ("choice", [1, 2]),
                                        "inner": {"n": ("randint", 0, 5)}},
                "train_loop_config": {"m": ("uniform", -1, 1)}, "top": "keep"}, 3),
    "w2": (W2_SPACE, 4),
}


@pytest.mark.parametrize("name", sorted(SPACES))
def test_trial_configs_match_jax(name):
    """The port's Tuner samples and merges the same trial configs as JAX's
    from the same space and seed."""
    spec, samples = SPACES[name]

    def loop(config):
        pass

    base = {"lr": 0.5, "inner": {"n": -1, "keep": True}}
    got, want = [], []
    for mod, trainer, out in ((tune, TorchTrainer, got), (jtune, JaxTrainer, want)):
        tuner = mod.Tuner(trainer(loop, train_loop_config=base),
                          param_space=_space(mod, spec),
                          tune_config=mod.TuneConfig(num_samples=samples, seed=11))
        out.extend(tuner._trial_config(s) for s in tuner._sample_trial_configs())
    assert len(got) == len(want) > 0
    assert got == want


def _streams(seed, n_trials, n_reports, with_nan):
    """Report streams interleaved in a seeded order: (trial, metrics)."""
    rng = np.random.default_rng(seed)
    left = {f"t{i}": 0 for i in range(n_trials)}
    out = []
    while left:
        tid = sorted(left)[int(rng.integers(len(left)))]
        left[tid] += 1
        it = left[tid]
        loss = float(rng.uniform(0.1, 5.0) / it)
        if with_nan and tid == "t2" and it == 2:
            loss = float("nan")
        out.append((tid, {"training_iteration": it, "loss": loss, "acc": -loss}))
        if it >= n_reports:
            del left[tid]
    return out


@pytest.mark.parametrize("case", [
    ("asha", dict(max_t=8, grace_period=1, reduction_factor=2), "min", False),
    ("asha", dict(max_t=16, grace_period=1, reduction_factor=4), "min", True),
    ("asha", dict(max_t=9, grace_period=2, reduction_factor=3), "max", False),
    ("asha", dict(max_t=6, grace_period=3, reduction_factor=2), "min", True),
    ("fifo", {}, "min", True),
])
def test_scheduler_decisions_match_jax(case):
    """Decisions (CONTINUE/STOP) over the same interleaved report streams,
    also across a reset(); NaN is compared as the JAX package compares it."""
    kind, kw, mode, with_nan = case
    metric = "loss" if mode == "min" else "acc"
    decisions = []
    for mod in (tune, jtune):
        sched = (mod.ASHAScheduler(**kw) if kind == "asha" else mod.FIFOScheduler())
        sched.set_metric(metric, mode)
        seen = []
        for seed in (0, 1):
            sched.reset()
            for tid, m in _streams(seed, 6, 12, with_nan):
                seen.append(sched.on_result(tid, m))
                if seen[-1] == "STOP":
                    sched.on_trial_complete(tid)
        decisions.append(seen)
    assert decisions[0] == decisions[1]
    if kind == "asha":
        assert "STOP" in decisions[0] and "CONTINUE" in decisions[0]


# -- sweeps over a function trainable --------------------------------------------


def _curve_loop(session_mod):
    """A function trainable over ``session_mod`` (either package's session):
    a noisy decaying loss from a seeded generator, 6 reports."""
    def loop(config):
        rng = np.random.default_rng(config["seed"])
        for i in range(6):
            session_mod.report({"loss": config["base"] / (i + 1) + float(rng.uniform(0, 0.3)),
                                "i": i})
    return loop


def _sweep(mod, loop, tmp, **tc):
    return mod.Tuner(
        loop,
        param_space={"train_loop_config": {"base": mod.grid_search([1.0, 9.0, 0.5, 4.0, 8.0]),
                                           "seed": mod.randint(0, 1000)}},
        tune_config=mod.TuneConfig(metric="loss", mode="min", num_samples=1, seed=5,
                                   max_concurrent_trials=1, **tc),
        run_config=(RunConfig if mod is tune else JRunConfig)(storage_path=str(tmp)),
    ).fit()


@pytest.mark.parametrize("scheduler", ["asha", "fifo"])
def test_function_trainable_grid_matches_jax(tair, air, tmp_path, scheduler):
    """The same trials, histories, prunes and best result as the JAX Tuner."""
    grids = []
    for mod, sess in ((tune, session), (jtune, jsession)):
        sched = (mod.ASHAScheduler(max_t=6, grace_period=1, reduction_factor=2)
                 if scheduler == "asha" else None)
        grids.append(_sweep(mod, _curve_loop(sess), tmp_path / mod.__name__, scheduler=sched))
    got, want = grids
    assert len(got) == len(want) == 5
    assert got.num_errors == want.num_errors == 0
    assert got.num_terminated == want.num_terminated == 5
    for g, w in zip(got, want):
        assert g.config == w.config
        assert [m["loss"] for m in g.metrics_history] == [m["loss"] for m in w.metrics_history]
        assert [m["training_iteration"] for m in g.metrics_history] == \
            [m["training_iteration"] for m in w.metrics_history]
    lengths = [len(r.metrics_history) for r in got]
    if scheduler == "asha":
        assert min(lengths) < 6 and max(lengths) == 6
    else:
        assert lengths == [6] * 5
    assert got.get_best_result().config == want.get_best_result().config
    assert got.get_best_result().metrics["loss"] == want.get_best_result().metrics["loss"]
    assert list(got.get_dataframe()["loss"]) == list(want.get_dataframe()["loss"])


def test_user_training_iteration_does_not_stall_the_stream(tair, tmp_path):
    """Reports stream under the session's own counter, so a user-supplied
    training_iteration reaches the scheduler unchanged."""
    class Recorder(tune.TrialScheduler):
        def __init__(self):
            self.seen = []

        def on_result(self, trial_id, metrics):
            self.seen.append(metrics.get("training_iteration"))
            return "CONTINUE"

    sched = Recorder()

    def loop(config):
        for step in (100, 200, 300):
            session.report({"loss": 1.0 / step, "training_iteration": step})

    grid = tune.Tuner(loop, param_space={"x": tune.grid_search([1])},
                      tune_config=tune.TuneConfig(metric="loss", scheduler=sched),
                      run_config=RunConfig(storage_path=str(tmp_path))).fit()
    assert grid.num_errors == 0
    assert sched.seen == [100, 200, 300]


# -- W2 at tiny width -----------------------------------------------------------


@pytest.fixture(scope="module")
def jax_params():
    enc = jnp.ones((2, 8), jnp.int32)
    params = JT5(JConfig.tiny()).init(jax.random.PRNGKey(0), enc, jnp.ones_like(enc),
                                      jnp.ones((2, 6), jnp.int32))["params"]
    return jax.tree_util.tree_map(np.asarray, params)


def _rows(n, seed):
    rng = np.random.default_rng(seed)
    src = rng.integers(3, SEQ + 1, n)
    lab = rng.integers(2, SEQ // 2, n)
    pos = np.arange(SEQ)[None]
    mask = (pos < src[:, None]).astype(np.int32)
    ids = rng.integers(2, VOCAB, (n, SEQ)).astype(np.int32) * mask
    labels = rng.integers(2, VOCAB, (n, SEQ)).astype(np.int32) * (pos < lab[:, None])
    return pd.DataFrame({"input_ids": list(ids), "attention_mask": list(mask),
                         "labels": list(labels)})


W2_ARGS = dict(per_device_train_batch_size=2, per_device_eval_batch_size=2, seed=3)
BEST = CheckpointConfig(num_to_keep=1, checkpoint_score_attribute="eval_loss",
                        checkpoint_score_order="min")


@pytest.fixture(scope="module")
def w2_sweep(tair, jax_params, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("w2")
    train, evaluation = _rows(4, 21), _rows(3, 22)
    trainer = T5Trainer(
        model_config=T5Config.tiny(), training_args=TrainingArguments(**W2_ARGS),
        tokenizer=ByteTokenizer(model_max_length=SEQ),
        pretrained_params=params_from_jax(jax_params, T5Config.tiny()),
        datasets={"train": train, "evaluation": evaluation},
        scaling_config=ScalingConfig(num_workers=1),
        run_config=RunConfig(storage_path=str(tmp), checkpoint_config=BEST),
        device="cpu")
    grid = tune.Tuner(
        trainer, param_space=_space(tune, W2_SPACE),
        tune_config=tune.TuneConfig(metric="eval_loss", mode="min", num_samples=4, seed=0,
                                    scheduler=tune.ASHAScheduler(max_t=4)),
    ).fit()
    return grid, train, evaluation, tmp


def _port_fit(jax_params, rows, args, tmp, scale=1.0):
    """The port's T5Trainer in this process from the Flax init times
    ``scale``: its loss and eval_loss per epoch."""
    params = {k: v * scale if v.is_floating_point() else v
              for k, v in params_from_jax(jax_params, T5Config.tiny()).items()}
    r = T5Trainer(model_config=T5Config.tiny(), training_args=args, pretrained_params=params,
                  datasets=rows, run_config=RunConfig(storage_path=str(tmp)),
                  device="cpu").fit()
    assert r.error is None, r.error
    return np.array([[m["loss"], m["eval_loss"]] for m in r.metrics_history])


def test_w2_trials_match_the_jax_loop(w2_sweep, jax_params, monkeypatch):
    """Each trial's history is the JAX t5_train_loop's with the trial's
    merged config (lr, epochs, weight decay over the trainer's arguments),
    to 1e-5; ASHA stopped some trials, whose histories are prefixes.

    At lr 2e-2 and weight decay 1 the trajectory is chaotic: the port run
    from weights one f32 rounding apart (x (1 + 2**-23)) moves its own
    losses by up to about 5e-4 by the fourth epoch.  Where that
    sensitivity D exceeds 1e-5, an epoch is held to 10 x D instead, which
    shows the difference from the JAX loop is rounding grown by training,
    not a different computation."""
    from test_torch_t5_train import _jax_fit

    grid, train, evaluation, tmp = w2_sweep
    rows = {"train": train, "evaluation": evaluation}
    assert len(grid) == 4 and grid.num_errors == 0
    want_cfgs = [s["trainer_init_config"] for s in
                 jtune.Tuner(lambda c: None, param_space=_space(jtune, W2_SPACE),
                             tune_config=jtune.TuneConfig(num_samples=4, seed=0)
                             )._sample_trial_configs()]
    lengths, sensitive = [], 0
    for i, (r, cfg) in enumerate(zip(grid, want_cfgs)):
        assert {k: r.config[k] for k in cfg} == cfg
        args = TrainingArguments(**W2_ARGS, learning_rate=cfg["learning_rate"],
                                 num_train_epochs=cfg["epochs"],
                                 weight_decay=cfg["weight_decay"])
        jhist, _ = _jax_fit(monkeypatch, str(tmp / f"jax{i}"), "0", rows, args, jax_params)
        got = np.array([[m["loss"], m["eval_loss"]] for m in r.metrics_history])
        n = len(got)
        assert 1 <= n <= min(cfg["epochs"], 4)
        lengths.append(n)
        want = np.array([[m["loss"], m["eval_loss"]] for m in jhist[:n]])
        short = dataclasses.replace(args, num_train_epochs=n)
        a = _port_fit(jax_params, rows, short, tmp / f"p{i}")
        b = _port_fit(jax_params, rows, short, tmp / f"q{i}", 1 + 2.0 ** -23)
        np.testing.assert_array_equal(a, got)      # the trial is the in-process fit
        sens = np.abs(b / a - 1).max(axis=1, keepdims=True)
        bound = np.where(sens > 1e-5, 10 * sens, 1e-5)
        assert (np.abs(got / want - 1) <= bound).all(), (cfg, got, want, sens)
        sensitive += int((sens > 1e-5).sum())
        assert (sens[0] <= 1e-5).all()               # the first epoch is always held to 1e-5
    assert min(lengths) < 4, lengths          # ASHA pruned at least one trial
    assert sensitive <= 3


def test_w2_best_checkpoint_generates(w2_sweep):
    grid = w2_sweep[0]
    best = grid.get_best_result()
    done = [r.metrics["eval_loss"] for r in grid if r.error is None]
    assert best.metrics["eval_loss"] == min(done)
    assert best.checkpoint is not None
    assert best.checkpoint.get_metrics()["eval_loss"] == min(
        m["eval_loss"] for m in best.metrics_history)
    pred = T5GenerativePredictor.from_checkpoint(best.checkpoint, dtype="float32",
                                                 device="cpu", tokenizer=ByteTokenizer)
    batch = {k: np.stack(w2_sweep[2][k].to_list()) for k in ("input_ids", "attention_mask")}
    out = pred.predict(batch, max_new_tokens=4)
    assert len(out) == 3


# -- failures --------------------------------------------------------------------


def _resuming_loop(markers, how):
    """Three reports with a dict checkpoint each; the first attempt of
    x == 1 fails after its second report (an exception, or the process
    dies); a retry starts after the iteration of its resume checkpoint."""
    def loop(config):
        start = 0
        if config.get("resume_from_checkpoint"):
            start = Checkpoint.from_directory(config["resume_from_checkpoint"]
                                              ).get_metrics()["i"]
        marker = os.path.join(markers, f"trial-{config['x']}")
        first = not os.path.exists(marker)
        open(marker, "a").close()
        for i in range(start + 1, 4):
            session.report({"score": float(config["x"] * i), "i": i, "start": start},
                           checkpoint=Checkpoint.from_dict({"metrics": {"i": i}}))
            if first and config["x"] == 1 and i == 2:
                if how == "exit":
                    os._exit(3)
                raise ValueError("transient")
    return loop


@pytest.mark.parametrize("how", ["raise", "exit"])
def test_retry_resumes_from_the_latest_checkpoint(tair, tmp_path, how):
    markers = tmp_path / "markers"
    markers.mkdir()
    grid = tune.Tuner(
        _resuming_loop(str(markers), how),
        param_space={"x": tune.grid_search([1, 2])},
        tune_config=tune.TuneConfig(metric="score", mode="max"),
        run_config=RunConfig(storage_path=str(tmp_path / "res"),
                             failure_config=FailureConfig(max_failures=1)),
    ).fit()
    assert grid.num_errors == 0 and len(grid) == 2
    retried = grid[0]
    assert [m["start"] for m in retried.metrics_history] == [2]
    assert retried.metrics["i"] == 3
    assert [m["i"] for m in grid[1].metrics_history] == [1, 2, 3]


def test_hard_trial_crash_is_isolated(tair, tmp_path):
    """A trial whose process dies outright is an error in the grid, the
    others finish, and the lease comes back."""
    def loop(config):
        if config["x"] == 2:
            os._exit(37)
        session.report({"score": float(config["x"])})

    grid = tune.Tuner(loop, param_space={"x": tune.grid_search([1, 2, 3])},
                      tune_config=tune.TuneConfig(metric="score", mode="max"),
                      run_config=RunConfig(storage_path=str(tmp_path))).fit()
    assert len(grid) == 3 and grid.num_errors == 1
    assert "WorkerCrashed" in repr(grid.errors[0])
    assert grid.get_best_result().metrics["score"] == 3.0
    rt = trt.get_runtime()
    assert rt.avail["chip"] == float(rt.num_chips) and rt.free_chips == [0]
    # the sweep's report, ack and stop keys are gone from the store: its
    # files and its arena
    assert not [k for k in os.listdir(rt.store_root) if k.startswith("Tuner_")]
    tids = [os.path.basename(r.path) for r in grid]
    assert len(tids) == 3 and all(t.startswith("Tuner_") for t in tids), tids
    assert not [k for t in tids for k in [f"{t}-stop"] + [
        f"{t}-{kind}-{i}" for kind in ("report", "ack") for i in range(1, 4)]
        if rt.store.contains(k)]


def test_trials_that_would_spawn_workers_are_refused(tair, tmp_path):
    """A trial actor may not start processes: a sweep whose trainer spawns
    num_workers > 1 workers is refused before any trial starts, and a
    function trainable that starts workers itself fails as an error."""
    for trainer in (
        T5Trainer(model_config=T5Config.tiny(), datasets={"train": _rows(4, 1)},
                  scaling_config=ScalingConfig(num_workers=2), device="cpu"),
        TorchTrainer(lambda c: None, scaling_config=ScalingConfig(num_workers=2)),
    ):
        with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 12"):
            tune.Tuner(trainer, run_config=RunConfig(storage_path=str(tmp_path))).fit()

    def spawning(config):
        from tpu_air_torch.parallel.distributed import run_workers

        run_workers(dict, (), 2, torch.device("cpu"))

    grid = tune.Tuner(spawning, run_config=RunConfig(
        storage_path=str(tmp_path), failure_config=FailureConfig(max_failures=2))).fit()
    assert grid.num_errors == 1
    assert "NotImplementedError" in repr(grid.errors[0]) and "item 12" in repr(grid.errors[0])


def test_a_lease_returns_only_after_its_process_exits(tair):
    """The next actor on a card starts after the killed holder's process
    has exited: the card never holds two CUDA contexts of the runtime."""
    @tpu_air_torch.remote
    class Holder:
        def __init__(self, other_pid=None):
            self.other_alive = other_pid is not None and os.path.exists(f"/proc/{other_pid}")

        def info(self):
            return os.getpid(), self.other_alive, os.environ.get("TPU_AIR_CHIP_IDS")

    first = Holder.options(num_chips=1).remote()
    pid, _, lease = tpu_air_torch.get(first.info.remote())
    second = Holder.options(num_chips=1).remote(pid)
    tpu_air_torch.kill(first)
    _, other_alive, lease2 = tpu_air_torch.get(second.info.remote(), timeout=60)
    tpu_air_torch.kill(second)
    assert lease == lease2 == "0"
    assert other_alive is False


def test_total_chips_and_tune_config_defaults():
    assert ScalingConfig(num_workers=3).total_chips == 3
    assert ScalingConfig(num_workers=3, use_gpu=False).total_chips == 0
    assert dataclasses.asdict(tune.TuneConfig()) == dataclasses.asdict(jtune.TuneConfig())
