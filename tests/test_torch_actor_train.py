"""Training in the port's runtime actors, on the CPU, against the JAX package.

* Placement: an actor places actors on a part of its own lease
  (``options(chip_ids=...)``); they claim nothing from the pool, die with
  their creator, and the creator's lease returns only once their processes
  have exited.  ``resolve_device`` wraps a slot id onto the cards.
* Tune trials of ``num_workers=2``: W2 at tiny width on worker actors equals
  the JAX ``t5_train_loop`` at dp 2 (losses to 1e-5 relative, the best
  checkpoint's parameters to 1e-5 in norm) and ASHA decides as the JAX
  ASHA does on the same reports; every rank stops at the same report; a
  rank that dies outright is an error in the grid, or a resumed retry.
* ``fit()`` runs its attempt in a trial actor: ``T5Trainer``,
  ``LMTrainer`` and ``TorchTrainer`` at ``num_workers`` 1 and 2 equal the
  JAX package's loops and ``fit()``; a runner killed outright resumes from
  the newest checkpoint on disk; with no device named and no CUDA,
  ``fit()`` raises.

The port runs on a runtime of its own (``init(num_chips=2)``, for the
placement tests; a trainer on the CPU leases no slot, so the W2 sweep runs
its trials one after another, ``max_concurrent_trials=1``, and ASHA sees
their reports in one order); ``tpu_air`` on the session ``air`` fixture.
Functions that run in the port's actors are defined inside the tests, so
that they travel by value and the actors never import this module (and,
with it, JAX).
"""

import dataclasses
import os
import signal
import time
from contextlib import contextmanager

import numpy as np
import pandas as pd
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

import tpu_air_torch  # noqa: E402
from tpu_air import tune as jtune  # noqa: E402
from tpu_air.models import lm as jlm  # noqa: E402
from tpu_air.models.t5 import T5Config as JConfig  # noqa: E402
from tpu_air.models.t5 import T5ForConditionalGeneration as JT5  # noqa: E402
from tpu_air.parallel.sequence_parallel import make_sp_train_step, shard_batch  # noqa: E402
from tpu_air.train import Checkpoint as JCheckpoint  # noqa: E402
from tpu_air.train import JaxTrainer  # noqa: E402
from tpu_air.train import RunConfig as JRunConfig  # noqa: E402
from tpu_air.train import t5_trainer as jtrain  # noqa: E402
from tpu_air_torch import tune  # noqa: E402
from tpu_air_torch.core import runtime as trt  # noqa: E402
from tpu_air_torch.device import resolve_device  # noqa: E402
from tpu_air_torch.models import lm as tlm  # noqa: E402
from tpu_air_torch.models.t5.config import T5Config  # noqa: E402
from tpu_air_torch.models.t5.convert import params_from_jax  # noqa: E402
from tpu_air_torch.train import (  # noqa: E402
    Checkpoint,
    CheckpointConfig,
    FailureConfig,
    LMTrainer,
    RunConfig,
    ScalingConfig,
    T5Trainer,
    TorchTrainer,
    TrainingArguments,
    session,
)

SEQ = 16
VOCAB = 384
LM_TINY = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=2, head_dim=16, d_ff=64,
               max_seq_len=64)
BEST = CheckpointConfig(num_to_keep=1, checkpoint_score_attribute="eval_loss",
                        checkpoint_score_order="min")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tair():
    saved = trt._runtime
    trt._runtime = None
    runtime = tpu_air_torch.init(num_cpus=4, num_chips=2)
    yield runtime
    tpu_air_torch.shutdown()
    trt._runtime = saved


@contextmanager
def time_limit(seconds: int):
    """Fail the test, rather than hang it, when the block outlasts
    ``seconds`` (a collective that never returns)."""
    def expired(signum, frame):
        raise TimeoutError(f"the block took longer than {seconds} s")

    old = signal.signal(signal.SIGALRM, expired)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


def _alive(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().split()[2] != "Z"
    except OSError:
        return False


def _lease_back(runtime) -> None:
    assert runtime.avail["chip"] == float(runtime.num_chips)
    assert sorted(runtime.free_chips) == list(range(runtime.num_chips))


# -- placement on the creator's lease ---------------------------------------------------


def test_resolve_device_wraps_a_slot_onto_the_cards(monkeypatch):
    """A leased actor's device is its first slot id wrapped onto the cards,
    as ``mesh.visible_devices`` wraps a lease: slots 0-3 of a runtime on one
    card all name ``cuda:0``, and on two cards slot 3 names ``cuda:1``."""
    class Worker:
        chip_ids = [3, 0]

    monkeypatch.setattr(trt, "current_worker", lambda: Worker())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for cards, want in ((1, 0), (2, 1), (4, 3), (8, 3)):
        monkeypatch.setattr(torch.cuda, "device_count", lambda n=cards: n)
        assert resolve_device() == torch.device("cuda", want)
    assert resolve_device("cpu") == torch.device("cpu")


def test_run_workers_from_the_driver_runs_rank_actors(tair, monkeypatch):
    """``run_workers`` called outside an actor runs its group on rank
    actors under a carrier actor: in the runtime that runs (on the CPU the
    carrier leases nothing) and, where none runs, in one it starts and
    stops.  On CUDA a group larger than the slots is refused before any
    runtime starts."""
    from tpu_air_torch.parallel.distributed import all_reduce_sum, run_workers

    def rank_fn(rank, world, device):
        t = all_reduce_sum(torch.tensor([float(rank + 1)], device=device))
        return {"rank": rank, "world": world, "sum": float(t), "pid": os.getpid(),
                "device": str(device), "error": None}

    for runtime in ("running", "none"):
        if runtime == "none":
            monkeypatch.setattr(trt, "_runtime", None)
        outs = run_workers(rank_fn, (), 2, torch.device("cpu"))
        assert [(o["rank"], o["world"], o["sum"], o["device"]) for o in outs] == \
            [(0, 2, 3.0, "cpu"), (1, 2, 3.0, "cpu")]
        assert os.getpid() not in {o["pid"] for o in outs} and outs[0]["pid"] != outs[1]["pid"]
        assert not [o["pid"] for o in outs if _alive(o["pid"])]
    assert trt._runtime is None        # the runtime it started is stopped
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="needs 2 cards"):
        run_workers(rank_fn, (), 2, torch.device("cuda"))
    assert trt._runtime is None
    monkeypatch.undo()
    _lease_back(tair)


def _lease_actors():
    """An actor class that places children on its own lease, and the
    children's class (made here, so that both travel by value)."""
    class Child:
        def info(self):
            from tpu_air_torch.core.runtime import current_worker

            return (os.getpid(), os.environ.get("TPU_AIR_CHIP_IDS"),
                    list(current_worker().chip_ids))

    class Parent:
        def spawn(self, shares):
            cls = tpu_air_torch.remote(Child)
            self.children = [cls.options(chip_ids=s).remote() for s in shares]
            return tpu_air_torch.get([c.info.remote() for c in self.children])

        def spawn_outside(self, ids):
            child = tpu_air_torch.remote(Child).options(chip_ids=ids).remote()
            return tpu_air_torch.get(child.info.remote())

        def die(self):
            os._exit(9)

    return Parent, Child


@pytest.mark.parametrize("end", ["kill", "crash"])
def test_actors_on_the_creators_lease_die_with_it(tair, end):
    """Actors placed on a part of their creator's lease claim nothing from
    the pool; when the creator is killed or dies outright they are
    stopped, and the lease returns only after their processes exited.
    Ids outside the lease are refused, and so is ``chip_ids`` outside an
    actor."""
    Parent, Child = _lease_actors()
    parent = tpu_air_torch.remote(Parent).options(num_chips=2).remote()
    infos = tpu_air_torch.get(parent.spawn.remote([[0], [1]]), timeout=60)
    assert [(lease, ids) for _, lease, ids in infos] == [("0", [0]), ("1", [1])]
    assert tair.avail["chip"] == 0.0          # the parent's claim only
    with pytest.raises(tpu_air_torch.RemoteError, match="not a part of the creating actor"):
        tpu_air_torch.get(parent.spawn_outside.remote([5]), timeout=60)
    with pytest.raises(ValueError, match="only an actor of the runtime"):
        tpu_air_torch.remote(Child).options(chip_ids=[0]).remote()
    pids = [pid for pid, _, _ in infos]
    if end == "kill":
        tpu_air_torch.kill(parent)
    else:
        with pytest.raises(tpu_air_torch.RemoteError):
            tpu_air_torch.get(parent.die.remote(), timeout=60)
        deadline = time.monotonic() + 60
        while tair.avail["chip"] != 2.0 and time.monotonic() < deadline:
            time.sleep(0.05)
    _lease_back(tair)
    assert not [p for p in pids if _alive(p)]


# -- Tune trials of two ranks ------------------------------------------------------------


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


def _flat(params) -> np.ndarray:
    return np.concatenate([np.asarray(params[k], np.float64).ravel() for k in sorted(params)])


def _norm_err(got, want) -> float:
    a, b = _flat(got), _flat(want)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# W2's space (SURVEY.md :294) without its largest learning rate and weight
# decays: at lr 2e-2 and weight decay 1 the trajectory is chaotic, and two
# f32 computations part by more than 1e-5 (test_torch_tune.py's W2 test
# measures that); the dials that stay cover three decades of lr
W2_SPACE = {"trainer_init_config": {
    "learning_rate": ("choice", [2e-5, 2e-4, 2e-3]),
    "epochs": ("choice", [2, 4]),
    "weight_decay": ("choice", [0.01, 0.1]),
}}
W2_ARGS = dict(per_device_train_batch_size=2, per_device_eval_batch_size=2, seed=3)


def _space(mod, spec):
    if isinstance(spec, dict):
        return {k: _space(mod, v) for k, v in spec.items()}
    return getattr(mod, spec[0])(*spec[1:])


@pytest.fixture(scope="module")
def w2_dp2(tair, jax_params, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("w2dp2")
    train, evaluation = _rows(4, 21), _rows(3, 22)
    trainer = T5Trainer(
        model_config=T5Config.tiny(), training_args=TrainingArguments(**W2_ARGS),
        pretrained_params=params_from_jax(jax_params, T5Config.tiny()),
        datasets={"train": train, "evaluation": evaluation},
        scaling_config=ScalingConfig(num_workers=2),
        run_config=RunConfig(storage_path=str(tmp), checkpoint_config=BEST),
        device="cpu")
    with time_limit(600):
        grid = tune.Tuner(
            trainer, param_space=_space(tune, W2_SPACE),
            tune_config=tune.TuneConfig(metric="eval_loss", mode="min", num_samples=4,
                                        seed=1, scheduler=tune.ASHAScheduler(max_t=4),
                                        max_concurrent_trials=1),
        ).fit()
    return grid, {"train": train, "evaluation": evaluation}, tmp


def test_w2_trials_of_two_ranks_match_the_jax_loop_at_dp2(w2_dp2, tair, jax_params,
                                                          monkeypatch):
    """Each trial's loss and eval_loss per epoch equal the JAX
    ``t5_train_loop`` on a two-device ``data`` mesh with the trial's merged
    config, to 1e-5 relative; the JAX ASHA, fed the trials' reports in the
    order they arrived (one trial at a time), stops each where the port's
    ASHA did; the best checkpoint's parameters equal the JAX loop's at the
    same iteration to 1e-5 in norm; the leases came back."""
    from test_torch_t5_train import _jax_fit

    grid, rows, tmp = w2_dp2
    assert len(grid) == 4 and grid.num_errors == 0, grid.errors
    cfgs = [s["trainer_init_config"] for s in
            jtune.Tuner(lambda c: None, param_space=_space(jtune, W2_SPACE),
                        tune_config=jtune.TuneConfig(num_samples=4, seed=1)
                        )._sample_trial_configs()]
    jsched = jtune.ASHAScheduler(max_t=4)
    jsched.set_metric("eval_loss", "min")
    best = grid.get_best_result()
    lengths = []
    for i, (r, cfg) in enumerate(zip(grid, cfgs)):
        assert {k: r.config[k] for k in cfg} == cfg
        args = TrainingArguments(**W2_ARGS, learning_rate=cfg["learning_rate"],
                                 num_train_epochs=cfg["epochs"],
                                 weight_decay=cfg["weight_decay"])
        keep_all = CheckpointConfig()
        jhist, _ = _jax_fit(monkeypatch, str(tmp / f"jax{i}"), "0,1", rows, args, jax_params,
                            keep_all)
        assert jhist[0]["mesh_data"] == 2 and r.metrics_history[0]["mesh_data"] == 2
        got = np.array([[m["loss"], m["eval_loss"]] for m in r.metrics_history])
        n = len(got)
        lengths.append(n)
        want = np.array([[m["loss"], m["eval_loss"]] for m in jhist[:n]])
        np.testing.assert_allclose(got, want, rtol=1e-5)
        decisions = [jsched.on_result(f"t{i}", m) for m in r.metrics_history]
        stop = decisions.index("STOP") + 1 if "STOP" in decisions else len(jhist)
        assert n == stop, (cfg, decisions)
        if r is best:
            it = int(os.path.basename(os.path.normpath(best.checkpoint.path)).split("_")[1])
            jckpt = JCheckpoint.from_directory(str(tmp / f"jax{i}" / f"checkpoint_{it:06d}"))
            jparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jckpt.get_params()),
                                      T5Config.tiny())
            got_params = {k: v.numpy() for k, v in best.checkpoint.get_params().items()}
            assert _norm_err(got_params, {k: v.numpy() for k, v in jparams.items()}) < 1e-5
    assert min(lengths) < 4, lengths               # ASHA stopped at least one trial
    _lease_back(tair)


class _StopAt(tune.FIFOScheduler):
    """Stops every trial at its report ``k``."""

    def __init__(self, k):
        super().__init__()
        self.k = k

    def on_result(self, trial_id, metrics):
        return "STOP" if metrics["training_iteration"] >= self.k else "CONTINUE"


def test_every_rank_stops_at_the_same_report(tair, tmp_path):
    """The scheduler stops a trial of two ranks at report 3: both ranks
    raise ``StopTrial`` at that report (neither has a report past it, and
    neither waits in the next step's all-reduce), and the trial is a clean
    stop, within the test's own time limit."""
    from tpu_air_torch.parallel.distributed import all_reduce_sum

    marks = str(tmp_path / "marks")
    os.makedirs(marks)

    def loop(config):
        rank = session.get_world_rank()
        for i in range(1, 11):
            total = all_reduce_sum(torch.tensor([float(i)]))
            with open(os.path.join(marks, f"rank{rank}"), "a") as f:
                f.write(f"{i}\n")
            session.report({"i": i, "total": float(total)})

    with time_limit(120):
        grid = tune.Tuner(TorchTrainer(loop, scaling_config=ScalingConfig(num_workers=2),
                                       device="cpu"),
                          tune_config=tune.TuneConfig(metric="i", scheduler=_StopAt(3)),
                          run_config=RunConfig(storage_path=str(tmp_path / "run"))).fit()
    assert grid.num_errors == 0
    assert [m["i"] for m in grid[0].metrics_history] == [1, 2, 3]
    assert grid[0].metrics["total"] == 6.0
    for rank in (0, 1):
        with open(os.path.join(marks, f"rank{rank}")) as f:
            assert f.read().split() == ["1", "2", "3"]
    _lease_back(tair)


def _dying_rank_loop(marks):
    """Two ranks, three reports with a checkpoint each; on the first
    attempt of x == 1 rank 1 dies outright at its report 2.  Each rank
    writes its pid; a retry starts after its resume checkpoint."""
    def loop(config):
        rank = session.get_world_rank()
        with open(os.path.join(marks, f"pid-{config['x']}-{rank}-{os.getpid()}"), "w"):
            pass
        start = 0
        if config.get("resume_from_checkpoint"):
            start = Checkpoint.from_directory(config["resume_from_checkpoint"]
                                              ).get_metrics()["i"]
        first = os.path.join(marks, f"first-{config['x']}-{rank}")
        is_first = not os.path.exists(first)
        open(first, "a").close()
        from tpu_air_torch.parallel.distributed import all_reduce_sum

        for i in range(start + 1, 4):
            all_reduce_sum(torch.tensor([1.0]))
            if is_first and config["x"] == 1 and rank == 1 and i == 2:
                os._exit(7)
            session.report({"i": i, "start": start, "score": float(config["x"] * i)},
                           checkpoint=Checkpoint.from_dict({"metrics": {"i": i}}))
    return loop


@pytest.mark.parametrize("max_failures", [0, 1])
def test_a_rank_dying_outright(tair, tmp_path, max_failures):
    """Rank 1 of trial x == 1 dies at its report 2: rank 0 fails in its
    next collective (the decision on its report 2, whose checkpoint it
    has retained).  Without retries the trial is an error in the grid and
    trial x == 2 finishes; with one it resumes from report 2's
    checkpoint.  Either way the lease comes
    back and no rank's process is left."""
    marks = str(tmp_path / "marks")
    os.makedirs(marks)
    with time_limit(240):
        grid = tune.Tuner(
            TorchTrainer(_dying_rank_loop(marks), scaling_config=ScalingConfig(num_workers=2),
                         device="cpu"),
            param_space={"x": tune.grid_search([1, 2])},
            tune_config=tune.TuneConfig(metric="score", mode="max"),
            run_config=RunConfig(storage_path=str(tmp_path / "run"),
                                 failure_config=FailureConfig(max_failures=max_failures)),
        ).fit()
    assert len(grid) == 2
    if max_failures == 0:
        assert grid.num_errors == 1
        assert "worker 1" in str(grid[0].error) and "WorkerCrashed" in str(grid[0].error)
    else:
        assert grid.num_errors == 0
        assert [(m["start"], m["i"]) for m in grid[0].metrics_history] == [(2, 3)]
    assert [m["i"] for m in grid[1].metrics_history] == [1, 2, 3]
    _lease_back(tair)
    pids = [int(n.rsplit("-", 1)[1]) for n in os.listdir(marks) if n.startswith("pid-")]
    assert len(pids) == 4 + 2 * max_failures
    assert not [p for p in pids if _alive(p)]


# -- fit() in its trial actor ----------------------------------------------------------


def _pid_probe(inner, path):
    """A training function that records the process it runs in, then runs
    ``inner``."""
    def fn(config):
        with open(os.path.join(path, f"{session.get_world_rank()}-{os.getpid()}"), "w"):
            pass
        return inner(config)
    return fn


def _ran_in_actors(path, ranks):
    names = os.listdir(path)
    assert sorted(int(n.split("-")[0]) for n in names) == list(range(ranks))
    assert os.getpid() not in {int(n.split("-")[1]) for n in names}


@pytest.mark.parametrize("workers", [1, 2])
def test_t5_fit_in_its_actor_matches_the_jax_loop(tair, jax_params, tmp_path, monkeypatch,
                                                  workers):
    from test_torch_t5_train import _jax_fit

    probe = str(tmp_path / "pids")
    os.makedirs(probe)
    rows = {"train": _rows(4, 31), "evaluation": _rows(2, 32)}
    args = TrainingArguments(learning_rate=1e-3, per_device_train_batch_size=4 // workers,
                             per_device_eval_batch_size=2, num_train_epochs=2, seed=3)
    trainer = T5Trainer(model_config=T5Config.tiny(), training_args=args,
                        pretrained_params=params_from_jax(jax_params, T5Config.tiny()),
                        datasets=rows, scaling_config=ScalingConfig(num_workers=workers),
                        run_config=RunConfig(storage_path=str(tmp_path / "port")),
                        device="cpu")
    inner = trainer._training_fn()
    trainer._training_fn = lambda: _pid_probe(inner, probe)
    result = trainer.fit()
    assert result.error is None, result.error
    _ran_in_actors(probe, workers)
    jargs = dataclasses.replace(args, per_device_train_batch_size=4 // workers)
    jhist, jbest = _jax_fit(monkeypatch, str(tmp_path / "jax"), ",".join(
        str(i) for i in range(workers)), rows, jargs, jax_params)
    got = [[m["loss"], m["eval_loss"]] for m in result.metrics_history]
    want = [[m["loss"], m["eval_loss"]] for m in jhist]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    jparams = params_from_jax(jax.tree_util.tree_map(
        np.asarray, JCheckpoint.from_directory(jbest[0]).get_params()), T5Config.tiny())
    assert _norm_err({k: v.numpy() for k, v in result.checkpoint.get_params().items()},
                     {k: v.numpy() for k, v in jparams.items()}) < 1e-5
    _lease_back(tair)


@pytest.mark.parametrize("workers", [1, 2])
def test_lm_fit_in_its_actor_matches_the_jax_step(tair, tmp_path, workers):
    """``LMTrainer.fit()`` at ``num_workers`` 1 and 2 against the JAX
    package's ``make_sp_train_step`` on a ``(workers, 1)`` mesh over the
    same global batch: per-step losses to 1e-5 relative, parameters to
    1e-5 in norm."""
    cfg = jlm.LMConfig(**LM_TINY)
    jparams = jlm.CausalLM(cfg).init(jax.random.PRNGKey(0), jnp.ones((1, 8), jnp.int32))["params"]
    rows = np.random.default_rng(7).integers(1, 64, (4, 32)).astype(np.int32)
    args = TrainingArguments(learning_rate=1e-3, per_device_train_batch_size=4 // workers,
                             num_train_epochs=3, warmup_steps=1, lr_scheduler_type="linear",
                             max_grad_norm=0.5, evaluation_strategy="no")
    mesh = Mesh(np.array(jax.devices()[:workers]).reshape(workers, 1), ("data", "sequence"))
    tx = jtrain._make_optimizer(jtrain.TrainingArguments(**vars(args)), 3)
    step, _ = make_sp_train_step(cfg, mesh, tx)
    params = jax.tree_util.tree_map(jnp.array, jparams)
    opt_state = tx.init(params)
    tgt = np.concatenate([rows[:, 1:], np.zeros((4, 1), np.int32)], axis=1)
    want = []
    for _ in range(3):
        params, opt_state, loss = step(params, opt_state, *shard_batch(mesh, rows, tgt))
        want.append(float(loss))
    want_params = tlm.params_from_jax(jax.tree_util.tree_map(np.asarray, params))

    probe = str(tmp_path / "pids")
    os.makedirs(probe)
    start = Checkpoint.from_model(model_config=tlm.LMConfig(**LM_TINY),
                                  params=tlm.params_from_jax(
                                      jax.tree_util.tree_map(np.asarray, jparams)),
                                  path=str(tmp_path / "start"))
    trainer = LMTrainer(model_config=tlm.LMConfig(**LM_TINY), training_args=args,
                        datasets={"train": pd.DataFrame({"input_ids": list(rows)})},
                        scaling_config=ScalingConfig(num_workers=workers),
                        run_config=RunConfig(storage_path=str(tmp_path)),
                        resume_from_checkpoint=start, device="cpu")
    inner = trainer._training_fn()
    trainer._training_fn = lambda: _pid_probe(inner, probe)
    result = trainer.fit()
    assert result.error is None, result.error
    _ran_in_actors(probe, workers)
    assert result.metrics["mesh_data"] == workers
    np.testing.assert_allclose([m["loss"] for m in result.metrics_history], want, rtol=1e-5)
    got = {k: v.numpy() for k, v in result.checkpoint.get_params().items()}
    assert _norm_err(got, {k: v.numpy() for k, v in want_params.items()}) < 1e-5
    _lease_back(tair)


def _linreg_loop():
    """Full-batch gradient descent on a seeded least-squares problem, its
    rows split over the ranks and the gradient summed over them; runs on
    either package's session (``config["pkg"]``)."""
    def loop(config):
        import importlib

        sess = importlib.import_module(f"{config['pkg']}.train.session")
        rng = np.random.default_rng(0)
        X = rng.normal(size=(8, 3)).astype(np.float32)
        y = (X @ np.array([1.0, -2.0, 0.5], np.float32) + 0.1).astype(np.float32)
        world = sess.get_world_size()
        rank = sess.get_world_rank() if world > 1 else 0
        part = slice(rank * 8 // world, (rank + 1) * 8 // world)
        w = np.zeros(3, np.float32)
        for _ in range(4):
            g = X[part].T @ (X[part] @ w - y[part])
            if world > 1:
                from tpu_air_torch.parallel.distributed import all_reduce_sum

                g = all_reduce_sum(torch.from_numpy(g)).numpy()
            w = w - np.float32(0.05) * g / 8
            sess.report({"loss": float(np.mean((X @ w - y) ** 2)), "w": [float(v) for v in w]})
    return loop


@pytest.mark.parametrize("workers", [1, 2])
def test_torch_trainer_fit_in_its_actor_matches_the_jax_fit(tair, air, tmp_path, workers):
    """``TorchTrainer.fit()`` on 1 and 2 ranks equals ``JaxTrainer.fit()``
    (whose trial actor runs the function once over the whole batch): the
    losses and the weights of every report, to 1e-5 relative."""
    probe = str(tmp_path / "pids")
    os.makedirs(probe)
    got = TorchTrainer(_pid_probe(_linreg_loop(), probe),
                       train_loop_config={"pkg": "tpu_air_torch"},
                       scaling_config=ScalingConfig(num_workers=workers), device="cpu",
                       run_config=RunConfig(storage_path=str(tmp_path / "port"))).fit()
    want = JaxTrainer(_linreg_loop(), train_loop_config={"pkg": "tpu_air"},
                      run_config=JRunConfig(storage_path=str(tmp_path / "jax"))).fit()
    assert got.error is None and want.error is None, (got.error, want.error)
    _ran_in_actors(probe, workers)
    assert len(got.metrics_history) == len(want.metrics_history) == 4
    for a, b in zip(got.metrics_history, want.metrics_history):
        np.testing.assert_allclose([a["loss"], *a["w"]], [b["loss"], *b["w"]], rtol=1e-5)
    _lease_back(tair)


def test_a_runner_killed_outright_resumes_from_the_newest_checkpoint(tair, tmp_path):
    """The first attempt's trial actor dies outright after its report 2:
    ``fit()`` takes the ``RemoteError`` as the attempt's error and the
    retry resumes from ``checkpoint_000002``, the newest on disk."""
    marks = str(tmp_path / "marks")
    os.makedirs(marks)

    def loop(config):
        start = 0
        if config.get("resume_from_checkpoint"):
            with open(os.path.join(marks, "resumed-from"), "w") as f:
                f.write(config["resume_from_checkpoint"])
            start = Checkpoint.from_directory(config["resume_from_checkpoint"]
                                              ).get_metrics()["i"]
        first = not os.path.exists(os.path.join(marks, "first"))
        open(os.path.join(marks, "first"), "a").close()
        for i in range(start + 1, 4):
            session.report({"i": i, "start": start},
                           checkpoint=Checkpoint.from_dict({"metrics": {"i": i}}))
            if first and i == 2:
                os._exit(5)

    result = TorchTrainer(loop, device="cpu", run_config=RunConfig(
        storage_path=str(tmp_path / "run"), failure_config=FailureConfig(max_failures=1))).fit()
    assert result.error is None, result.error
    with open(os.path.join(marks, "resumed-from")) as f:
        assert f.read().endswith("checkpoint_000002")
    assert [(m["start"], m["i"]) for m in result.metrics_history] == [(2, 3)]
    _lease_back(tair)


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a machine without CUDA")
def test_fit_with_no_device_and_no_cuda_raises(monkeypatch, tmp_path):
    """Where there is no CUDA device, a ``fit()`` that names none raises
    (the trainer's constructor, or ``init()`` leasing cards that are not
    there) and starts no runtime; naming the CPU runs."""
    monkeypatch.setattr(trt, "_runtime", None)
    with pytest.raises(RuntimeError, match="CUDA device"):
        T5Trainer(model_config=T5Config.tiny(), datasets={"train": _rows(2, 1)})
    with pytest.raises(RuntimeError, match="leases CUDA devices and none is available"):
        TorchTrainer(lambda c: None, run_config=RunConfig(storage_path=str(tmp_path))).fit()
    assert trt._runtime is None
    result = TorchTrainer(lambda c: session.report({"ok": 1}), device="cpu",
                          run_config=RunConfig(storage_path=str(tmp_path))).fit()
    assert result.error is None and result.metrics["ok"] == 1
    assert trt._runtime is None        # the runtime fit() started for itself is stopped
