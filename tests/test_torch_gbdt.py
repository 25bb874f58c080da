"""The port's GBDT (W8's trainer, Tune's second trainable) on the CPU against
the JAX package's.

Both are numpy on the host, so the port must agree exactly: the same
seeded rows give bit-identical ``HistGBDT`` trees and predictions at world
size 1 and 2 (two ranks over a shared in-test exchange, and over each
package's own collectives through ``GBDTTrainer(num_workers=2)``), the
same metrics from ``GBDTTrainer`` (hist and sklearn backends), the same
``GBDTPredictor`` scores, and the same ResultGrid from ``Tuner`` over
``GBDTTrainer``.  A checkpoint the JAX package writes loads in the port
through ``PortUnpickler``.  ``tpu_air`` runs on the session ``air``
fixture; the port on a runtime of its own.
"""

import os
import subprocess
import sys
import threading

import numpy as np
import pandas as pd
import pytest

pytest.importorskip("jax")

import tpu_air_torch  # noqa: E402
from tpu_air import data as jdata  # noqa: E402
from tpu_air import tune as jtune  # noqa: E402
from tpu_air.predict.predictors import GBDTPredictor as JGBDTPredictor  # noqa: E402
from tpu_air.train import GBDTTrainer as JGBDTTrainer  # noqa: E402
from tpu_air.train import RunConfig as JRunConfig  # noqa: E402
from tpu_air.train import ScalingConfig as JScalingConfig  # noqa: E402
from tpu_air.train import XGBoostTrainer as JXGBoostTrainer  # noqa: E402
from tpu_air.train import hist_gbdt as jhist  # noqa: E402
from tpu_air_torch import tune  # noqa: E402
from tpu_air_torch.parallel import collectives  # noqa: E402
from tpu_air_torch.predict import GBDTPredictor, SklearnPredictor, XGBoostPredictor  # noqa: E402
from tpu_air_torch.train import (  # noqa: E402
    Checkpoint,
    GBDTTrainer,
    RunConfig,
    ScalingConfig,
    XGBoostTrainer,
)
from tpu_air_torch.train import hist_gbdt as thist  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FEATURES = ["a", "b", "c", "d"]


@pytest.fixture(scope="module")
def tair():
    tpu_air_torch.init(num_cpus=4, num_chips=1)
    yield tpu_air_torch
    tpu_air_torch.shutdown()


def _frame(n, seed):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, len(FEATURES)))
    y = ((X[:, 0] * X[:, 1] + 0.8 * np.sin(2 * X[:, 2]) + 0.3 * rng.normal(size=n)) > 0)
    df = pd.DataFrame(X, columns=FEATURES)
    df["label"] = y.astype(int)
    return df


TRAIN, VALID = _frame(160, 1), _frame(48, 2)


# -- HistGBDT ---------------------------------------------------------------------


def _xy(objective, seed=7, n=300):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 5))
    if objective == "binary:logistic":
        return X, ((X[:, 0] - 0.5 * X[:, 3] + 0.2 * rng.normal(size=n)) > 0).astype(float)
    return X, X[:, 0] * 2.0 + X[:, 1] + 0.1 * rng.normal(size=n)


class _Exchange:
    """Two ranks in threads of this process: each collective is a rendezvous
    on a shared board, reduced in rank order (as the store allreduce is)."""

    def __init__(self, world):
        self.world = world
        self.board = {}
        self.barrier = threading.Barrier(world)

    def comm(self, rank):
        ex = self

        class Comm:
            def __init__(self):
                self.rank, self.world, self.seq = rank, ex.world, 0

            def _swap(self, value, reduce_fn):
                self.seq += 1
                ex.board[(self.seq, self.rank)] = value
                ex.barrier.wait()
                out = reduce_fn([ex.board[(self.seq, r)] for r in range(self.world)])
                ex.barrier.wait()
                return out

            def allreduce_sum(self, arr, tag):
                return self._swap(np.asarray(arr),
                                  lambda vals: np.sum(np.stack(vals, axis=0), axis=0))

            def allgather(self, obj, tag):
                return self._swap(obj, list)

        return Comm()


def _fit_hist(mod, X, y, objective, world, rounds=6):
    """``rounds`` of ``mod.HistGBDT`` over ``world`` contiguous row shards;
    each rank's model."""
    shards = np.array_split(np.arange(len(X)), world)
    models = [mod.HistGBDT(objective=objective, eta=0.3, max_depth=3, max_bins=32)
              for _ in range(world)]
    ex = _Exchange(world)

    def run(r):
        m = models[r]
        m.setup(X[shards[r]], y[shards[r]], comm=ex.comm(r) if world > 1 else None)
        for _ in range(rounds):
            m.fit_one_round()

    threads = [threading.Thread(target=run, args=(r,)) for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return models


@pytest.mark.parametrize("world", [1, 2])
@pytest.mark.parametrize("objective", ["binary:logistic", "reg:squarederror"])
def test_hist_gbdt_is_bit_identical_to_jax(objective, world):
    X, y = _xy(objective)
    got = _fit_hist(thist, X, y, objective, world)
    want = _fit_hist(jhist, X, y, objective, world)
    sigs = {m.signature() for m in got + want}
    assert len(sigs) == 1                       # every rank of both packages
    assert len(got[0].trees) == 6
    for g, w in zip(got, want):
        for tg, tw in zip(g.trees, w.trees):
            for k in tw:
                np.testing.assert_array_equal(tg[k], tw[k])
        for e_g, e_w in zip(g._edges, w._edges):
            np.testing.assert_array_equal(e_g, e_w)
    np.testing.assert_array_equal(got[0].predict(X), want[0].predict(X))
    np.testing.assert_array_equal(got[0].predict_margin(X), want[0].predict_margin(X))
    assert hasattr(got[0], "predict_proba") == (objective == "binary:logistic")
    sc = got[0].scoring_copy()
    assert sc._margin is None and sc.signature() == got[0].signature()


# -- GBDTTrainer ------------------------------------------------------------------


def _fit(mod_trainer, datasets, tmp, workers=1, backend="hist", jax=False):
    params = {"objective": "binary:logistic", "eta": 0.3, "max_depth": 3}
    if backend != "hist":
        params["backend"] = backend
    sc = (JScalingConfig if jax else ScalingConfig)(num_workers=workers)
    result = mod_trainer(
        label_column="label", num_boost_round=6, params=params, scaling_config=sc,
        datasets=datasets, run_config=(JRunConfig if jax else RunConfig)(storage_path=str(tmp)),
    ).fit()
    assert result.error is None, result.error
    return result


@pytest.fixture(scope="module")
def fits(tair, air, tmp_path_factory):
    """Port and JAX fits of W8 at tiny dials, by (backend, workers)."""
    tmp = tmp_path_factory.mktemp("gbdt")
    out = {}
    for backend, workers in (("hist", 1), ("hist", 2), ("sklearn", 1)):
        key = f"{backend}{workers}"
        got = _fit(XGBoostTrainer, {"train": TRAIN, "valid": VALID}, tmp / f"t{key}",
                   workers, backend)
        want = _fit(JXGBoostTrainer, {"train": jdata.from_pandas(TRAIN),
                                      "valid": jdata.from_pandas(VALID)},
                    tmp / f"j{key}", workers, backend, jax=True)
        out[key] = (got, want)
    return out


@pytest.mark.parametrize("key", ["hist1", "hist2", "sklearn1"])
def test_gbdt_trainer_metrics_match_jax(fits, key):
    got, want = fits[key]
    strip = lambda h: [{k: v for k, v in m.items() if k != "_timestamp"} for m in h]  # noqa: E731
    assert strip(got.metrics_history) == strip(want.metrics_history)
    assert {"train-logloss", "train-error", "valid-error", "valid-logloss"} <= set(got.metrics)
    if key == "hist2":
        assert got.metrics["ranks_identical"] is True
    assert got.checkpoint._load_extras()["rounds_fit"] == 6


@pytest.mark.parametrize("key", ["hist1", "hist2", "sklearn1"])
def test_gbdt_predictor_matches_jax(fits, key):
    got, want = fits[key]
    feats = VALID[FEATURES]
    pg = GBDTPredictor.from_checkpoint(got.checkpoint).predict(feats)
    pw = JGBDTPredictor.from_checkpoint(want.checkpoint).predict(feats)
    np.testing.assert_array_equal(pg["predictions"].to_numpy(), pw["predictions"].to_numpy())
    if key.startswith("hist"):
        model = got.checkpoint.get_model()
        assert isinstance(model, thist.HistGBDT) and len(model.trees) == 6
        assert model.signature() == want.checkpoint.get_model().signature()
    assert XGBoostPredictor is GBDTPredictor and issubclass(SklearnPredictor, GBDTPredictor)


def test_jax_gbdt_checkpoint_loads_in_the_port(fits):
    """A checkpoint the JAX package wrote (its HistGBDT pickled under
    tpu_air.train.hist_gbdt) loads through PortUnpickler as the port's
    class, scores the same, and imports nothing of JAX or tpu_air."""
    want = fits["hist2"][1]
    path = want.checkpoint.path
    ckpt = Checkpoint.from_directory(path)
    model = ckpt.get_model()
    assert type(model).__module__ == "tpu_air_torch.train.hist_gbdt"
    X = VALID[FEATURES].to_numpy(dtype=np.float32)
    np.testing.assert_array_equal(model.predict_proba(X),
                                  want.checkpoint.get_model().predict_proba(X))
    code = (
        "import sys, numpy as np\n"
        "from tpu_air_torch.train import Checkpoint\n"
        f"m = Checkpoint.from_directory({path!r}).get_model()\n"
        "assert type(m).__module__ == 'tpu_air_torch.train.hist_gbdt', type(m)\n"
        "assert len(m.trees) == 6 and m.predict(np.zeros((2, 4))).shape == (2,)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'tpu_air'))\n"
        "print(repr(bad))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout


def test_port_gbdt_checkpoint_loads_in_the_jax_package(fits):
    """And back: the port writes the JAX package's layout (extras.pkl)."""
    from tpu_air.train.checkpoint import Checkpoint as JCheckpoint

    got = fits["hist1"][0]
    extras = JCheckpoint.from_directory(got.checkpoint.path)._load_extras()
    assert extras["label_column"] == "label" and extras["feature_columns"] == FEATURES
    assert extras["sklearn_model"].signature() == got.checkpoint.get_model().signature()


# -- Tune over GBDTTrainer ----------------------------------------------------------


def _gbdt_sweep(mod, trainer_cls, datasets, tmp, jax=False, **kw):
    return mod.Tuner(
        trainer_cls(label_column="label", params={"objective": "binary:logistic",
                                                  "max_depth": 3},
                    num_boost_round=kw.pop("rounds", 5), datasets=datasets),
        param_space=kw.pop("space"),
        tune_config=mod.TuneConfig(metric="valid-logloss", mode="min", **kw),
        run_config=(JRunConfig if jax else RunConfig)(storage_path=str(tmp)),
    ).fit()


def test_tuner_over_gbdt_matches_jax(tair, air, tmp_path):
    """W8's sweep: 3 samples of eta and max_depth, the same ResultGrid."""
    grids = []
    for mod, cls, ds in ((tune, GBDTTrainer, {"train": TRAIN, "valid": VALID}),
                         (jtune, JGBDTTrainer,
                          {"train": jdata.from_pandas(TRAIN), "valid": jdata.from_pandas(VALID)})):
        grids.append(_gbdt_sweep(
            mod, cls, ds, tmp_path / mod.__name__, jax=mod is jtune, num_samples=3, seed=7,
            space={"params": {"eta": mod.uniform(0.05, 0.3), "max_depth": mod.randint(2, 5)}}))
    got, want = grids
    assert len(got) == len(want) == 3 and got.num_errors == want.num_errors == 0
    for g, w in zip(got, want):
        assert g.config == w.config
        assert [m["valid-logloss"] for m in g.metrics_history] == \
            [m["valid-logloss"] for m in w.metrics_history]
    best = got.get_best_result()
    assert best.config == want.get_best_result().config and best.checkpoint is not None
    assert 2 <= best.config["params"]["max_depth"] < 5


def test_gbdt_asha_prune_saves_rounds(tair, air, tmp_path):
    """An ASHA-pruned trial fits fewer rounds than num_boost_round, and its
    checkpoint holds exactly the rounds it fit — as in the JAX package."""
    rounds = 12
    iters = []
    for mod, cls, ds in ((tune, GBDTTrainer, {"train": TRAIN, "valid": VALID}),
                         (jtune, JGBDTTrainer,
                          {"train": jdata.from_pandas(TRAIN), "valid": jdata.from_pandas(VALID)})):
        grid = _gbdt_sweep(
            mod, cls, ds, tmp_path / mod.__name__, jax=mod is jtune, rounds=rounds,
            num_samples=1, seed=3, max_concurrent_trials=1,
            space={"params": {"eta": mod.grid_search([0.3, 1e-6])}},
            scheduler=mod.ASHAScheduler(max_t=rounds, grace_period=2, reduction_factor=2))
        iters.append([r.metrics.get("iteration", 0) for r in grid])
        if mod is tune:
            pruned = min(grid, key=lambda r: r.metrics.get("iteration", 0))
            extras = pruned.checkpoint._load_extras()
            assert extras["rounds_fit"] == pruned.metrics["iteration"] < rounds
    assert iters[0] == iters[1]
    assert max(iters[0]) == rounds and min(iters[0]) < rounds


# -- collectives ------------------------------------------------------------------


def test_collectives_over_the_port_store(tair):
    """Barrier, broadcast, allreduce and gather among three tasks."""
    @tpu_air_torch.remote(num_cpus=0)
    def rank_fn(rank, name):
        from tpu_air_torch.parallel import collectives as c

        c.Barrier(name, 3).wait(rank)
        b = c.broadcast({"v": 7} if rank == 0 else None, name=name, rank=rank)
        s = c.allreduce(np.full(2, rank + 1.0), name=name, rank=rank, world_size=3,
                        reduce_fn=lambda vals: np.sum(vals, axis=0))
        g = c.gather(rank * 10, name=name, rank=rank, world_size=3)
        return b, s.tolist(), g

    outs = tpu_air_torch.get([rank_fn.remote(r, "t0") for r in range(3)], timeout=60)
    assert [o[0] for o in outs] == [{"v": 7}] * 3
    assert [o[1] for o in outs] == [[6.0, 6.0]] * 3
    assert [o[2] for o in outs] == [[0, 10, 20], None, None]
    with pytest.raises(TimeoutError):
        collectives.Barrier("lonely", 2).wait(0, timeout=0.2)
