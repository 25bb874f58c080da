"""The rest of the JAX package's surface in the port, on the CPU, held
against ``tpu_air`` on the same numpy-seeded inputs.

* The file readers (``read_parquet``, ``read_csv``, ``read_json``) and
  ``range`` give the frames the JAX package's give: same rows, column order
  and dtypes; the ports of tests/test_data.py's range, parquet, power
  transform and chain cases.
* ``StandardScaler``, ``PowerTransformer`` (Yeo-Johnson on negative inputs,
  Box-Cox on positive ones), ``Normalizer`` and ``Chain`` equal the JAX
  package's to 1e-12; a checkpoint the JAX package wrote with a ``Chain``
  preprocessor and a ``BaggedGBDT`` estimator reads in the port and scores
  the same.
* The ``train.report`` fault site: a kill at report 3 ends the trial actor
  (and each rank actor of a 2-rank fit) before that report's checkpoint is
  kept, and the retry resumes from report 2's: losses ``[8.0, 7.0]``, as
  the JAX package's ``test_train_worker_kill_resumes_from_checkpoint``.
* The metric sinks: event-file scalars and Prometheus gauges equal to the
  JAX sinks' on the same reports; ``TPU_AIR_TENSORBOARD=1`` opts a fit in.
* ``deserialize_ex``, ``current_plan``, ``load_t5_from_hf``,
  ``BatchPredictor.predict(separate_preprocessor=)`` and every name of the
  JAX packages' ``__all__``, exported by the port or listed as having no
  counterpart.

The port runs on a runtime of its own; ``tpu_air`` on the session ``air``
fixture.  Functions that run in the port's actors are defined inside the
tests, so that they travel by value and never import this module (and,
with it, JAX).
"""

import glob
import importlib
import os
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

import tpu_air_torch  # noqa: E402
from tpu_air import data as jdata  # noqa: E402
from tpu_air import faults as jfaults  # noqa: E402
from tpu_air.data import preprocessors as jpre  # noqa: E402
from tpu_air.train import Checkpoint as JCheckpoint  # noqa: E402
from tpu_air.train import FailureConfig as JFailureConfig  # noqa: E402
from tpu_air.train import JaxTrainer  # noqa: E402
from tpu_air.train import RunConfig as JRunConfig  # noqa: E402
from tpu_air.train import gbdt_trainer as jgbdt  # noqa: E402
from tpu_air.train import hist_gbdt as jhist  # noqa: E402
from chip_smoke import event_scalars  # noqa: E402
from tpu_air_torch import data as tdata  # noqa: E402
from tpu_air_torch import faults  # noqa: E402
from tpu_air_torch.core import runtime as trt  # noqa: E402
from tpu_air_torch.data import preprocessors as tpre  # noqa: E402
from tpu_air_torch.train import (  # noqa: E402
    Checkpoint,
    FailureConfig,
    RunConfig,
    ScalingConfig,
    TorchTrainer,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSET = os.path.join(ROOT, "tests", "assets", "flan_t5_tiny")
FEATURES = ["a", "b", "c", "d"]


@pytest.fixture(scope="module")
def tair():
    saved = trt._runtime
    trt._runtime = None
    runtime = tpu_air_torch.init(num_cpus=4, num_chips=2)
    yield runtime
    tpu_air_torch.shutdown()
    trt._runtime = saved


@pytest.fixture
def plans():
    """Both packages' fault plans cleared after the test."""
    yield
    faults.clear()
    jfaults.clear()


def _frame(n: int = 40, seed: int = 0) -> pd.DataFrame:
    """Seeded rows of every column kind the readers type: int, float with
    negatives, string, bool."""
    rng = np.random.default_rng(seed)
    return pd.DataFrame({
        "id": np.arange(n, dtype=np.int64),
        "x": rng.normal(size=n),
        "y": rng.uniform(0.5, 20.0, n),
        "name": [f"row{i}" for i in rng.integers(0, 1000, n)],
        "flag": rng.integers(0, 2, n).astype(bool),
    })


# -- readers ------------------------------------------------------------------------------


def _write(kind: str, df: pd.DataFrame, root) -> str:
    if kind == "parquet_dir":
        path = str(root / "pq")
        os.makedirs(path)
        df.iloc[:17].to_parquet(os.path.join(path, "part-0.parquet"), index=False)
        df.iloc[17:].to_parquet(os.path.join(path, "part-1.parquet"), index=False)
        return path
    path = str(root / {"parquet_file": "rows.parquet", "csv": "rows.csv",
                       "json": "rows.json"}[kind])
    if kind == "parquet_file":
        df.to_parquet(path, index=False)
    elif kind == "csv":
        df.to_csv(path, index=False)
    else:
        df.to_json(path, orient="records")
    return path


@pytest.mark.parametrize("kind", ["parquet_dir", "parquet_file", "csv", "json"])
def test_readers_give_the_jax_packages_frames(tair, air, tmp_path, kind):
    df = _write(kind, _frame(), tmp_path)
    reader = {"parquet_dir": "read_parquet", "parquet_file": "read_parquet",
              "csv": "read_csv", "json": "read_json"}[kind]
    got = getattr(tdata, reader)(df)
    want = getattr(jdata, reader)(df)
    assert got.num_blocks() == want.num_blocks()
    g, w = got.to_pandas(), want.to_pandas()
    assert list(g.columns) == list(w.columns) == list(_frame().columns)
    assert list(g.dtypes) == list(w.dtypes)
    pd.testing.assert_frame_equal(g, w)
    pd.testing.assert_frame_equal(g, _frame(), check_dtype=False)


def test_read_parquet_without_pyarrow_says_so(tair, tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "pyarrow.parquet", None)     # as where it is absent
    with pytest.raises(ImportError, match="read_parquet requires the 'pyarrow' package"):
        tdata.read_parquet(str(tmp_path))


def test_expand_paths_matches_jax(tmp_path):
    from tpu_air.data.io import _expand_paths as jexpand
    from tpu_air_torch.data.io import _expand_paths

    for name in ("b.csv", "a.csv", "c.json"):
        (tmp_path / name).write_text("x\n1\n")
    for paths in (str(tmp_path), [str(tmp_path), "s3://bucket/k.csv", "gs://b/x.csv"],
                  str(tmp_path / "a.csv")):
        assert _expand_paths(paths, ".csv") == jexpand(paths, ".csv")
    assert _expand_paths(str(tmp_path), ".csv") == sorted(glob.glob(str(tmp_path / "*.csv")))


@pytest.mark.parametrize("n, parallelism", [(100, 8), (5, 8), (30, 3)])
def test_range_matches_jax(tair, air, n, parallelism):
    got, want = tdata.range(n, parallelism), jdata.range(n, parallelism)
    assert got.num_blocks() == want.num_blocks()
    pd.testing.assert_frame_equal(got.to_pandas(), want.to_pandas())


def test_range_limit_take(tair):
    ds = tdata.range(100).limit(7)
    assert ds.count() == 7
    assert [r["id"] for r in ds.take(3)] == [0, 1, 2]


def test_write_read_parquet_roundtrip(tair, tmp_path):
    ds = tdata.range(30)
    path = str(tmp_path / "pq")
    ds.write_parquet(path)
    back = tdata.read_parquet(path)
    assert back.count() == 30
    assert sorted(r["id"] for r in back.take_all()) == list(range(30))


def test_power_transformer_and_normalizer(tair):
    df = pd.DataFrame({"x": [1.0, 4.0, 9.0], "y": [3.0, 4.0, 0.0]})
    pt = tpre.PowerTransformer(columns=["x"], power=0.5)
    out = pt.transform_batch(df.copy())
    assert out["x"].iloc[0] == pytest.approx(2 * (2.0**0.5 - 1))
    nz = tpre.Normalizer(columns=["x", "y"])
    out = nz.transform_batch(df.copy())
    norms = np.sqrt(out["x"] ** 2 + out["y"] ** 2)
    np.testing.assert_allclose(norms, 1.0)


def test_chain(tair):
    rng = np.random.default_rng(0)
    taxi_like = tdata.from_pandas(pd.DataFrame({
        "trip_distance": rng.uniform(0, 30, 200),
        "trip_duration": rng.uniform(60, 3600, 200),
        "passenger_count": rng.integers(1, 6, 200),
    })).repartition(5)
    chain = tpre.Chain(
        tpre.MinMaxScaler(columns=["trip_distance"]),
        tpre.BatchMapper(lambda df: df.assign(z=df["trip_distance"] * 2)),
    )
    out = chain.fit_transform(taxi_like)
    assert out.to_pandas()["z"].max() == pytest.approx(2.0)


# -- preprocessors -------------------------------------------------------------------------


def _signed(n: int = 64, seed: int = 3) -> pd.DataFrame:
    """Seeded columns: x and y of both signs (Yeo-Johnson), p and q positive
    (Box-Cox), a zero row for the normalizers."""
    rng = np.random.default_rng(seed)
    df = pd.DataFrame({"x": rng.normal(0, 3, n), "y": rng.normal(-1, 2, n),
                       "p": rng.uniform(0.1, 9.0, n), "q": rng.gamma(2.0, 2.0, n)})
    df.loc[5, ["x", "y", "p", "q"]] = 0.0
    df.loc[5, ["p", "q"]] = 1.0
    return df


def _pair(name: str, *args, **kw):
    return getattr(tpre, name)(*args, **kw), getattr(jpre, name)(*args, **kw)


CASES = {
    "yeo_johnson_0": ("PowerTransformer", (["x", "y"], 0.0), {}),
    "yeo_johnson_0.5": ("PowerTransformer", (["x", "y"], 0.5), {}),
    "yeo_johnson_1.3": ("PowerTransformer", (["x", "y"], 1.3), {}),
    "yeo_johnson_2": ("PowerTransformer", (["x", "y"], 2.0), {}),
    "box_cox_0": ("PowerTransformer", (["p", "q"], 0.0), {"method": "box-cox"}),
    "box_cox_0.5": ("PowerTransformer", (["p", "q"], 0.5), {"method": "box-cox"}),
    "normalizer_l1": ("Normalizer", (["x", "y", "p"],), {"norm": "l1"}),
    "normalizer_l2": ("Normalizer", (["x", "y", "p"],), {"norm": "l2"}),
    "normalizer_max": ("Normalizer", (["x", "y", "p"],), {"norm": "max"}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_stateless_preprocessors_match_jax(case):
    name, args, kw = CASES[case]
    got, want = _pair(name, *args, **kw)
    df = _signed()
    g, w = got.transform_batch(df.copy()), want.transform_batch(df.copy())
    assert list(g.columns) == list(w.columns)
    np.testing.assert_allclose(g.to_numpy(), w.to_numpy(), rtol=1e-12, atol=1e-12)
    batch = {c: df[c].to_numpy() for c in df.columns}      # the dict-of-arrays batch
    gb, wb = got.transform_batch(dict(batch)), want.transform_batch(dict(batch))
    for c in df.columns:
        np.testing.assert_allclose(gb[c], wb[c], rtol=1e-12, atol=1e-12)


def test_normalizer_refuses_an_unknown_norm():
    for p in _pair("Normalizer", ["x"], norm="l3"):
        with pytest.raises(ValueError, match="unknown norm 'l3'"):
            p.transform_batch(_signed())


def _fitted_chain(mod, steps, dataset):
    """``mod.Chain(*steps)`` as ``fit(dataset)`` leaves it where only its
    first step is fittable: that step fitted on ``dataset``.  (The JAX
    chain's own ``fit`` also runs each later step's ``map_batches`` over
    the dataset, tasks whose results it drops; their outputs are compared
    through ``transform_batch`` instead.)"""
    steps[0].fit(dataset)
    chain = mod.Chain(*steps)
    chain._fitted = True
    return chain


def _chain(mod, fitted_on=None):
    steps = [mod.StandardScaler(["x", "y", "p"]), mod.PowerTransformer(["x", "y"], 0.7),
             mod.Normalizer(["x", "y", "p"], norm="l2")]
    return mod.Chain(*steps) if fitted_on is None else _fitted_chain(mod, steps, fitted_on)


def test_standard_scaler_and_chain_fit_on_datasets_as_jax_does(tair, air):
    """Each package fits on its own dataset of the same rows; the port's
    chain then transforms its dataset through ``map_batches`` to the rows
    the JAX chain gives batch by batch (the JAX side runs no map task)."""
    df = _signed()
    got = tpre.StandardScaler(["x", "y", "p", "q"]).fit(tdata.from_pandas(df))
    want = jpre.StandardScaler(["x", "y", "p", "q"]).fit(jdata.from_pandas(df))
    assert got.stats_ == want.stats_ and got.check_is_fitted()
    g = _chain(tpre).fit_transform(tdata.from_pandas(df).repartition(3)).to_pandas()
    w = _chain(jpre, fitted_on=jdata.from_pandas(df)).transform_batch(df.copy())
    np.testing.assert_allclose(g.to_numpy(), w.to_numpy(), rtol=1e-12, atol=1e-12)


# -- a JAX-written checkpoint: Chain preprocessor, BaggedGBDT estimator --------------------


def _gbdt_rows(n: int, seed: int) -> pd.DataFrame:
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, len(FEATURES)))
    df = pd.DataFrame(X, columns=FEATURES)
    df["label"] = ((X[:, 0] - 0.5 * X[:, 3] + 0.2 * rng.normal(size=n)) > 0).astype(int)
    return df


def _jax_bagged(objective: str):
    """A JAX ``BaggedGBDT`` of two histogram boosters, each fitted on its
    half of the rows, as the older distributed sklearn backend bagged its
    ranks' estimators."""
    df = _gbdt_rows(160, 11)
    X, y = df[FEATURES].to_numpy(np.float32), df["label"].to_numpy(np.float64)
    if objective != "binary:logistic":
        y = X[:, 0] * 2.0 + X[:, 1]
    models = []
    for part in (slice(0, 80), slice(80, 160)):
        m = jhist.HistGBDT(objective=objective, eta=0.3, max_depth=3, max_bins=32)
        m.setup(X[part], y[part])
        for _ in range(4):
            m.fit_one_round()
        models.append(m)
    return jgbdt.BaggedGBDT(models, objective == "binary:logistic")


@pytest.fixture(scope="module")
def jax_checkpoint(air, tmp_path_factory):
    """What the JAX package writes for a bagged GBDT over a fitted chain."""
    chain = _fitted_chain(jpre, [jpre.StandardScaler(FEATURES[:3]),
                                 jpre.PowerTransformer(FEATURES[:2], 0.5),
                                 jpre.Normalizer(FEATURES, norm="l2")],
                          jdata.from_pandas(_gbdt_rows(160, 11)))
    path = str(tmp_path_factory.mktemp("jax_gbdt") / "ckpt")
    JCheckpoint.from_model(preprocessor=chain, path=path, extras={
        "sklearn_model": _jax_bagged("binary:logistic"), "label_column": "label",
        "feature_columns": FEATURES})
    return path


def test_jax_checkpoint_with_chain_and_bagged_gbdt_reads_in_the_port(jax_checkpoint):
    """Both classes unpickle as the port's copies (``PortUnpickler`` maps
    ``tpu_air.data.preprocessors`` and ``tpu_air.train.gbdt_trainer``); the
    chain transforms and the bagged model scores as the JAX package's."""
    got, want = Checkpoint.from_directory(jax_checkpoint), JCheckpoint.from_directory(
        jax_checkpoint)
    pre, jpre_ = got.get_preprocessor(), want.get_preprocessor()
    assert type(pre).__module__ == "tpu_air_torch.data.preprocessors"
    assert [type(p).__name__ for p in pre.preprocessors] == \
        ["StandardScaler", "PowerTransformer", "Normalizer"]
    assert pre.preprocessors[0].stats_ == jpre_.preprocessors[0].stats_
    rows = _gbdt_rows(48, 12)[FEATURES]
    np.testing.assert_allclose(pre.transform_batch(rows.copy()).to_numpy(),
                               jpre_.transform_batch(rows.copy()).to_numpy(),
                               rtol=1e-12, atol=1e-12)
    model = got.get_model(device="cpu")
    assert type(model).__module__ == "tpu_air_torch.train.gbdt_trainer"
    assert [type(m).__module__ for m in model.models] == ["tpu_air_torch.train.hist_gbdt"] * 2
    X = pre.transform_batch(rows.copy()).to_numpy(np.float32)
    jmodel = want.get_model()
    np.testing.assert_array_equal(model.predict_proba(X), jmodel.predict_proba(X))
    np.testing.assert_array_equal(model.predict(X), jmodel.predict(X))


def test_gbdt_predictors_score_the_jax_checkpoint_alike(jax_checkpoint):
    from tpu_air.predict.predictors import GBDTPredictor as JGBDTPredictor
    from tpu_air_torch.predict import GBDTPredictor

    rows = _gbdt_rows(48, 13)[FEATURES]
    got = GBDTPredictor.from_checkpoint(Checkpoint.from_directory(jax_checkpoint)).predict(rows)
    want = JGBDTPredictor.from_checkpoint(JCheckpoint.from_directory(jax_checkpoint)).predict(
        rows)
    np.testing.assert_array_equal(got["predictions"].to_numpy(),
                                  want["predictions"].to_numpy())


def test_bagged_regressor_averages_as_jax_does(tmp_path):
    path = str(tmp_path / "ckpt")
    JCheckpoint.from_model(path=path, extras={"sklearn_model": _jax_bagged("reg:squarederror")})
    model = Checkpoint.from_directory(path).get_model(device="cpu")
    X = _gbdt_rows(32, 14)[FEATURES].to_numpy(np.float32)
    assert not hasattr(model, "predict_proba")
    np.testing.assert_array_equal(model.predict(X),
                                  JCheckpoint.from_directory(path).get_model().predict(X))


def test_batch_predictor_accepts_separate_preprocessor(tair, jax_checkpoint):
    from tpu_air_torch.predict import BatchPredictor, GBDTPredictor

    rows = _gbdt_rows(24, 15)[FEATURES]
    bp = BatchPredictor.from_checkpoint(Checkpoint.from_directory(jax_checkpoint),
                                        GBDTPredictor)
    outs = [bp.predict(tdata.from_pandas(rows), batch_size=8,
                       separate_preprocessor=flag).to_pandas()["predictions"].to_numpy()
            for flag in (False, True)]
    np.testing.assert_array_equal(outs[0], outs[1])
    want = GBDTPredictor.from_checkpoint(Checkpoint.from_directory(jax_checkpoint)).predict(rows)
    np.testing.assert_array_equal(np.sort(outs[0]), np.sort(want["predictions"].to_numpy()))


# -- the train.report fault site -------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_kill_run(air, tmp_path_factory):
    """The JAX package's run of test_train_worker_kill_resumes_from_checkpoint."""
    from tpu_air.train import Checkpoint as JCk

    jfaults.install(jfaults.FaultPlan(seed=1, specs=[
        jfaults.FaultSpec("train.report", "kill", at=3)]))

    def loop(config):
        from tpu_air.train import session

        start = 0
        if config.get("resume_from_checkpoint"):
            start = JCk.from_directory(config["resume_from_checkpoint"]).get_metrics()["epoch"]
        for epoch in range(start, 4):
            loss = 10.0 - epoch
            session.report({"epoch": epoch + 1, "loss": loss},
                           checkpoint=JCk.from_model(metrics={"epoch": epoch + 1, "loss": loss}))

    try:
        return JaxTrainer(loop, run_config=JRunConfig(
            storage_path=str(tmp_path_factory.mktemp("jax_kill")),
            failure_config=JFailureConfig(max_failures=1))).fit()
    finally:
        jfaults.clear()


@pytest.mark.parametrize("workers", [1, 2])
def test_train_report_kill_resumes_from_checkpoint(tair, jax_kill_run, plans, tmp_path,
                                                   workers):
    """A plan installed after the runtime started reaches the trial actor
    (and each rank actor of a 2-rank fit): every rank dies at its report 3,
    before that report's checkpoint is kept; the retry resumes from report
    2's checkpoint, found on disk, and reports epochs 3 and 4."""
    faults.install(faults.FaultPlan(seed=1, specs=[faults.FaultSpec("train.report", "kill",
                                                                    at=3)]))
    assert faults.current_plan().specs[0].site == "train.report"
    seen = str(tmp_path / "seen")
    os.makedirs(seen)

    def loop(config):
        from tpu_air_torch.train import Checkpoint as Ck
        from tpu_air_torch.train import session

        start = 0
        if config.get("resume_from_checkpoint"):
            start = Ck.from_directory(config["resume_from_checkpoint"]).get_metrics()["epoch"]
        rank = session.get_world_rank()
        with open(os.path.join(seen, f"{rank}-{os.getpid()}"), "w") as f:
            f.write(str(config.get("resume_from_checkpoint")))
        for epoch in range(start, 4):
            loss = 10.0 - epoch
            session.report({"epoch": epoch + 1, "loss": loss},
                           checkpoint=Ck.from_dict({"metrics": {"epoch": epoch + 1,
                                                                "loss": loss}}))

    r = TorchTrainer(loop, scaling_config=ScalingConfig(num_workers=workers), device="cpu",
                     run_config=RunConfig(storage_path=str(tmp_path / "run"),
                                          failure_config=FailureConfig(max_failures=1))).fit()
    want = jax_kill_run
    assert want.error is None and r.error is None, (want.error, r.error)
    assert r.metrics["epoch"] == want.metrics["epoch"] == 4
    losses = [m["loss"] for m in r.metrics_history]
    assert losses == [m["loss"] for m in want.metrics_history] == [8.0, 7.0]
    assert r.checkpoint.get_metrics()["epoch"] == 4
    # each attempt's ranks ran in processes of their own; the retry's ranks
    # all resumed from report 2's checkpoint
    runs = sorted(os.listdir(seen))
    assert len(runs) == 2 * workers
    resumed = [open(os.path.join(seen, n)).read() for n in runs]
    assert sorted(p.endswith("checkpoint_000002") for p in resumed) == \
        [False] * workers + [True] * workers
    assert os.getpid() not in {int(n.split("-")[1]) for n in runs}


def test_generated_plans_match_jax():
    for seed in (0, 7, 23):
        assert faults.FaultPlan.generate(seed).to_json() == \
            jfaults.FaultPlan.generate(seed).to_json()
    plan = faults.FaultPlan.generate(5, sites=["train.report"])
    assert [(s.site, s.action) for s in plan.specs] == [("train.report", "kill")]


# -- metric sinks ----------------------------------------------------------------------------


REPORTS = [{"epoch": 1, "loss": 2.5, "eval_loss": 2.75, "name": "skip", "_timestamp": 1.0},
           {"epoch": 2, "loss": 1.25, "eval_loss": 1.5, "steps": 3}]


def test_tensorboard_sink_writes_the_jax_sinks_scalars(tmp_path):
    pytest.importorskip("tensorboardX")
    from tpu_air.utils.metrics import TensorboardSink as JSink
    from tpu_air_torch.utils.metrics import TensorboardSink

    logs = {}
    for key, cls in (("port", TensorboardSink), ("jax", JSink)):
        sink = cls(str(tmp_path / key))
        for step, rec in enumerate(REPORTS, 1):
            sink.log(rec, step)
        sink.close()
        logs[key] = event_scalars(str(tmp_path / key))
    assert logs["port"] == logs["jax"]
    assert logs["port"] == [(1, "epoch", 1.0), (1, "loss", 2.5), (1, "eval_loss", 2.75),
                            (2, "epoch", 2.0), (2, "loss", 1.25), (2, "eval_loss", 1.5),
                            (2, "steps", 3.0)]


def test_tensorboard_sink_without_tensorboardx_raises_at_construction(tmp_path, monkeypatch):
    import importlib.util

    from tpu_air_torch.train.session import _default_sinks
    from tpu_air_torch.utils.metrics import TensorboardSink

    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == "tensorboardX" else real(name, *a))
    with pytest.raises(ImportError, match="tensorboardX is not installed"):
        TensorboardSink(str(tmp_path))
    monkeypatch.setenv("TPU_AIR_TENSORBOARD", "1")
    assert _default_sinks(str(tmp_path)) == []


def test_prometheus_sink_sets_the_jax_sinks_gauges():
    prometheus_client = pytest.importorskip("prometheus_client")
    from tpu_air.utils.metrics import PrometheusSink as JSink
    from tpu_air_torch.utils.metrics import PrometheusSink

    sinks = {"port": PrometheusSink(namespace="surface_port"),
             "jax": JSink(namespace="surface_jax")}
    for sink in sinks.values():
        for step, rec in enumerate(REPORTS + [{"eval/loss-1": 0.5}], 1):
            sink.log(rec, step)
    reg = prometheus_client.REGISTRY
    for name in ("epoch", "loss", "eval_loss", "steps", "eval_loss_1"):
        got = reg.get_sample_value(f"surface_port_{name}")
        assert got is not None and got == reg.get_sample_value(f"surface_jax_{name}"), name
    assert reg.get_sample_value("surface_port_loss") == 1.25
    assert reg.get_sample_value("surface_port_name") is None      # not a number
    assert sorted(sinks["port"].gauges) == sorted(sinks["jax"].gauges)


def test_session_logs_to_its_sinks_on_rank_zero(tmp_path):
    from tpu_air_torch.train.session import Session

    class Sink:
        def __init__(self):
            self.logged = []

        def log(self, metrics, step):
            self.logged.append((step, metrics["loss"]))

    class Broken:
        def log(self, metrics, step):
            raise RuntimeError("a broken sink does not stop training")

    sinks = {rank: Sink() for rank in (0, 1)}
    for rank, sink in sinks.items():
        s = Session(str(tmp_path / str(rank)), world_size=2, world_rank=rank,
                    sinks=[Broken(), sink])
        for rec in REPORTS:
            s.report(rec)
    assert sinks[0].logged == [(1, 2.5), (2, 1.25)] and sinks[1].logged == []


def test_tensorboard_opt_in_logs_a_fits_reports(tair, tmp_path, monkeypatch):
    """``TPU_AIR_TENSORBOARD=1`` in the driver reaches the trial actor: its
    rank 0 writes the reports' scalars into the run directory, rank 1
    nothing; without the variable no event file is written."""
    pytest.importorskip("tensorboardX")

    def loop(config):
        from tpu_air_torch.train import session

        for i in range(3):
            session.report({"i": i, "loss": 1.0 / (i + 1)})

    paths = {}
    for flag in ("1", "0"):
        monkeypatch.setenv("TPU_AIR_TENSORBOARD", flag)
        r = TorchTrainer(loop, scaling_config=ScalingConfig(num_workers=2), device="cpu",
                         run_config=RunConfig(storage_path=str(tmp_path / flag))).fit()
        assert r.error is None, r.error
        paths[flag] = r
    files = [n for n in os.listdir(paths["1"].path) if n.startswith("events.out.tfevents.")]
    assert len(files) == 1                                          # rank 0's file alone
    want = [(step, k, float(np.float32(m[k])))          # an event holds an f32
            for step, m in enumerate(paths["1"].metrics_history, 1)
            for k in ("i", "loss", "training_iteration")]
    assert sorted(event_scalars(paths["1"].path)) == sorted(want)
    assert event_scalars(paths["0"].path) == []


# -- small API pieces --------------------------------------------------------------------------


def test_deserialize_ex_matches_jax():
    from tpu_air.core.serialization import deserialize_ex as jdeserialize_ex
    from tpu_air.core.serialization import serialize as jserialize
    from tpu_air_torch.core.serialization import deserialize_ex, serialize

    for value in ({"a": 1, "b": [1, 2]}, np.arange(12.0).reshape(3, 4),
                  {"x": np.ones(5, np.int32), "y": "text"}):
        for ser in (serialize, jserialize):
            buf = b"".join(bytes(c) for c in ser(value))
            for zero_copy in (True, False):
                got, n = deserialize_ex(buf, zero_copy=zero_copy)
                want, wn = jdeserialize_ex(buf, zero_copy=zero_copy)
                # out-of-band buffers: one an array, none for plain values
                assert n == wn == len([v for v in (value if isinstance(value, dict)
                                                   else {"": value}).values()
                                       if isinstance(v, np.ndarray)])
                assert repr(got) == repr(want)


def test_current_plan_is_the_installed_plan(plans):
    assert faults.current_plan() is None
    plan = faults.FaultPlan(seed=4, specs=[faults.FaultSpec("train.report", "kill", at=2)])
    faults.install(plan)
    assert faults.current_plan() is plan
    faults.clear()
    assert faults.current_plan() is None


def test_load_t5_from_hf_is_load_t5_of_a_local_directory():
    from tpu_air_torch.models.t5 import load_t5, load_t5_from_hf

    got = load_t5_from_hf(ASSET, device="cpu")
    want = load_t5(ASSET, device="cpu")
    assert got.config.to_dict() == want.config.to_dict()
    sd, wsd = got.state_dict(), want.state_dict()
    assert sorted(sd) == sorted(wsd)
    assert all(torch.equal(sd[k], wsd[k]) for k in sd)
    with pytest.raises(FileNotFoundError, match="downloads nothing"):
        load_t5_from_hf("google/flan-t5-base", device="cpu")


# -- the package exports ---------------------------------------------------------------------

# JAX names whose port counterpart has another name, and names with no
# counterpart by design (README.md, the port's section)
RENAMED = {"JaxTrainer": "TorchTrainer", "JaxPredictor": "TorchPredictor"}
NO_COUNTERPART = {"make_generate_fn", "ring_attention_sharded"}
PACKAGES = ("data", "faults", "parallel", "train", "predict", "models", "models.t5", "ops")


@pytest.mark.parametrize("pkg", PACKAGES)
def test_every_jax_export_has_its_port_name(pkg):
    jmod = importlib.import_module(f"tpu_air.{pkg}")
    tmod = importlib.import_module(f"tpu_air_torch.{pkg}")
    missing = [n for n in jmod.__all__
               if n not in NO_COUNTERPART and not hasattr(tmod, RENAMED.get(n, n))]
    assert missing == []
    exported = set(tmod.__all__)
    assert {RENAMED.get(n, n) for n in jmod.__all__} - NO_COUNTERPART <= exported
    for n in exported:
        assert getattr(tmod, n) is not None


def test_no_counterpart_names_are_in_the_readme():
    with open(os.path.join(ROOT, "README.md")) as f:
        text = f.read()
    for name in (*NO_COUNTERPART, "shard_map_unchecked", "lm_param_shardings",
                 "t5_param_shardings", "init_sp_params", "auto_dispatch_ok"):
        assert f"`{name}`" in text, name


def test_exports_that_are_modules_call_their_functions():
    """``ops.flash_attention``, ``ops.ring_attention`` and
    ``models.t5.generate`` are the port's modules of those names (what its
    code and tests import), callable as the JAX package's functions."""
    from tpu_air_torch import ops
    from tpu_air_torch.models import t5
    from tpu_air_torch.models.t5.config import T5Config
    from tpu_air_torch.models.t5.modeling import T5ForConditionalGeneration
    from tpu_air_torch.ops import flash_attention

    assert hasattr(flash_attention, "flash_attention_reference")
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 3, 8, 4, generator=g) for _ in range(3))
    torch.testing.assert_close(ops.flash_attention(q, k, v, causal=True),
                               flash_attention.flash_attention(q, k, v, causal=True))
    model = T5ForConditionalGeneration(T5Config.tiny(), device="cpu").init_weights(0)
    ids = np.random.default_rng(1).integers(2, 100, (2, 6))
    assert torch.equal(t5.generate(model, ids, max_new_tokens=3),
                       t5.generate.generate(model, ids, max_new_tokens=3))
    assert callable(ops.ring_attention) and callable(ops.ring_attention.ring_attention)


def test_importing_the_exports_builds_nothing_and_imports_no_jax():
    """A fresh interpreter that takes every exported name of the port's
    packages imports no JAX and builds no kernel."""
    code = (
        "import importlib, sys\n"
        f"for p in {PACKAGES!r}:\n"
        "    m = importlib.import_module('tpu_air_torch.' + p)\n"
        "    [getattr(m, n) for n in m.__all__]\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'tpu_air'))\n"
        "print(repr(bad))\n"
    )
    build_dir = os.path.join(ROOT, "tpu_air_torch", "_build")
    before = sorted(os.listdir(build_dir)) if os.path.isdir(build_dir) else None
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout
    assert (sorted(os.listdir(build_dir)) if os.path.isdir(build_dir) else None) == before
