"""W8 on the PyTorch/CUDA port: the twin of ``examples/xgboost_e2e.py`` on
``tpu_air_torch`` — train → tune → batch predict → HTTP serve.

The reference's Introduction_to_Ray_AI_Runtime.ipynb arc (cc-9,21,32,45,60,
71,74): NYC-taxi-shaped rows → MinMaxScaler preprocessor → GBDTTrainer →
Tuner (3 samples, eta/max_depth) → BatchPredictor(GBDTPredictor) →
serve.run(PredictorDeployment...bind(..., http_adapter=pandas_read_json))
and a JSON POST against it.

The GBDT runs on the host and the serve replicas lease no card; the
runtime still takes its lease count from the CUDA devices (each Tune trial
leases one) and raises where there are none, unless ``--device cpu`` asks
for the CPU.  Offline: the rows are made from a seed (the real dataset is
an S3 parquet); ``--parquet PATH`` reads a parquet file or directory of
your own instead, through ``tpu_air_torch.data.read_parquet`` (cc-9).
"""

from __future__ import annotations

import argparse
import json
import sys
import urllib.request

import numpy as np

SEED = 201  # the reference notebook's seed (Overview_of_Ray.ipynb:cc-13)
FEATURES = ["trip_distance", "pickup_hour", "passenger_count", "fare_amount"]


def make_taxi_like(n: int, seed: int = SEED):
    """Synthetic big-tip classification rows shaped like the notebook's
    engineered features (Introduction…ipynb:cc-9-21), as a port Dataset."""
    import tpu_air_torch.data as tad

    rng = np.random.default_rng(seed)
    dist = rng.gamma(2.0, 2.0, n)
    hour = rng.integers(0, 24, n)
    passengers = rng.integers(1, 5, n)
    fare = 3.0 + 2.5 * dist + rng.normal(0, 1, n)
    p = 1 / (1 + np.exp(-(0.25 * dist - 0.05 * np.abs(12 - hour))))
    label = (rng.uniform(size=n) < p).astype(int)
    return tad.from_items([
        {"trip_distance": float(d), "pickup_hour": int(h), "passenger_count": int(c),
         "fare_amount": float(f), "is_big_tip": int(t)}
        for d, h, c, f, t in zip(dist, hour, passengers, fare, label)
    ])


def train_and_tune(ds, num_boost_round: int = 20, num_samples: int = 3):
    """GBDTTrainer over a MinMaxScaler (cc-21,32), then the cc-45 sweep;
    returns (the trainer's result, the best result of the sweep, the
    validation split)."""
    from tpu_air_torch import tune
    from tpu_air_torch.data import MinMaxScaler
    from tpu_air_torch.train import GBDTTrainer

    train_ds, valid_ds = ds.train_test_split(0.3, shuffle=True, seed=SEED)
    trainer = GBDTTrainer(
        label_column="is_big_tip",
        params={"objective": "binary:logistic", "max_depth": 4, "eta": 0.2},
        num_boost_round=num_boost_round,
        datasets={"train": train_ds, "valid": valid_ds},
        preprocessor=MinMaxScaler(columns=FEATURES),
    )
    result = trainer.fit()
    grid = tune.Tuner(
        trainer,
        param_space={"params": {"eta": tune.uniform(0.05, 0.4),
                                "max_depth": tune.randint(2, 6)}},
        tune_config=tune.TuneConfig(metric="valid-logloss", mode="min",
                                    num_samples=num_samples, seed=7),
    ).fit()
    return result, grid.get_best_result(), valid_ds


def serve_best(checkpoint, port: int, num_replicas: int = 2):
    """The cc-71 deployment: two replicas of PredictorDeployment over the
    best checkpoint, JSON rows in through ``pandas_read_json``."""
    from tpu_air_torch import serve
    from tpu_air_torch.predict import GBDTPredictor
    from tpu_air_torch.serve import PredictorDeployment, pandas_read_json

    return serve.run(
        PredictorDeployment.options(
            name="XGBoostService", num_replicas=num_replicas, route_prefix="/rayair"
        ).bind(GBDTPredictor, checkpoint, http_adapter=pandas_read_json),
        port=port,
    )


def post_rows(port: int, rows, timeout: float = 30.0):
    """The cc-74 client: POST a JSON list of feature rows, get predictions."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/rayair", data=json.dumps(rows).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=2000)
    ap.add_argument("--parquet", default=None, help="read your own dataset")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--device", default=None,
                    help="'cpu' to run without a card; default: lease the CUDA devices")
    args = ap.parse_args(argv)

    import tpu_air_torch
    import tpu_air_torch.data as tad
    from tpu_air_torch import serve
    from tpu_air_torch.predict import BatchPredictor, GBDTPredictor

    # Tune's trials each lease one slot, as on the card; on the CPU one
    # slot stands in for it (the trials run in turn)
    tpu_air_torch.init(num_chips=1 if args.device == "cpu" else None)
    try:
        ds = tad.read_parquet(args.parquet) if args.parquet else make_taxi_like(args.rows)
        result, best, valid_ds = train_and_tune(ds)
        print(f"train metrics: { {k: round(v, 4) for k, v in result.metrics.items() if isinstance(v, float)} }")
        print(f"best config: {best.config['params']}  "
              f"valid-logloss={best.metrics['valid-logloss']:.4f}")

        # -- batch predict from the best checkpoint (cc-60) ------------------
        bp = BatchPredictor.from_checkpoint(best.checkpoint, GBDTPredictor)
        df = bp.predict(valid_ds.drop_columns(["is_big_tip"]), batch_size=512).to_pandas()
        print(f"batch predictions: {len(df)} rows, mean p={df['predictions'].mean():.3f}")

        # -- online serving (cc-71,74) ---------------------------------------
        serve_best(best.checkpoint, args.port)
        sample = [{"trip_distance": 4.2, "pickup_hour": 18,
                   "passenger_count": 1, "fare_amount": 14.5}]
        print(f"HTTP prediction: {post_rows(args.port, sample)}")
    finally:
        serve.shutdown()
        tpu_air_torch.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
