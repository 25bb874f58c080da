"""W2 on the PyTorch/CUDA port: the twin of ``examples/tune_hpo_t5.py`` on
``tpu_air_torch`` — an HPO sweep over the T5 fine-tune, 4 trials, ASHA early
stopping.

The reference's Tuner flow (Model_finetuning_and_batch_inference.ipynb:
cc-51-59): choice grids over learning_rate / epochs / weight_decay,
ASHAScheduler(max_t), metric eval_loss/min, one worker a trial "so that
hyperparameter tuning can run in parallel": each trial trains in an actor
that leases one card.  ``--device cpu`` runs the sweep without a card (one
lease slot: the trials run in turn); by default everything runs on CUDA and
raises where there is none.
"""

from __future__ import annotations

import argparse
import sys

import pandas as pd

SEQ = 32


def make_dataset():
    import tpu_air_torch.data as tad

    rows = [{"instruction": f"repeat w{i % 5}", "output": f"w{i % 5}"} for i in range(48)]
    return tad.from_items(rows).train_test_split(0.25)


def full_preprocessor():
    from tpu_air_torch.data import BatchMapper

    def fn(df: pd.DataFrame) -> pd.DataFrame:
        from tpu_air_torch.models.tokenizer import ByteTokenizer

        t = ByteTokenizer(model_max_length=SEQ)
        enc = t(list(df["instruction"]), max_length=SEQ, padding="max_length",
                truncation=True, return_tensors="np")
        lab = t(list(df["output"]), max_length=SEQ, padding="max_length",
                truncation=True, return_tensors="np")
        return pd.DataFrame({"input_ids": list(enc["input_ids"]),
                             "attention_mask": list(enc["attention_mask"]),
                             "labels": list(lab["input_ids"])})

    return BatchMapper(fn, batch_format="pandas", batch_size=4096)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trials", type=int, default=4)  # cc-52: 4 trials
    ap.add_argument("--device", default=None,
                    help="'cpu' to run without a card; default: lease the CUDA devices")
    args = ap.parse_args(argv)

    import tpu_air_torch
    from tpu_air_torch import tune
    from tpu_air_torch.models.t5.config import T5Config
    from tpu_air_torch.models.tokenizer import ByteTokenizer
    from tpu_air_torch.train import (
        CheckpointConfig,
        RunConfig,
        ScalingConfig,
        T5Trainer,
        TrainingArguments,
    )

    tpu_air_torch.init(num_chips=1 if args.device == "cpu" else None)
    train_ds, eval_ds = make_dataset()
    trainer = T5Trainer(
        model_config=T5Config.tiny(vocab_size=384),
        training_args=TrainingArguments(learning_rate=2e-5, per_device_train_batch_size=2,
                                        num_train_epochs=4, weight_decay=0.01),
        tokenizer=ByteTokenizer(model_max_length=SEQ),
        # one worker a trial, so that the trials run side by side (cc-53-54)
        scaling_config=ScalingConfig(num_workers=1),
        datasets={"train": train_ds, "evaluation": eval_ds},
        run_config=RunConfig(checkpoint_config=CheckpointConfig(
            num_to_keep=1, checkpoint_score_attribute="eval_loss",
            checkpoint_score_order="min")),
        preprocessor=full_preprocessor(),
        device=args.device,
    )
    # the reference's choice grids (cc-57) at smoke-friendly values
    grid = tune.Tuner(
        trainer,
        param_space={"trainer_init_config": {
            "learning_rate": tune.choice([3e-3, 1e-3, 3e-4, 1e-4]),
            "num_train_epochs": tune.choice([2, 4]),
            "weight_decay": tune.choice([0.0, 0.01, 0.1]),
        }},
        tune_config=tune.TuneConfig(
            metric="eval_loss", mode="min", num_samples=args.trials, seed=57,
            scheduler=tune.ASHAScheduler(max_t=4, grace_period=1),
        ),
    ).fit()

    print(f"trials: {len(grid)}  errors: {grid.num_errors}")
    best = grid.get_best_result()
    print(f"best eval_loss: {best.metrics['eval_loss']:.4f}")
    print(f"best config: lr={best.config['learning_rate']}, "
          f"epochs={best.config['num_train_epochs']}, wd={best.config['weight_decay']}")
    if best.checkpoint is None:
        raise RuntimeError("the best trial kept no checkpoint")
    tpu_air_torch.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
