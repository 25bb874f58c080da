"""W6+W7 on the PyTorch/CUDA port: the twin of
``examples/segformer_finetune.py`` on ``tpu_air_torch``.

The reference's Scaling_model_training.ipynb (cc-24,33,42,51-52) and
Scaling_batch_inference.ipynb (cc-73-78) distilled onto the port: (image,
annotation) rows → SegformerImageProcessor BatchMapper (do_reduce_labels) →
data-parallel fine-tune (worker processes, cross-replica batch norm) →
best-checkpoint batch inference with SemanticSegmentationPredictor in
scoring actors that each lease a card.

Offline: synthesizes ADE20K-like rows (smoke dials).  The reference's W6 is
two workers on the CPU (``--device cpu``, gloo); on one card pass
``--num-workers 1`` (N workers on CUDA need N cards).  By default
everything runs on CUDA and raises where there is none.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import pandas as pd

SEED = 201  # the reference's torch.manual_seed(201)


def make_ade_like(n: int, h: int = 40, w: int = 48):
    import tpu_air_torch.data as tad

    rng = np.random.default_rng(SEED)
    rows = [
        {
            "image": rng.integers(0, 256, size=(h, w, 3)).astype(np.uint8),
            "annotation": rng.integers(0, 9, size=(h, w)).astype(np.uint8),
        }
        for _ in range(n)
    ]
    return tad.from_items(rows)


def images_preprocessor(size: int):
    """The reference's images_preprocessor BatchMapper
    (Scaling_model_training.ipynb:cc-38,42), constructed where it runs."""
    from tpu_air_torch.data import BatchMapper

    def fn(df: pd.DataFrame) -> pd.DataFrame:
        from tpu_air_torch.models.segformer import SegformerImageProcessor

        proc = SegformerImageProcessor(size=size, do_reduce_labels=True)
        out = proc(list(df["image"]), segmentation_maps=list(df["annotation"]))
        return pd.DataFrame({"pixel_values": list(out["pixel_values"]),
                             "labels": list(out["labels"])})

    return BatchMapper(fn, batch_format="pandas", batch_size=64)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--images", type=int, default=16)
    ap.add_argument("--size", type=int, default=32)
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--num-workers", type=int, default=2)
    ap.add_argument("--device", default=None,
                    help="'cpu' to run without a card; default: the CUDA devices")
    args = ap.parse_args(argv)

    import tpu_air_torch
    from tpu_air_torch.models.segformer import SegformerConfig, SegformerImageProcessor
    from tpu_air_torch.predict import BatchPredictor, SemanticSegmentationPredictor
    from tpu_air_torch.train import (
        CheckpointConfig,
        RunConfig,
        ScalingConfig,
        SegformerTrainer,
        TrainingArguments,
    )

    cpu = args.device == "cpu"
    # leases are CUDA devices; on the CPU, one slot per scoring worker
    tpu_air_torch.init(num_chips=2 if cpu else None)
    ds = make_ade_like(args.images)
    train_ds, eval_ds = ds.train_test_split(0.25)
    print(f"train images: {train_ds.count()}  eval: {eval_ds.count()}")

    trainer = SegformerTrainer(
        model_config=SegformerConfig.tiny(),
        training_args=TrainingArguments(
            learning_rate=1e-3,          # cc-47: explicit AdamW
            per_device_train_batch_size=1,
            num_train_epochs=args.epochs,
            weight_decay=0.0,
        ),
        feature_extractor=SegformerImageProcessor(size=args.size),
        scaling_config=ScalingConfig(num_workers=args.num_workers, use_gpu=not cpu),
        # worker processes read their rows from pandas, not the object store
        datasets={"train": train_ds.to_pandas(), "evaluation": eval_ds.to_pandas()},
        run_config=RunConfig(
            checkpoint_config=CheckpointConfig(
                num_to_keep=1,
                checkpoint_score_attribute="loss",  # cc-51: keep-1 by min loss
                checkpoint_score_order="min",
            )
        ),
        preprocessor=images_preprocessor(args.size),
        device=args.device,
    )
    result = trainer.fit()
    if result.error is not None:
        print(f"training failed: {result.error}")
        return 1
    print(f"metrics: { {k: v for k, v in result.metrics.items() if k in ('loss', 'epoch')} }")

    # -- W7 batch inference from the checkpoint ------------------------------
    bp = BatchPredictor.from_checkpoint(
        result.checkpoint,
        SemanticSegmentationPredictor,
        feature_extractor=SegformerImageProcessor(size=args.size),
        device=args.device,
    )
    preds = bp.predict(
        eval_ds.drop_columns(["annotation"]),
        batch_size=4,
        min_scoring_workers=1,
        max_scoring_workers=2,
        num_chips_per_worker=1,
    )
    df = preds.to_pandas()
    maps = df["predicted_mask"]
    print(f"predicted {len(maps)} segmentation maps; "
          f"first map shape {np.asarray(maps.iloc[0]).shape}, "
          f"classes {sorted(np.unique(np.asarray(maps.iloc[0])))[:5]}…")
    tpu_air_torch.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
