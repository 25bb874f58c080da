"""FLAN-T5 fine-tune and batch generation on the PyTorch/CUDA port: the twin
of ``examples/flan_t5_batch_inference.py`` on ``tpu_air_torch``.

W1 then W3: rows -> tokenizing ``BatchMapper`` preprocessor ->
``T5Trainer.fit()`` -> best checkpoint -> ``BatchPredictor`` over the eval
split in scoring actors that each lease a card -> the generated outputs
joined back onto the inputs.

Dials:
  --smoke        the vendored tiny FLAN-T5 (tests/assets/flan_t5_tiny: its
                 weights and SentencePiece vocab) and synthetic rows
  default        a local FLAN-T5 directory (--model-dir, HF layout) and
                 Alpaca from the local ``datasets`` cache; nothing is fetched
  --device cpu   the only way to run without a card (the kernels' plain
                 versions); by default everything runs on CUDA and raises
                 where there is none

Run directly, or as a managed job:
  python -m tpu_air_torch.job submit examples/torch_flan_t5_job.yml --wait
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import pandas as pd

SEED = 42
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE_MODEL = os.path.join(ROOT, "tests", "assets", "flan_t5_tiny")


def load_rows(smoke: bool, limit: int) -> pd.DataFrame:
    """Instruction rows: synthetic for --smoke, else Alpaca from the local
    ``datasets`` cache (a missing cache raises)."""
    if not smoke:
        from datasets import load_dataset

        df = load_dataset("tatsu-lab/alpaca", split="train").to_pandas()
        return df.head(limit) if limit else df
    rng = np.random.default_rng(SEED)
    verbs = ["list", "name", "describe", "repeat", "count"]
    things = ["planets", "colors", "rivers", "tools", "birds"]
    return pd.DataFrame([
        {"instruction": f"{verbs[rng.integers(5)]} three {things[rng.integers(5)]}",
         "input": "", "output": f"{things[rng.integers(5)]} a, b, c"}
        for _ in range(limit or 96)])


def make_preprocessor(model_dir: str, seq: int):
    """Tokenizing BatchMapper: the tokenizer is built inside the function, so
    it runs wherever the preprocessor does (the trainer's process, each
    scoring actor), and the preprocessor is saved in the checkpoint."""
    from tpu_air_torch.data import BatchMapper

    def preprocess_function(df: pd.DataFrame) -> pd.DataFrame:
        from tpu_air_torch.models.sentencepiece_unigram import T5SentencePieceTokenizer

        tok = T5SentencePieceTokenizer.from_pretrained(model_dir)
        prompts = [f"{inst} {inp}".strip()
                   for inst, inp in zip(df["instruction"], df.get("input", [""] * len(df)))]
        enc = tok(prompts, max_length=seq, padding="max_length", truncation=True,
                  return_tensors="np")
        out = {"input_ids": list(enc["input_ids"]),
               "attention_mask": list(enc["attention_mask"])}
        if "output" in df.columns:
            lab = tok(list(df["output"]), max_length=seq, padding="max_length",
                      truncation=True, return_tensors="np")
            out["labels"] = list(lab["input_ids"])
        return pd.DataFrame(out)

    return BatchMapper(preprocess_function, batch_format="pandas", batch_size=4096)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="the vendored tiny FLAN-T5 and synthetic rows")
    ap.add_argument("--model-dir", default=None,
                    help="a local FLAN-T5 directory (config.json, model.safetensors, "
                         "spiece.model); --smoke uses tests/assets/flan_t5_tiny")
    ap.add_argument("--device", default=None,
                    help="'cpu' to run without a card; default: the CUDA devices")
    ap.add_argument("--limit", type=int, default=None, help="row cap")
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--max-new-tokens", type=int, default=None)
    ap.add_argument("--num-scoring-workers", type=int, default=1)
    args = ap.parse_args(argv)

    import tpu_air_torch
    from tpu_air_torch import data as tad
    from tpu_air_torch.models.sentencepiece_unigram import T5SentencePieceTokenizer
    from tpu_air_torch.models.t5.hf_import import load_t5
    from tpu_air_torch.predict import BatchPredictor, T5GenerativePredictor
    from tpu_air_torch.train import (CheckpointConfig, RunConfig, T5Trainer,
                                     TrainingArguments)

    smoke = args.smoke
    model_dir = SMOKE_MODEL if smoke else args.model_dir
    if model_dir is None:
        ap.error("--model-dir is required without --smoke")
    seq = 32 if smoke else 512
    limit = args.limit if args.limit is not None else (96 if smoke else 100)
    epochs = args.epochs or (1 if smoke else 4)
    max_new = args.max_new_tokens or (4 if smoke else 128)
    cpu = args.device == "cpu"

    # leases are CUDA devices; on the CPU, one slot per scoring worker
    tpu_air_torch.init(num_chips=args.num_scoring_workers if cpu else None)

    rows = tad.from_pandas(load_rows(smoke, limit))
    train_ds, eval_ds = rows.train_test_split(0.2, shuffle=True, seed=57)
    print(f"train rows: {train_ds.count()}  eval rows: {eval_ds.count()}")

    pretrained = load_t5(model_dir, dtype="float32", device="cpu")
    trainer = T5Trainer(
        model_config=pretrained.config,
        pretrained_params=pretrained.state_dict(),
        training_args=TrainingArguments(learning_rate=3e-3 if smoke else 2e-5,
                                        per_device_train_batch_size=2 if smoke else 8,
                                        num_train_epochs=epochs, weight_decay=0.01,
                                        seed=SEED),
        tokenizer=T5SentencePieceTokenizer.from_pretrained(model_dir),
        datasets={"train": train_ds.to_pandas(), "evaluation": eval_ds.to_pandas()},
        run_config=RunConfig(checkpoint_config=CheckpointConfig(
            num_to_keep=1, checkpoint_score_attribute="eval_loss",
            checkpoint_score_order="min")),
        preprocessor=make_preprocessor(model_dir, seq),
        device=args.device,
    )
    result = trainer.fit()
    if result.error is not None:
        print(f"training failed: {result.error}")
        return 1
    print(f"metrics: {result.metrics}")

    # W3: the reference's half-precision load, float16, on the leased cards
    bp = BatchPredictor.from_checkpoint(
        result.checkpoint, T5GenerativePredictor,
        dtype="float32" if cpu else "float16", device=args.device)
    preds = bp.predict(eval_ds, feature_columns=["input_ids", "attention_mask"],
                       batch_size=8 if smoke else 256,
                       min_scoring_workers=1, max_scoring_workers=args.num_scoring_workers,
                       num_gpus_per_worker=1, max_new_tokens=max_new)

    inputs, outputs = eval_ds.to_pandas(), preds.to_pandas()
    joined = pd.concat([inputs.reset_index(drop=True), outputs.reset_index(drop=True)],
                       axis=1)
    pd.set_option("display.max_colwidth", 60)
    print(joined[["instruction", "generated_output"]].head(10).to_string())
    print(f"generated {len(outputs)} outputs")
    tpu_air_torch.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
