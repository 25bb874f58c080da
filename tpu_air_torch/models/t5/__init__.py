"""PyTorch T5 / FLAN-T5 model family (counterpart of tpu_air.models.t5)."""
