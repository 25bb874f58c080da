"""tpu_air_torch.predict — offline inference (counterpart of tpu_air.predict)."""
