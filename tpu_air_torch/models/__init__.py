"""tpu_air_torch.models — PyTorch model families."""
