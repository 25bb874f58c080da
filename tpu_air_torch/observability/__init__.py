"""tpu_air_torch.observability — span tracing for the port's runtime."""
