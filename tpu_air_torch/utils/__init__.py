"""tpu_air_torch.utils — helpers shared across the port's packages."""
