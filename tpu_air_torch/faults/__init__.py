"""tpu_air_torch.faults — fault injection at the hooks of the port's core."""
